"""Gradient compression for the data-parallel all-reduce (port of
``repro.optim.compression``).

Two schemes, both usable on each rank's local gradients over one axis of
a process mesh (``launch.mesh.ProcessMesh``):

  * int8 symmetric quantization with stochastic rounding: the all-reduce
    moves int8-range values instead of float32 (plus one scalar scale a
    tensor, agreed by a max across the ranks),
  * top-k sparsification with error feedback (the residual carries to the
    next step, preserving convergence).

The stochastic rounding's uniform draws come from a ``torch.Generator``,
or are handed over as a tensor (``draws``) -- the handover the hash
families' coefficients use, since ``jax.random`` cannot be reproduced in
torch: with the reference's draws the result is the reference's, bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _uniform(shape, generator: Optional[torch.Generator],
             draws: Optional[torch.Tensor], device) -> torch.Tensor:
    if draws is not None:
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"draws {tuple(draws.shape)}, want {tuple(shape)}")
        return draws.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def quantize_int8(g: torch.Tensor, generator: Optional[torch.Generator] = None,
                  scale: Optional[torch.Tensor] = None, *,
                  draws: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with stochastic rounding.

    Returns (q int8, scale float32) with g ~= q * scale / 127.  The
    rounding draws are U[0, 1) of ``g``'s shape, from ``generator`` or
    given as ``draws``.
    """
    g32 = g.to(torch.float32)
    if scale is None:
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12)
    x = g32 / scale * 127.0
    lo = torch.floor(x)
    frac = x - lo
    rnd = (_uniform(g.shape, generator, draws, g.device) < frac).to(
        torch.float32)
    q = torch.clamp(lo + rnd, -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale / 127.0


def compressed_psum_int8(g: torch.Tensor, mesh, axis: str,
                         generator: Optional[torch.Generator] = None, *,
                         draws: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The mean of each rank's ``g`` over one mesh axis, with an int8
    wire format: agree on a shared scale (max), quantize locally,
    all-reduce the int32 sums, dequantize once."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12).reshape(1)
    group = mesh.group(axis)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale.reshape(())
    q, _ = quantize_int8(g32, generator, scale, draws=draws)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = torch.tensor(float(mesh.extent(axis)), dtype=torch.float32,
                     device=g.device)
    return total.to(torch.float32) * scale / 127.0 / n


def make_compressed_allreduce(mesh, axis_name: str = "dp"):
    """``f(g, generator=None, *, draws=None) -> mean(g)`` over
    ``axis_name`` of ``mesh``, on each rank's local ``g`` (the
    reference's ``shard_map``-wrapped function, whose body this is)."""

    def f(g, generator=None, *, draws=None):
        return compressed_psum_int8(g, mesh, axis_name, generator,
                                    draws=draws)

    return f


def topk_compress(g: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude entries (ties to the lower index, as
    ``lax.top_k`` breaks them).  Returns (values, flat indices)."""
    flat = g.reshape(-1).to(torch.float32)
    idx = torch.sort(torch.abs(flat), descending=True, stable=True
                     ).indices[:k]
    return flat[idx], idx


def topk_decompress(values: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    return torch.zeros(size, dtype=torch.float32,
                       device=values.device).index_copy_(
        0, idx, values).reshape(shape)


def topk_error_feedback(g: torch.Tensor, residual: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Error-feedback top-k: compress (g + residual), carry the rest.

    Returns (values, idx, new_residual, transmitted_dense) -- the dense
    form is what a psum would reduce; callers all-reduce (values, idx)
    pairs by all-gather in practice.
    """
    corrected = g.to(torch.float32) + residual
    vals, idx = topk_compress(corrected, k)
    transmitted = topk_decompress(vals, idx, g.shape)
    new_residual = corrected - transmitted
    return vals, idx, new_residual, transmitted
