"""Shared building blocks (port of ``repro.models.layers``): ``normal_init``,
``mlp`` / ``init_mlp``, ``rms_norm``, ``layer_norm``, ``swiglu`` and
``apply_rope``, ``attach_params``, which holds a parameter dict in an
``nn.Module``, and ``TreeModel``, a model holding the reference's
parameter tree that way.

Initialisation draws from an explicit ``torch.Generator`` on the device
the tensors are made on, so a seed gives the same weights in every
process; the values differ from ``jax.random``'s (the tests carry weights
over instead).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.tree import map_with_path

# elements of float32 drawn at once for a leaf stored in another type: a
# 7.5 GB bfloat16 leaf is drawn through 1 GiB of float32, not 15 GB
DRAW_CHUNK = 1 << 28


def normal_init(generator: torch.Generator, shape, scale: float = 0.02,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, 1) * ``scale`` on the generator's device, drawn in float32 and
    cast to ``dtype`` (one rounding, as the reference's
    ``(normal * scale).astype(dtype)``).  Filled in place, so a large
    table is never held twice; a leaf of another type and more than
    ``DRAW_CHUNK`` elements is drawn ``DRAW_CHUNK`` at a time."""
    dev = generator.device
    if dtype == torch.float32:
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.normal_(0.0, 1.0, generator=generator).mul_(scale)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        part = flat[start:start + DRAW_CHUNK]
        part.copy_(torch.empty(part.numel(), dtype=torch.float32, device=dev)
                   .normal_(0.0, 1.0, generator=generator).mul_(scale))
    return out


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor],
        act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` between layers (and after the last
    with ``final_act``)."""
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w + b
        if i < len(weights) - 1 or final_act:
            x = act(x)
    return x


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32) -> Dict[str, List[torch.Tensor]]:
    """``{"w": [...], "b": [...]}``: weights N(0, 1/fan_in), zero biases."""
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        ws.append(normal_init(generator, (fan_in, fan_out),
                              scale=fan_in ** -0.5, dtype=dtype))
        bs.append(torch.zeros((fan_out,), dtype=dtype,
                              device=generator.device))
    return {"w": ws, "b": bs}


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast back to ``x``'s type, then scaled by
    ``weight`` in that type."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the last dim, half-split (not interleaved).
    x: (..., S, H, hd); positions: (S,) or broadcastable to x's sequence
    axis (-3).  Angles in float32; the result in ``x``'s type."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def attach_params(module: nn.Module, tree: Dict) -> None:
    """Register a parameter dict under ``module``: tensors as frozen
    parameters, lists of tensors as ``ParameterList``s, lists of dicts as
    ``ModuleList``s, dicts as submodules."""
    for key, value in tree.items():
        if isinstance(value, torch.Tensor):
            module.register_parameter(key, _frozen(value))
        elif isinstance(value, dict):
            sub = nn.Module()
            attach_params(sub, value)
            module.add_module(key, sub)
        elif all(isinstance(v, torch.Tensor) for v in value):
            module.add_module(key, nn.ParameterList(map(_frozen, value)))
        else:
            subs = []
            for v in value:
                sub = nn.Module()
                attach_params(sub, v)
                subs.append(sub)
            module.add_module(key, nn.ModuleList(subs))


class TreeModel(nn.Module):
    """A model's config and the reference's parameter tree, held as frozen
    parameters under the tree's names (``a/b`` registered as ``a.b``),
    taken as they are, not copied."""

    def __init__(self, cfg, params: Dict):
        super().__init__()
        self.cfg = cfg
        self._skeleton = map_with_path(lambda path, _: path, params)
        attach_params(self, params)

    def params(self) -> Dict:
        """The reference's parameter tree, sharing this model's storage."""
        return map_with_path(
            lambda _, path: self.get_parameter(path.replace("/", ".")),
            self._skeleton)
