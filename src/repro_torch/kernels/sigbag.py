"""Signature embedding-bag: the CUDA kernel and its plain version (port of
``repro.kernels.sigbag``), the Eq. (5) forward

    out[i] = sum_j table[j, tokens[i, j]]

for ``tokens (n, k)`` int32 b-bit signature values and ``table (k, 2^b,
d)`` float32 or bfloat16; the output is (n, d) in the table's type.  With
d = 1 it is the paper's linear-model inner product, with d > 1 the hashed
embedding frontend of the recsys models.

Every output element is a float32 sum from 0 over j = 0, 1, ..., k-1 in
order, cast once to the table's type: what the Pallas kernel computes, bit
for bit (``repro.kernels.ref.sigbag_ref`` sums in ``jnp.sum``'s tree order
instead).  A token outside [0, 2^b) adds nothing, as the Pallas kernel's
all-zero one-hot row does (``sigbag_ref`` gives NaN there).

  * ``sigbag_plain`` -- a loop over j of row gathers added in float32.
  * ``sigbag_cuda``  -- launches ``csrc/sigbag.cu`` on the current stream;
    counts its launches in ``sigbag_cuda.launches``.
  * ``sigbag(tokens, table)`` -- the plain version for CPU tensors, the
    kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from repro_torch.device import same_device
from repro_torch.kernels import build

TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(name: str, tokens: torch.Tensor, table: torch.Tensor):
    if tokens.dim() != 2 or table.dim() != 3:
        raise ValueError(f"{name}: need tokens (n, k) and table (k, 2^b, d), "
                         f"got {tuple(tokens.shape)} and {tuple(table.shape)}")
    if table.shape[0] != tokens.shape[1]:
        raise ValueError(f"{name}: table k={table.shape[0]} != tokens "
                         f"k={tokens.shape[1]}")
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"{name}: table must be float32 or bfloat16, got "
                        f"{table.dtype}")


def sigbag_plain(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``sigbag`` (see the module docstring)."""
    _check_shapes("sigbag_plain", tokens, table)
    n, k = tokens.shape
    two_b, d = table.shape[1], table.shape[2]
    acc = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    for j in range(k):
        tok = tokens[:, j].to(torch.int64)
        valid = (tok >= 0) & (tok < two_b)
        rows = table[j].index_select(0, tok.clamp(0, two_b - 1))
        acc += torch.where(valid[:, None], rows.float(), 0.0)
    return acc.to(table.dtype)


def sigbag_cuda(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch ``sigbag_launch`` (csrc/sigbag.cu) on the current stream;
    returns the same as ``sigbag_plain``."""
    _check_shapes("sigbag", tokens, table)
    dev = same_device(tokens, table)
    if dev.type != "cuda":
        raise ValueError(f"sigbag: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"sigbag: tokens must be int32, got {tokens.dtype}")
    for key, t in (("tokens", tokens), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"sigbag: {key} must be contiguous")
    n, k = tokens.shape
    two_b, d = table.shape[1], table.shape[2]
    if max(n, k, two_b, d) > 2**31 - 1:
        raise ValueError(f"sigbag: every extent must fit in int32, got n={n}"
                         f" and table {tuple(table.shape)}")
    out = torch.empty((n, d), dtype=table.dtype, device=dev)
    if n and d:
        with torch.cuda.device(dev):
            status = build.library("sigbag").sigbag_launch(
                tokens.data_ptr(), table.data_ptr(), n, k, two_b, d,
                int(table.dtype == torch.bfloat16), out.data_ptr(),
                build.stream_handle(dev))
        build.check(status, "sigbag")
        sigbag_cuda.launches += 1
    return out


sigbag_cuda.launches = 0


def sigbag(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Signature embedding-bag: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if same_device(tokens, table).type == "cpu":
        return sigbag_plain(tokens, table)
    return sigbag_cuda(tokens, table)
