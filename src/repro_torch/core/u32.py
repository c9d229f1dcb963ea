"""uint32 values in PyTorch.

PyTorch on the CPU has no uint32 add, shift or min, so the port keeps two
forms of a 32-bit value:

  * at module boundaries, a ``torch.int32`` tensor holding the uint32 bit
    pattern (what the CUDA kernels read and write, 4 bytes a value);
  * inside plain arithmetic, ``torch.int64`` in ``[0, 2^32)``.  Every
    expression that wraps in uint32 is masked with ``M32`` by hand.

``to_numpy`` / ``from_numpy`` bridge the bit patterns to ``np.uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
EMPTY = 0xFFFFFFFF   # empty-bin / padding sentinel, as a uint32 value


def widen(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns (int32) or int64 values -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 values (low 32 bits kept) -> int32 uint32 bit patterns."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul_lo(a: torch.Tensor, b) -> torch.Tensor:
    """Low 32 bits of ``a * b`` for a, b in [0, 2^32), without int64
    overflow: b is split into 16-bit halves so each product is < 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def from_numpy(arr, device) -> torch.Tensor:
    """Any integer numpy array of uint32 values -> int32 bit patterns."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32 bit patterns -> ``np.uint32`` array (host copy)."""
    if x.dtype != torch.int32:
        raise TypeError(f"expected int32 bit patterns, got {x.dtype}")
    return x.detach().cpu().numpy().view(np.uint32)
