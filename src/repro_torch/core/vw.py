"""Vowpal-Wabbit-style feature hashing (Weinberger et al. [37], Shi et al.
[33]; port of ``repro.core.vw``) -- the paper's §4.2/§5.3 baseline.

Each feature index t goes to bin ``h(t) in [0, m)`` with sign
``xi(t) in {-1, +1}``; the hashed vector is ``x'_i = sum_{t: h(t)=i}
xi(t) x_t``, for the paper's binary data a signed count per bin.  Two
randomness modes, as in Figure 5:

  * ``full`` -- h and xi are uniformly random tables of size D (small D),
  * ``u2``   -- h is the 2U multiply-shift scheme; xi is one extra 2U bit.

The scatter-add is ``index_add_``.  On the card it adds with atomics in no
fixed order, but for binary data every sum is of +-1 values, exact in
float32, so the vectors are the same whatever the order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hashing import _bits, hash2u_apply
from repro_torch.core.u32 import from_numpy
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class VWHasher:
    mode: str                                   # "full" | "u2"
    m_bits: int                                 # m = 2^m_bits bins
    # full-random tables (mode == "full")
    bin_table: Optional[torch.Tensor] = None    # (D,) int32
    sign_table: Optional[torch.Tensor] = None   # (D,) int8 in {-1, +1}
    # 2U coefficients (mode == "u2"), (1,) int32 uint32 bit patterns
    a1: Optional[torch.Tensor] = None
    a2: Optional[torch.Tensor] = None
    s1: Optional[torch.Tensor] = None
    s2: Optional[torch.Tensor] = None

    @property
    def m(self) -> int:
        return 1 << self.m_bits

    @staticmethod
    def create(m_bits: int, mode: str = "u2", D: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> "VWHasher":
        """Draw the tables or coefficients on the CPU from ``generator``
        (so a seed gives the same hasher on any device), then move them."""
        dev = resolve_device(device)
        if mode == "full":
            if D is None:
                raise ValueError("full-random VW needs explicit D")
            bins = torch.randint(0, 1 << m_bits, (D,), generator=generator,
                                 dtype=torch.int32)
            signs = (torch.randint(0, 2, (D,), generator=generator,
                                   dtype=torch.int8) * 2 - 1)
            return VWHasher(mode=mode, m_bits=m_bits, bin_table=bins.to(dev),
                            sign_table=signs.to(dev))
        if mode == "u2":
            a1, a2, s1, s2 = _bits(generator, (4,))
            return VWHasher.from_numpy(m_bits, mode, a1=a1, a2=a2 | 1, s1=s1,
                                       s2=s2 | 1, device=dev)
        raise ValueError(f"mode must be 'full' or 'u2', got {mode!r}")

    @staticmethod
    def from_numpy(m_bits: int, mode: str, *, bin_table=None, sign_table=None,
                   a1=None, a2=None, s1=None, s2=None,
                   device: DeviceLike = None) -> "VWHasher":
        """From numpy tables (``full``) or uint32 coefficients (``u2``),
        which is how a reference hasher is carried over."""
        dev = resolve_device(device)
        if mode == "full":
            return VWHasher(
                mode=mode, m_bits=m_bits,
                bin_table=torch.from_numpy(np.asarray(bin_table, np.int32).copy()).to(dev),
                sign_table=torch.from_numpy(np.asarray(sign_table, np.int8).copy()).to(dev))
        c = [from_numpy(np.reshape(x, (1,)), dev) for x in (a1, a2, s1, s2)]
        return VWHasher(mode=mode, m_bits=m_bits, a1=c[0], a2=c[1], s1=c[2],
                        s2=c[3])

    def bins_and_signs(self, t: torch.Tensor):
        """(int64 bins in [0, m), float32 signs in {-1, +1}) of ``t``."""
        if self.mode == "full":
            t = t.to(torch.int64)
            return (self.bin_table[t].to(torch.int64),
                    self.sign_table[t].to(torch.float32))
        bins = hash2u_apply(t, self.a1, self.a2, self.m_bits)
        sign_bit = hash2u_apply(t, self.s1, self.s2, 1)
        return bins, sign_bit.to(torch.float32) * 2.0 - 1.0

    def __call__(self, indices: torch.Tensor, mask: torch.Tensor,
                 values: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hash a padded sparse batch into dense (n, m) float32 vectors.

        Args:
          indices: (n, max_nnz) int32, mask: (n, max_nnz) bool.
          values:  optional (n, max_nnz) float; default all-ones (binary).
        """
        n, nnz = indices.shape
        bins, signs = self.bins_and_signs(torch.where(mask, indices, 0))
        vals = signs if values is None else signs * values
        vals = torch.where(mask, vals, 0.0)
        row = torch.arange(n, device=indices.device)[:, None]
        flat = (row * self.m + bins).reshape(-1)
        out = torch.zeros(n * self.m, dtype=torch.float32,
                          device=indices.device)
        return out.index_add_(0, flat, vals.reshape(-1)).reshape(n, self.m)
