"""Universal hash families (port of ``repro.core.hashing``).

The paper's three schemes: full random permutations, 2-universal (2U)
multiply-shift hashing (Eq. 10) and 4-universal (4U) polynomial hashing
over the Mersenne prime p = 2^31 - 1 with the §3.4 ``BitMod`` reduction.

Families hold their coefficients as int32 tensors of uint32 bit patterns
(``repro_torch.core.u32``) on one device.  They are built from coefficient
arrays (``from_numpy``, which is how the tests carry a JAX family over) or
drawn from a ``torch.Generator`` (``create``); JAX's ``jax.random.bits``
stream cannot be reproduced, so the two packages agree only when they
share coefficients.

The plain arithmetic below works on int64 values in [0, 2^32).  int64 has
no unsigned 64-bit product, so the 4U step forms ``acc * t + coef`` as a
(hi, lo) pair from two 48-bit partial products; the CUDA kernels use native
``unsigned long long`` instead.  Both give the uint32 results of
``repro.core.hashing`` bit for bit, wrap-arounds included.

4U reduces each Horner step by ``BitMod`` or, with ``use_bitmod=False``
(Table 2's "4U (Mod)" row), by a true modulo of the 64-bit value.  The two
agree for coefficients < p and indices < 2^31, the family's domain;
outside it ``BitMod``'s first fold overflows and they part, in the port
exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.u32 import M32, from_numpy, mul_lo, widen
from repro_torch.device import DeviceLike, resolve_device

MERSENNE_P = 2**31 - 1  # p = 2^31 - 1, the paper's §3.4 prime


def _bits(generator: Optional[torch.Generator], shape) -> np.ndarray:
    """Uniform uint32 values, drawn on the CPU so that a seeded generator
    gives the same family whatever the device."""
    x = torch.randint(0, 2**32, shape, dtype=torch.int64, generator=generator)
    return x.numpy()


# ---------------------------------------------------------------------------
# Plain arithmetic on int64 values in [0, 2^32)
# ---------------------------------------------------------------------------

def hash2u_apply(t: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor, s: int,
                 variant: str = "high") -> torch.Tensor:
    """2U hash, broadcasting ``a1``/``a2`` against ``t``; int64 in/out.

    ``a2 * t`` is masked before ``a1`` is added, so the sum stays far from
    the int64 limit; ``mul_lo`` keeps the product exact for any uint32 t.
    """
    v = (widen(a1) + mul_lo(widen(a2), widen(t))) & M32
    if s >= 32:
        return v
    if variant == "high":
        return v >> (32 - s)
    return v & ((1 << s) - 1)


def mul_add64(acc: torch.Tensor, t: torch.Tensor, coef: torch.Tensor):
    """``acc * t + coef`` modulo 2^64 as a (hi, lo) pair of uint32 values,
    exactly as the reference's ``umul32_wide`` + ``add64`` form it; every
    uint32 wrap of the reference is reproduced by the ``& M32`` masks."""
    t_lo, t_hi = t & 0xFFFF, t >> 16
    p0 = acc * t_lo                           # < 2^48
    p1 = acc * t_hi                           # < 2^48
    low = p0 + ((p1 & 0xFFFF) << 16)          # < 2^49
    hi = (low >> 32) + (p1 >> 16)
    lo = (low & M32) + coef
    hi = (hi + (lo >> 32)) & M32
    return hi, lo & M32


def horner_step(acc: torch.Tensor, t: torch.Tensor, coef: torch.Tensor,
                use_bitmod: bool = True) -> torch.Tensor:
    """One 4U Horner step ``(acc * t + coef)`` reduced by ``BitMod`` (two
    folds and a conditional subtract) or, ``use_bitmod=False``, by
    ``_slow_mod_mersenne31``."""
    hi, lo = mul_add64(acc, t, coef)
    return mod_mersenne31(hi, lo) if use_bitmod else _slow_mod_mersenne31(hi, lo)


def mod_mersenne31(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``BitMod``: two folds ``v = (v >> 31) + (v & p)`` and one
    conditional subtract, on the (hi, lo) uint32 pair; int64 in/out."""
    p = MERSENNE_P
    v1 = ((((hi << 1) & M32) | (lo >> 31)) + (lo & p)) & M32
    v2 = ((v1 >> 31) + (v1 & p)) & M32
    return torch.where(v2 >= p, v2 - p, v2)


def _slow_mod_mersenne31(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``(hi * 2^32 + lo) mod p`` for any uint32 pair, the "Mod" baseline:
    ``((hi mod p) * (2^32 mod p) + lo mod p) mod p``; int64 in/out."""
    p = MERSENNE_P
    term = (hi % p) * (2**32 % p) % p         # 2^32 mod p == 2
    v = term + lo % p                         # < 2p
    return torch.where(v >= p, v - p, v)


def hash4u_apply(t: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
                 a3: torch.Tensor, a4: torch.Tensor, s: int,
                 use_bitmod: bool = True) -> torch.Tensor:
    """``((a4 t^3 + a3 t^2 + a2 t + a1) mod p) mod 2^s`` by Horner's rule;
    broadcasting, int64 in/out."""
    t = widen(t)
    acc = torch.broadcast_to(widen(a4), torch.broadcast_shapes(t.shape, a4.shape))
    for coef in (a3, a2, a1):
        acc = horner_step(acc, t, widen(coef), use_bitmod)
    if s < 31:
        return acc & ((1 << s) - 1)
    return acc % MERSENNE_P


# ---------------------------------------------------------------------------
# Hash families
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hash2U:
    """2-universal multiply-shift family (paper Eq. 10).

    ``h_j(t) = ((a1_j + a2_j * t) mod 2^32) >> (32 - s)`` (``variant
    "high"``) or ``& (2^s - 1)`` (``"low"``), with ``a2`` odd.
    """

    a1: torch.Tensor   # (k,) int32 uint32 bit patterns
    a2: torch.Tensor   # (k,) int32, odd
    s: int             # D = 2^s
    variant: str = "high"

    @property
    def k(self) -> int:
        return self.a1.shape[0]

    @property
    def D(self) -> int:
        return 1 << self.s

    @property
    def device(self) -> torch.device:
        return self.a1.device

    @staticmethod
    def from_numpy(a1, a2, s: int, variant: str = "high",
                   device: DeviceLike = None) -> "Hash2U":
        dev = resolve_device(device)
        return Hash2U(a1=from_numpy(a1, dev), a2=from_numpy(a2, dev), s=s,
                      variant=variant)

    @staticmethod
    def create(k: int, s: int, variant: str = "high", *,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> "Hash2U":
        if not 1 <= s <= 32:
            raise ValueError(f"need 1 <= s <= 32, got {s}")
        dev = resolve_device(device)
        a1 = _bits(generator, (k,))
        a2 = _bits(generator, (k,)) | 1
        return Hash2U.from_numpy(a1, a2, s, variant, dev)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """Hash ``t`` (any shape) with all k functions: ``t.shape + (k,)``
        int64 values in [0, 2^s)."""
        return hash2u_apply(t[..., None], self.a1, self.a2, self.s,
                            self.variant)


@dataclasses.dataclass(frozen=True)
class Hash4U:
    """4-universal polynomial family over p = 2^31 - 1 (Eq. 9 + §3.4),
    every ``mod p`` done by ``BitMod`` (``use_bitmod=False``: by a true
    modulo, the "4U (Mod)" row of Table 2), the final ``mod 2^s`` by a
    mask.  The CUDA kernel computes the ``BitMod`` form; the Mod form runs
    as plain PyTorch, as the reference runs it as jnp."""

    a: torch.Tensor    # (4, k) int32, coefficients < p
    s: int             # D = 2^s, s <= 31
    use_bitmod: bool = True

    @property
    def k(self) -> int:
        return self.a.shape[1]

    @property
    def D(self) -> int:
        return 1 << self.s

    @property
    def device(self) -> torch.device:
        return self.a.device

    @staticmethod
    def from_numpy(a, s: int, device: DeviceLike = None, *,
                   use_bitmod: bool = True) -> "Hash4U":
        if not 1 <= s <= 31:
            raise ValueError(f"4U over p=2^31-1 needs s <= 31, got {s}")
        return Hash4U(a=from_numpy(a, resolve_device(device)), s=s,
                      use_bitmod=use_bitmod)

    @staticmethod
    def create(k: int, s: int, use_bitmod: bool = True, *,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> "Hash4U":
        a = _bits(generator, (4, k)) % MERSENNE_P
        return Hash4U.from_numpy(a, s, device, use_bitmod=use_bitmod)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """``t.shape + (k,)`` int64 values in [0, 2^s)."""
        return hash4u_apply(t[..., None], self.a[0], self.a[1], self.a[2],
                            self.a[3], self.s, self.use_bitmod)


@dataclasses.dataclass(frozen=True)
class PermutationFamily:
    """k independent random permutations of [0, D): O(k * D) storage, the
    paper's case against them at web scale.

    The table is laid out (D, k): row t holds pi_1(t) .. pi_k(t), so the k
    values one nonzero needs are one contiguous row of 4k bytes (at k = 200,
    D = 2^24 a (k, D) layout would read them 64 MiB apart, a 32-byte sector
    each).  ``perms`` is the reference's (k, D) view of the same storage,
    not a copy.
    """

    table: torch.Tensor   # (D, k) int32; table[t, j] = pi_j(t)

    @property
    def perms(self) -> torch.Tensor:
        """(k, D) view: ``perms[j, t] = pi_j(t)``, as the reference holds it."""
        return self.table.t()

    @property
    def k(self) -> int:
        return self.table.shape[1]

    @property
    def D(self) -> int:
        return self.table.shape[0]

    @property
    def device(self) -> torch.device:
        return self.table.device

    @staticmethod
    def from_numpy(perms, device: DeviceLike = None) -> "PermutationFamily":
        """From the reference's (k, D) array."""
        p = np.array(np.asarray(perms, np.int32).T, order="C")
        return PermutationFamily(table=torch.from_numpy(p).to(resolve_device(device)))

    @staticmethod
    def create(k: int, D: int, *, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> "PermutationFamily":
        """One ``torch.randperm`` per function, drawn on the generator's
        device (on ``device`` when no generator is given) and written into
        its column of the (D, k) table."""
        dev = resolve_device(device)
        draw_on = generator.device if generator is not None else dev
        table = torch.empty((D, k), dtype=torch.int32, device=dev)
        for j in range(k):
            table[:, j] = torch.randperm(D, generator=generator,
                                         device=draw_on).to(dev)
        return PermutationFamily(table=table)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """``t.shape + (k,)`` int64 permuted values."""
        return self.table[t.to(torch.int64)].to(torch.int64)

    def storage_bytes(self) -> int:
        return self.k * self.D * 4


def family_storage_bytes(family) -> int:
    """Coefficient storage -- the paper's comparison of the families."""
    if isinstance(family, PermutationFamily):
        return family.storage_bytes()
    if isinstance(family, Hash2U):
        return 2 * family.k * 4
    if isinstance(family, Hash4U):
        return 4 * family.k * 4
    base = getattr(family, "base", None)   # OPH: ONE function's coefficients
    if base is not None:
        return family_storage_bytes(base)
    raise TypeError(type(family))
