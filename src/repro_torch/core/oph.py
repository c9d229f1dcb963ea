"""One Permutation Hashing (port of ``repro.core.oph``).

ONE hash function h: [0, D) -> [0, D) splits the universe into k bins of
width D/k; each bin keeps the minimum in-bin offset of the set's elements:

    bin(t) = h(t) >> (s - log2 k),  offset(t) = h(t) & (D/k - 1)

Empty bins hold EMPTY (0xFFFFFFFF) and are filled by one of the
densifiers: ``rotation`` (Shrivastava & Li 2014), ``optimal`` (Shrivastava
2017), ``fast`` (Mai et al. 2020), or kept (``sentinel``).  This module is
the plain reference; ``repro_torch.kernels.oph`` holds the CUDA kernels
that compute the raw bin minima.  uint32 values follow
``repro_torch.core.u32``: int32 bit patterns in and out, int64 inside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.hashing import Hash2U, Hash4U, PermutationFamily
from repro_torch.core.u32 import EMPTY, M32, mul_lo, narrow, widen
from repro_torch.device import DeviceLike

BaseFamily = Union[Hash2U, Hash4U, PermutationFamily]
DENSIFIERS = ("rotation", "sentinel", "optimal", "fast")


@dataclasses.dataclass(frozen=True)
class OPH:
    """ONE base hash function + k bins + a densification strategy."""

    base: BaseFamily
    k: int                      # number of bins == signature length
    densify: str = "rotation"   # "rotation"|"sentinel"|"optimal"|"fast"

    def __post_init__(self):
        if self.base.k != 1:
            raise ValueError(f"OPH uses ONE hash function, got base.k={self.base.k}")
        s = self.s
        if s > 31:
            raise ValueError(f"OPH needs s <= 31 (rotation offsets overflow), got {s}")
        if self.k & (self.k - 1) or not (1 <= self.k <= (1 << s)):
            raise ValueError(f"k must be a power of two in [1, 2^{s}], got {self.k}")
        if self.densify not in DENSIFIERS:
            raise ValueError("densify must be 'rotation', 'sentinel', "
                             f"'optimal' or 'fast', got {self.densify!r}")

    @property
    def s(self) -> int:
        if isinstance(self.base, PermutationFamily):
            D = self.base.D
            if D & (D - 1):
                raise ValueError(f"OPH over a permutation needs power-of-two D, got {D}")
            return D.bit_length() - 1
        return self.base.s

    @property
    def D(self) -> int:
        return 1 << self.s

    @property
    def bin_bits(self) -> int:
        return self.k.bit_length() - 1

    @property
    def bin_width(self) -> int:
        return 1 << (self.s - self.bin_bits)

    @property
    def device(self) -> torch.device:
        return self.base.device

    @staticmethod
    def create(k: int, s: int, family: str = "2u", densify: str = "rotation",
               *, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None, **family_kwargs) -> "OPH":
        """An OPH scheme over a freshly drawn single-function base."""
        if family == "2u":
            base = Hash2U.create(1, s, generator=generator, device=device,
                                 **family_kwargs)
        elif family == "4u":
            base = Hash4U.create(1, s, generator=generator, device=device)
        elif family == "perm":
            base = PermutationFamily.create(1, 1 << s, generator=generator,
                                            device=device)
        else:
            raise ValueError(f"family must be '2u', '4u' or 'perm', got {family!r}")
        return OPH(base=base, k=k, densify=densify)


def split_hash(h: torch.Tensor, s: int, bin_bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash values in [0, 2^s) -> (bin id, in-bin offset), int64."""
    h = widen(h)
    off_bits = s - bin_bits
    bins = (h >> off_bits) if bin_bits > 0 else torch.zeros_like(h)
    return bins, h & ((1 << off_bits) - 1)


def binned_min(bins: torch.Tensor, offs: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Per-row scatter-min of ``offs`` into ``k`` bins; invalid lanes carry
    EMPTY into bin 0 and so never win.  Returns (n, k) int64."""
    n = bins.shape[0]
    offs = torch.where(valid, offs, EMPTY)
    bins = torch.where(valid, bins, 0)
    out = torch.full((n, k), EMPTY, dtype=torch.int64, device=bins.device)
    return out.scatter_reduce_(1, bins, offs, reduce="amin")


def oph_signatures(indices: torch.Tensor, mask: torch.Tensor, oph: OPH,
                   b: int = 0) -> torch.Tensor:
    """Reference OPH signatures of a padded batch: (n, k) int32 values,
    densified per ``oph.densify`` and b-bit masked when ``b > 0``."""
    h = oph.base(indices)[..., 0]                      # ONE hash: (n, nnz)
    bins, offs = split_hash(h, oph.s, oph.bin_bits)
    sig = binned_min(bins, offs, mask, oph.k)
    return densify_and_bbit(narrow(sig), oph.bin_width, oph.densify, b)


def densify_and_bbit(sig: torch.Tensor, bin_width: int, densify: str,
                     b: int) -> torch.Tensor:
    """Shared epilogue: densify sentinel-coded minima, keep b bits.

    Under ``sentinel`` EMPTY survives the b-bit mask; under the other
    densifiers only all-empty rows stay EMPTY, and they fold to the
    all-ones b-bit code.
    """
    if densify == "rotation":
        sig = densify_rotation(sig, bin_width)
    elif densify == "optimal":
        sig = densify_optimal(sig)
    elif densify == "fast":
        sig = densify_fast(sig)
    if b > 0:
        v = widen(sig)
        mask_b = (1 << b) - 1
        if densify in ("rotation", "optimal", "fast"):
            v = v & mask_b
        else:
            v = torch.where(v != EMPTY, v & mask_b, v)
        sig = narrow(v)
    return sig


def densify_rotation(sig: torch.Tensor, bin_width: int) -> torch.Tensor:
    """Shrivastava-Li rotation: an empty bin takes the nearest non-empty
    bin to its right (circularly) plus ``distance * (bin_width + 1)``, in
    uint32 arithmetic (it wraps past 2^32 once s is near 31).

    The nearest non-empty successor comes from ``torch.cummin`` over the
    flipped row.  All-empty rows stay all-EMPTY.
    """
    v = widen(sig)
    n, k = v.shape
    nonempty = v != EMPTY
    idx = torch.arange(k, dtype=torch.int64, device=v.device)
    cand = torch.where(nonempty, idx, 2 * k)
    suffix = torch.cummin(cand.flip(1), dim=1).values.flip(1)
    first = cand.min(dim=1, keepdim=True).values
    donor_pos = torch.where(suffix < 2 * k, suffix, first + k)
    dist = (donor_pos - idx) & M32
    donor = torch.gather(v, 1, donor_pos % k)
    borrowed = (donor + mul_lo(dist, bin_width + 1)) & M32
    dense = torch.where(nonempty, v, borrowed)
    return narrow(torch.where(first < 2 * k, dense, EMPTY))


def _optimal_probe(j: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Donor bin for (bin j, probe attempt t): a multiply-mix hash of the
    key t*k + j, shared by every set (uint32 arithmetic, int64 out)."""
    x = (mul_lo(torch.full_like(j, t & M32), k) + j) & M32
    h = (mul_lo(x, 2654435761) + 0x9E3779B9) & M32
    h = h ^ (h >> 16)
    return h % k


def _first_nonempty_fallback(v: torch.Tensor, nonempty: torch.Tensor
                             ) -> torch.Tensor:
    n, k = v.shape
    j = torch.arange(k, dtype=torch.int64, device=v.device)
    first = torch.where(nonempty, j, 2 * k).min(dim=1, keepdim=True).values
    return torch.gather(v, 1, first % k).expand(n, k)


def densify_optimal(sig: torch.Tensor, max_probes: int = 0) -> torch.Tensor:
    """Shrivastava (2017): each empty bin copies the first non-empty bin of
    its own probe sequence.  The reference's ``while_loop`` becomes a
    Python loop bounded by ``max_probes`` that stops once every bin is
    resolved; unresolved bins take the row's first non-empty bin."""
    v = widen(sig)
    n, k = v.shape
    if max_probes <= 0:
        max_probes = 8 * k + 64
    nonempty = v != EMPTY
    any_ne = nonempty.any(dim=1, keepdim=True)
    j = torch.arange(k, dtype=torch.int64, device=v.device)
    out, resolved = v.clone(), nonempty | ~any_ne
    t = 0
    while t < max_probes and not bool(resolved.all()):
        donor = _optimal_probe(j, t, k)
        donor_ok = nonempty[:, donor]
        newly = ~resolved & donor_ok
        out = torch.where(newly, v[:, donor], out)
        resolved = resolved | donor_ok
        t += 1
    out = torch.where(resolved, out, _first_nonempty_fallback(v, nonempty))
    return narrow(out)


def densify_fast(sig: torch.Tensor, max_rounds: int = 0) -> torch.Tensor:
    """Mai et al. (2020): on round t every originally non-empty bin j fills
    its target ``_optimal_probe(j, t)`` if still empty; several donors on
    one bin resolve to the lowest donor id (a scatter-min).  Bounded
    Python loop; unfilled bins take the row's first non-empty bin."""
    v = widen(sig)
    n, k = v.shape
    if max_rounds <= 0:
        max_rounds = 8 * k + 64
    nonempty = v != EMPTY
    any_ne = nonempty.any(dim=1, keepdim=True)
    j = torch.arange(k, dtype=torch.int64, device=v.device)
    donor_id = torch.where(nonempty, j, 2 * k)
    out, filled = v.clone(), nonempty | ~any_ne
    t = 0
    while t < max_rounds and not bool(filled.all()):
        tgt = _optimal_probe(j, t, k).expand(n, k)
        donor_at = torch.full((n, k), 2 * k, dtype=torch.int64, device=v.device)
        donor_at.scatter_reduce_(1, tgt, donor_id, reduce="amin")
        has = donor_at < 2 * k
        out = torch.where(~filled & has, torch.gather(v, 1, donor_at % k), out)
        filled = filled | has
        t += 1
    out = torch.where(filled, out, _first_nonempty_fallback(v, nonempty))
    return narrow(out)


# ---------------------------------------------------------------------------
# Estimators and the cost model
# ---------------------------------------------------------------------------

def oph_match_fraction(sig1: torch.Tensor, sig2: torch.Tensor) -> torch.Tensor:
    """Li-Owen-Zhang estimator R^ = N_match / (k - N_jointly_empty) on
    sentinel-coded signatures; on densified ones (no EMPTY bins) the plain
    Eq. (2) match fraction."""
    both_empty = (widen(sig1) == EMPTY) & (widen(sig2) == EMPTY)
    match = (sig1 == sig2) & ~both_empty
    n_match = match.to(torch.float32).sum(dim=-1)
    denom = sig1.shape[-1] - both_empty.to(torch.float32).sum(dim=-1)
    return n_match / torch.clamp(denom, min=1.0)


def hash_evaluations(n: int, avg_nnz: float, k: int, scheme: str) -> float:
    """Analytic hash-evaluation count of preprocessing (the §3 cost model):
    k-pass minwise hashing evaluates k functions per (set, nonzero), OPH
    one; the ratio is exactly k."""
    if scheme == "minhash":
        return n * avg_nnz * k
    if scheme == "oph":
        return n * avg_nnz
    raise ValueError(f"scheme must be 'minhash' or 'oph', got {scheme!r}")
