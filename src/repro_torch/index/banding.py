"""LSH banding math for the similarity-search index (port of
``repro.index.banding``).

  * ``BandingConfig``        -- n_bands x rows_per_band bands over
                                ``code_bits``-wide signature values,
  * ``band_keys_from_codes`` -- pack each band's r codes into one uint32
                                bucket key,
  * ``band_keys_packed``     -- band keys straight from packed wire words,
                                unpacked on the words' device,
  * ``s_curve`` / ``choose_band_config`` -- the LSH collision calculus
    1 - (1 - p^r)^n_bands composed with Theorem 1's sparse-limit b-bit
    collision probability, and the tuner built on it.

Keys are uint32 values held as int32 bit patterns
(``repro_torch.core.u32``); they are built in int64 and masked, so they
are the same on the CPU and the card and equal to the reference's.
Sentinel OPH wires band over the (b+1)-bit codes with EMPTY keyed as 2^b.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.u32 import EMPTY, M32, narrow, widen
from repro_torch.kernels.pack import PackSpec, unpack_device

MAX_KEY_BITS = 32


@dataclasses.dataclass(frozen=True)
class BandingConfig:
    """n_bands bands of rows_per_band ``code_bits``-wide values each;
    ``rows_per_band * code_bits <= 32`` so a key is the exact packed
    value."""

    n_bands: int
    rows_per_band: int
    code_bits: int               # bits per banded value (b, or b+1 sentinel)

    def __post_init__(self):
        if self.n_bands < 1 or self.rows_per_band < 1:
            raise ValueError(f"need n_bands, rows_per_band >= 1, got "
                             f"({self.n_bands}, {self.rows_per_band})")
        if self.rows_per_band * self.code_bits > MAX_KEY_BITS:
            raise ValueError(
                f"band key needs {self.rows_per_band * self.code_bits} bits "
                f"> {MAX_KEY_BITS} (uint32 keys); reduce rows_per_band or "
                f"code_bits")

    @property
    def k(self) -> int:
        """Signature values consumed by the banding (first k of each row)."""
        return self.n_bands * self.rows_per_band


def band_keys_from_codes(codes: torch.Tensor,
                         cfg: BandingConfig) -> torch.Tensor:
    """(n, >=cfg.k) codes -> (n, n_bands) uint32 keys (int32 patterns).

    Band i's key packs codes [i*r, (i+1)*r) little-endian at
    ``code_bits`` per value; columns past ``cfg.k`` are ignored.
    """
    n, k = codes.shape
    if k < cfg.k:
        raise ValueError(f"signature width {k} < bands*rows {cfg.k}")
    z = widen(codes[:, :cfg.k]).reshape(n, cfg.n_bands, cfg.rows_per_band)
    if cfg.code_bits < 32:
        z = z & ((1 << cfg.code_bits) - 1)
    shifts = torch.arange(cfg.rows_per_band, dtype=torch.int64,
                          device=z.device) * cfg.code_bits
    return narrow(((z << shifts) & M32).sum(-1))


def band_keys_packed(words: torch.Tensor, spec: PackSpec,
                     cfg: BandingConfig) -> torch.Tensor:
    """Band keys straight from packed wire words (unpacked on their
    device); the host sees packed words in, keys out."""
    if cfg.code_bits != spec.code_bits:
        raise ValueError(f"banding over {cfg.code_bits}-bit values, wire "
                         f"carries {spec.code_bits}-bit codes")
    codes = unpack_device(words, spec)
    if spec.sentinel:
        # band over the raw (b+1)-bit codes: EMPTY keys as 2^b, not as the
        # 0xFFFFFFFF marker unpack_device restores
        codes = torch.where(widen(codes) == EMPTY, spec.empty_code,
                            widen(codes))
    return band_keys_from_codes(codes, cfg)


# ---------------------------------------------------------------------------
# S-curve calculus
# ---------------------------------------------------------------------------

def s_curve(p_collide: float, n_bands: int, rows_per_band: int) -> float:
    """P[candidate] when one banded value collides with prob p_collide."""
    return 1.0 - (1.0 - float(p_collide) ** rows_per_band) ** n_bands


def sparse_collision_prob(R: float, b: int) -> float:
    """Theorem 1 in the sparse limit r -> 0: P_b = 2^-b + (1 - 2^-b) R."""
    c = 2.0 ** -b
    return c + (1.0 - c) * R


def choose_band_config(k: int, b: int, *, code_bits: int = 0,
                       threshold: float = 0.5, target_recall: float = 0.95
                       ) -> BandingConfig:
    """Most selective banding still predicted to clear ``target_recall``.

    Sweeps rows_per_band from large to small and keeps the first r whose
    predicted candidate probability at resemblance ``threshold`` reaches
    the target; ``n_bands = k // r``.  Sentinel wires pass
    ``code_bits=b+1``; the prediction still uses the b-bit collision
    probability, a lower bound on the code-level one.
    """
    cb = code_bits or b
    pb = sparse_collision_prob(threshold, b)
    for r in range(min(k, MAX_KEY_BITS // cb), 0, -1):
        n_bands = k // r
        if s_curve(pb, n_bands, r) >= target_recall:
            return BandingConfig(n_bands, r, cb)
    raise ValueError(
        f"no (n_bands, r) over k={k}, b={b} reaches recall "
        f"{target_recall} at threshold {threshold}; lower the target")
