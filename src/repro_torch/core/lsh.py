"""LSH banding over b-bit minhash signatures: near-duplicate detection
(port of ``repro.core.lsh``), the paper's §1 offline-dedup workload.

  * signatures are split into ``n_bands`` bands of ``r`` values each,
  * each band packs into one bucket key; documents sharing any bucket
    become candidate pairs,
  * candidates are verified with the unbiased Theorem-1 estimator
    (``estimate_resemblance``) against a threshold.

A pair with resemblance R matches one band with probability ~P_b(R)^r and
any band with 1 - (1 - P_b^r)^n, P_b = C1 + (1 - C2) R.

The banding machinery is the search index's: the keys are
``repro_torch.index.banding.band_keys_from_codes`` (on the signatures'
device), the buckets ``repro_torch.index.builder.build_band_tables`` (host
numpy).  ``candidate_pairs`` visits only buckets of two or more documents
and returns the reference's sorted pair list; the verification is one
vectorized Theorem-1 pass over all candidates on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimator import bbit_constants, estimate_resemblance
from repro_torch.core.u32 import to_numpy
from repro_torch.index.banding import (BandingConfig, band_keys_from_codes,
                                       s_curve)
from repro_torch.index.builder import build_band_tables

_VERIFY_PAIRS = 1 << 16     # candidate pairs compared per numpy pass


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    n_bands: int
    rows_per_band: int           # r signatures per band
    b: int                       # bits kept per signature

    @property
    def k(self) -> int:
        return self.n_bands * self.rows_per_band


def band_keys(sig_b: torch.Tensor, cfg: LSHConfig) -> torch.Tensor:
    """(n, k) b-bit signatures (k = n_bands * r) -> (n, n_bands) uint32
    keys as int32 bit patterns; r*b <= 32."""
    n, k = sig_b.shape
    if k != cfg.k:
        raise ValueError(f"signature width {k} != bands*rows {cfg.k}")
    return band_keys_from_codes(
        sig_b, BandingConfig(cfg.n_bands, cfg.rows_per_band, cfg.b))


def match_probability(R: float, f1: int, f2: int, D: int,
                      cfg: LSHConfig) -> float:
    """Analytic S-curve: P[candidate] for a pair with resemblance R."""
    c = bbit_constants(f1, f2, D, cfg.b)
    pb = float(c.C1 + (1.0 - c.C2) * R)
    return s_curve(pb, cfg.n_bands, cfg.rows_per_band)


def candidate_pairs(keys: np.ndarray) -> List[Tuple[int, int]]:
    """All document pairs (i < j) sharing at least one band bucket, sorted.

    Buckets come from the index's sorted posting tables (doc ids ascending
    within a bucket); a bucket of one document yields no pair, buckets of
    two (the near-duplicates of a dedup corpus) are read in one pass, and
    only larger ones are walked.
    """
    _, _, bucket_offsets, postings = build_band_tables(np.asarray(keys))
    starts, sizes = bucket_offsets[:-1], np.diff(bucket_offsets)
    two = starts[sizes == 2]
    pairs = set(zip(postings[two].tolist(), postings[two + 1].tolist()))
    for t in np.flatnonzero(sizes > 2):
        members = postings[starts[t]:starts[t] + sizes[t]]
        ia, ib = np.triu_indices(members.size, k=1)
        pairs.update(zip(members[ia].tolist(), members[ib].tolist()))
    return sorted(pairs)


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy(x) if x.dtype == torch.int32 else x.detach().cpu().numpy()
    return np.asarray(x)


def dedup(sig_b: torch.Tensor, set_sizes: Sequence[int], D: int,
          cfg: LSHConfig, threshold: float = 0.8
          ) -> List[Tuple[int, int, float]]:
    """Near-duplicate pairs: LSH candidates + Theorem-1 verification.

    Returns (i, j, estimated_resemblance) for the candidate pairs with
    R_hat >= threshold, in ``candidate_pairs`` order.
    """
    keys = _as_numpy(band_keys(sig_b, cfg))
    sig = _as_numpy(sig_b)
    pairs = candidate_pairs(keys)
    if not pairs:
        return []
    ij = np.asarray(pairs, np.int64)
    sizes = np.asarray(set_sizes, np.int64)
    p_hat = np.concatenate([
        np.mean(sig[ij[c:c + _VERIFY_PAIRS, 0]] == sig[ij[c:c + _VERIFY_PAIRS, 1]],
                axis=1)
        for c in range(0, len(ij), _VERIFY_PAIRS)])
    r_hat = estimate_resemblance(torch.from_numpy(p_hat).to(torch.float32),
                                 torch.from_numpy(sizes[ij[:, 0]]),
                                 torch.from_numpy(sizes[ij[:, 1]]),
                                 D, cfg.b).numpy()
    keep = np.flatnonzero(r_hat >= threshold)
    return [(pairs[t][0], pairs[t][1], float(r_hat[t])) for t in keep]
