"""Minwise-hash signatures (port of ``repro.core.minhash``), the paper's
preprocessing step: for each set the k minima

    z_j = min_{t in S} h_j(t),     j = 1..k

under one of three hash families (permutation / 2U / 4U).

On CUDA tensors 2U and 4U (``BitMod``) go to the k-pass kernels of
``repro_torch.kernels.minhash`` at ``b = 0``.  The kernels take per-row
counts, not a mask, so there the mask must be a prefix mask (the valid
lanes of each row first, as ``from_lists`` builds it); any other mask
raises.  Three paths are plain PyTorch on whatever device the batch lives
on, as the reference computes them as jnp: the permutation gather, the
4U Mod family, and every family on the CPU, where any mask is honoured.
The plain paths chunk rows so that the (rows, nnz, k) intermediate stays
within ``_PLAIN_ELEMS`` elements.

Signatures are (n, k) int32 uint32 bit patterns (``repro_torch.core.u32``);
a row with no valid lane holds EMPTY (0xFFFFFFFF) in every column.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.hashing import (Hash2U, Hash4U, PermutationFamily,
                                      hash2u_apply, hash4u_apply)
from repro_torch.core.u32 import EMPTY, narrow
from repro_torch.device import same_device
from repro_torch.kernels import minhash as kmin
from repro_torch.kernels.oph import _PLAIN_ELEMS

Family = Union[Hash2U, Hash4U, PermutationFamily]


def minhash_signatures(indices: torch.Tensor, mask: torch.Tensor,
                       family: Family) -> torch.Tensor:
    """(n, k) minima of a padded sparse batch under ``family``.

    Args:
      indices: (n, max_nnz) int32 feature ids in [0, D).
      mask:    (n, max_nnz) bool, True for real entries.
      family:  ``Hash2U`` / ``Hash4U`` / ``PermutationFamily`` on the
               batch's device.

    The reference's ``chunk_k`` (its scan's lane block) has no counterpart.
    """
    if isinstance(family, PermutationFamily):
        same_device(indices, mask, family.table)
        return _minhash_perm(indices, mask, family.table)
    if isinstance(family, Hash2U):
        dev = same_device(indices, mask, family.a1, family.a2)
        if dev.type == "cuda":
            return kmin.minhash2u(indices, prefix_counts(mask), family.a1,
                                  family.a2, s=family.s, variant=family.variant)
        fn = lambda t: hash2u_apply(t, family.a1, family.a2, family.s,
                                    family.variant)
        return _masked_min(fn, indices, mask, family.k)
    if isinstance(family, Hash4U):
        dev = same_device(indices, mask, family.a)
        if dev.type == "cuda" and family.use_bitmod:
            return kmin.minhash4u(indices, prefix_counts(mask), family.a,
                                  s=family.s)
        a = family.a
        fn = lambda t: hash4u_apply(t, a[0], a[1], a[2], a[3], family.s,
                                    family.use_bitmod)
        return _masked_min(fn, indices, mask, family.k)
    raise TypeError(type(family))


def prefix_counts(mask: torch.Tensor) -> torch.Tensor:
    """(n,) int32 valid-lane counts of a prefix mask; raises if some row's
    valid lanes are not its first ones (the kernels read lanes
    ``[0, count)``)."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    col = torch.arange(mask.shape[1], device=mask.device)
    if not torch.equal(mask, col[None, :] < counts[:, None]):
        raise ValueError("the minhash kernels take per-row counts: the mask "
                         "must hold each row's valid lanes first, as "
                         "from_lists builds it")
    return counts


def _row_step(nnz: int, k: int) -> int:
    return max(1, _PLAIN_ELEMS // max(1, nnz * k))


def _masked_min(hash_fn, indices, mask, k: int) -> torch.Tensor:
    """min over valid lanes of ``hash_fn(t[..., None])`` (int64 values in
    [0, 2^32)); masked lanes carry EMPTY and never win."""
    n, nnz = indices.shape
    out = torch.empty((n, k), dtype=torch.int32, device=indices.device)
    if nnz == 0:
        return out.fill_(-1)
    step = _row_step(nnz, k)
    for r0 in range(0, n, step):
        m = mask[r0:r0 + step, :, None]
        h = torch.where(m, hash_fn(indices[r0:r0 + step, :, None]), EMPTY)
        out[r0:r0 + step] = narrow(h.amin(dim=1))
    return out


def _minhash_perm(indices, mask, table: torch.Tensor) -> torch.Tensor:
    """Gather each nonzero's row of the (D, k) table (``index_select``:
    one contiguous 4k-byte row a lane) and take the column minima.  A
    masked lane reads the row of its row's first valid lane instead, which
    leaves the minimum as it is and spares a fill pass over the gather;
    values are < D, so the int32 minimum is the uint32 one, and a row with
    no valid lane becomes EMPTY."""
    n, nnz = indices.shape
    k = table.shape[1]
    out = torch.empty((n, k), dtype=torch.int32, device=indices.device)
    if nnz == 0:
        return out.fill_(-1)
    step = _row_step(nnz, k)
    for r0 in range(0, n, step):
        m = mask[r0:r0 + step]
        idx = indices[r0:r0 + step].to(torch.int64)
        live = m.any(dim=1, keepdim=True)
        first = torch.where(live, idx.gather(1, m.to(torch.uint8).argmax(
            dim=1, keepdim=True)), 0)
        idx = torch.where(m, idx, first)
        vals = table.index_select(0, idx.reshape(-1)).view(*idx.shape, k)
        out[r0:r0 + step] = torch.where(live, vals.amin(dim=1), -1)
    return out


# ---------------------------------------------------------------------------
# Collision-probability utilities (tests, the Appendix-A estimators)
# ---------------------------------------------------------------------------

def signature_matches(sig1: torch.Tensor, sig2: torch.Tensor) -> torch.Tensor:
    """Fraction of matching minima -- the Eq. (2) estimator R̂_M.  Bit
    patterns compare equal exactly when the uint32 values do."""
    return (sig1 == sig2).to(torch.float32).mean(dim=-1)


def resemblance(set1_mask_onehot: torch.Tensor,
                set2_mask_onehot: torch.Tensor) -> torch.Tensor:
    """Exact resemblance |S1 ∩ S2| / |S1 ∪ S2| from dense 0/1 vectors."""
    inter = (set1_mask_onehot * set2_mask_onehot).sum(dim=-1)
    union = torch.maximum(set1_mask_onehot, set2_mask_onehot).sum(dim=-1)
    return inter / torch.clamp(union, min=1)
