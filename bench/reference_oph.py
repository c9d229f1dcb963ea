"""The plain reference of One Permutation Hashing with rotation
densification, written from the definitions (Li, Owen & Zhang 2012;
Shrivastava & Li 2014) and the configuration's guarantees, not from the
program (it imports nothing of ``repro_torch``).

  * ``oph_bins`` -- one 2U function ``h = ((a1 + a2 t) mod 2^32) >> (32 -
    s)`` splits [0, 2^s) into k bins of width ``W = 2^s / k``: bin ``h //
    W``, offset ``h mod W``; each bin keeps its smallest offset, EMPTY
    (2^32 - 1) where no element of the row falls in it.  Found by sorting
    each row's hashes and looking up, for every bin, the first hash at or
    above the bin's start.
  * ``densify_rotation`` -- an empty bin j takes the nearest non-empty
    bin to its right, j + d (mod k), d = 1, 2, ..., plus ``d (W + 1)``,
    mod 2^32; a row with no element keeps EMPTY everywhere.
  * ``oph_codes`` -- both, kept to the low b bits.

The words go through ``bench.reference.pack``.  Every function works on
the device of its inputs, in blocks of rows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
EMPTY = M32
BLOCK_ELEMS = 1 << 26          # elements of the largest temporary


def _hashes(ids: torch.Tensor, lengths: torch.Tensor, a1, a2,
            s: int) -> torch.Tensor:
    """(rows, width) int64 hashes in [0, 2^s), padding lanes at 2^s."""
    rows, width = ids.shape
    lanes = torch.arange(width, device=ids.device)
    h = ((a1 + a2 * ids) & M32) >> (32 - s)
    return torch.where(lanes[None, :] < lengths[:, None], h, 1 << s)


def _column(a, rows: int, device) -> torch.Tensor:
    """A coefficient as a (rows, 1) int64 column: an int, or one value a
    row."""
    a = torch.as_tensor(a, dtype=torch.int64, device=device)
    return a.reshape(-1, 1).expand(rows, 1) if a.numel() == 1 \
        else a.reshape(rows, 1)


def oph_bins(ids: torch.Tensor, lengths: torch.Tensor, a1, a2, s: int,
             k: int) -> torch.Tensor:
    """(rows, k) int64 smallest in-bin offsets, EMPTY in an empty bin.

    ``ids`` (rows, width) int64 in [0, 2^s); lanes at or past a row's
    ``length`` are padding.  ``a1``, ``a2``: the one function's
    coefficients, ints or (rows,) tensors (one function a row)."""
    rows, width = ids.shape
    dev = ids.device
    W = (1 << s) // k
    a1, a2 = _column(a1, rows, dev), _column(a2, rows, dev)
    starts = torch.arange(k, dtype=torch.int64, device=dev) * W
    step = max(1, BLOCK_ELEMS // max(1, width))
    out = []
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        h = _hashes(ids[r0:r1], lengths[r0:r1], a1[r0:r1], a2[r0:r1], s)
        h = torch.sort(h, dim=1).values
        first = torch.searchsorted(h, starts.expand(r1 - r0, k).contiguous())
        hit = torch.gather(h, 1, first.clamp(max=width - 1))
        inside = (first < width) & (hit < starts + W)
        out.append(torch.where(inside, hit - starts, EMPTY))
    return torch.cat(out) if out else torch.empty((0, k), dtype=torch.int64,
                                                  device=dev)


def densify_rotation(bins: torch.Tensor, W: int) -> torch.Tensor:
    """Fill each empty bin from the nearest non-empty bin to its right,
    circularly, at distance d: its value plus d (W + 1), mod 2^32."""
    rows, k = bins.shape
    out = bins.clone()
    empty = bins == EMPTY
    todo = empty & ~empty.all(dim=1, keepdim=True)
    for d in range(1, k):
        if not bool(todo.any()):
            break
        donor = torch.roll(bins, -d, dims=1)          # bin j + d at j
        take = todo & (donor != EMPTY)
        out = torch.where(take, (donor + d * (W + 1)) & M32, out)
        todo = todo & ~take
    return out


def oph_codes(ids: torch.Tensor, lengths: torch.Tensor, a1, a2, s: int,
              k: int, b: int) -> torch.Tensor:
    """(rows, k) int64 b-bit codes of OPH with rotation densification."""
    bins = oph_bins(ids, lengths, a1, a2, s, k)
    return densify_rotation(bins, (1 << s) // k) & ((1 << b) - 1)
