"""The benchmark's one generator: every input of every cell, made from
``--seed`` and the parameters of a configuration and a traffic mix.

The inputs are binary sets over ``[0, D)``, held as a padded batch: ids
(rows, width) int64 and a length per row; lanes at and past a row's
length are padding.  Row i of a data set draws its ids from a counter
hash of (seed, stream, i, lane), so any row can be made again, alone or
with others, on any device, and gives the same ids: the reference makes
the rows it checks again from the same function.  Integer
arithmetic only (int64 values below 2^63), so the CPU and the card give
the same data for the same seed.

Row lengths are a fixed set that the configuration states: the evenly
spaced quantiles of a distribution whose quantile function runs
linearly between ``knots`` (nonzeros at equal steps of probability, the
first at 0 and the last at 1), so the knots fix its median, mean and
range; the seed only permutes the set.  So every seed hands the program the same amount of
work, in another order.  Ids are drawn with replacement: a row with a
repeated id is the set of its distinct ids, and a repeat changes no
minimum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B
_GOLDEN = 0x9E3779B9
_ROW = 0x85EBCA6B
LANE_MULTIPLE = 128          # padded widths are whole multiples of this


def mix32(x):
    """A bijection of [0, 2^32) that scatters its input: two multiply /
    xor-shift rounds.  Takes Python ints, int64 numpy arrays or int64
    tensors holding values in [0, 2^32); products stay below 2^59."""
    x = (((x >> 16) ^ x) * _MIX) & M32
    x = (((x >> 16) ^ x) * _MIX) & M32
    return (x >> 16) ^ x


def stream_key(seed: int, *tags: int) -> int:
    """A 32-bit key for one stream of draws: the seed's 64 bits and the
    tags folded in turn.  Any whole seed, negative ones included."""
    s = int(seed) % (1 << 64)
    h = mix32(s & M32)
    h = mix32(h ^ ((s >> 32) & M32) ^ _GOLDEN)
    for tag in tags:
        h = mix32(h ^ mix32((int(tag) * _ROW + _GOLDEN) & M32))
    return h


def u32_draws(key: int, rows: torch.Tensor, width: int) -> torch.Tensor:
    """(len(rows), width) int64 values in [0, 2^32): one draw per (row,
    lane) of the stream ``key``.  ``rows`` is an int64 tensor of row
    numbers below 2^31; the result lies on its device."""
    lanes = torch.arange(width, dtype=torch.int64, device=rows.device)
    col = mix32((lanes * _GOLDEN + key) & M32)
    row = mix32((rows.to(torch.int64) * _ROW + (key ^ _GOLDEN)) & M32)
    x = (row[:, None] + col[None, :]) & M32
    x = (((x >> 16) ^ x) * _MIX) & M32
    return (x >> 15) ^ x


def uniform_ids(key: int, rows: torch.Tensor, width: int,
                D: int) -> torch.Tensor:
    """(len(rows), width) int64 ids in [0, D), D <= 2^31."""
    return (u32_draws(key, rows, width) * D) >> 32


def padded_width(high: int) -> int:
    """The batch width that holds a row of ``high`` nonzeros."""
    return -(-int(high) // LANE_MULTIPLE) * LANE_MULTIPLE


def row_lengths(seed: int, n: int, knots) -> np.ndarray:
    """(n,) int64 lengths: the quantiles at (2i + 1) / 2n, i < n, of the
    piecewise-linear quantile function through ``knots`` (non-decreasing,
    at probabilities j / (len(knots) - 1)), each rounded to the nearest
    whole, in an order drawn from the seed."""
    knots = np.asarray(knots, dtype=np.int64)
    if knots.ndim != 1 or len(knots) < 2 or (np.diff(knots) < 0).any() \
            or knots[0] < 0:
        raise ValueError(f"knots must be >= 2 non-decreasing lengths >= 0, "
                         f"got {knots.tolist()}")
    i = np.arange(n, dtype=np.int64)
    t = (2 * i + 1) * (len(knots) - 1)          # the quantile, times 2n
    j, r = t // (2 * n), t % (2 * n)
    step = knots[j + 1] - knots[j]
    lengths = knots[j] + (2 * step * r + 2 * n) // (4 * n)
    order = np.argsort(mix32((i + stream_key(seed, 1)) & M32), kind="stable")
    return lengths[order]


def mask_of(lengths: torch.Tensor, width: int) -> torch.Tensor:
    """(rows, width) bool: lane < the row's length."""
    lanes = torch.arange(width, device=lengths.device)
    return lanes[None, :] < lengths[:, None]


class SetStream:
    """One data set of ``n`` rows: row i holds ``lengths[i]`` ids drawn
    from ``[0, D)`` by the stream (seed, ``tag``), its lengths the set
    ``row_lengths(seed, n, knots)``."""

    def __init__(self, seed: int, tag: int, n: int, D: int, knots):
        self.n, self.D = int(n), int(D)
        self.key = stream_key(seed, tag)
        self.width = padded_width(max(knots))
        self.lengths_host = row_lengths(seed, n, knots)
        self._on: dict = {}

    def lengths(self, rows: torch.Tensor) -> torch.Tensor:
        """The lengths of ``rows`` (an int64 tensor), on its device (the
        whole set is copied there once)."""
        dev = rows.device
        if dev not in self._on:
            self._on[dev] = torch.from_numpy(self.lengths_host).to(dev)
        return self._on[dev][rows]

    def ids(self, rows: torch.Tensor, width: Optional[int] = None
            ) -> torch.Tensor:
        """(len(rows), width) int64 ids; lanes past a row's length hold
        draws too, which ``mask_of`` leaves out."""
        return uniform_ids(self.key, rows, width or self.width, self.D)

    def batch(self, start: int, stop: int, device) -> tuple:
        """Rows [start, stop) as (int32 ids with 0 on padding, bool mask,
        int64 lengths), on ``device``."""
        rows = torch.arange(start, stop, dtype=torch.int64, device=device)
        return padded(self.ids(rows), self.lengths(rows))


def padded(ids: torch.Tensor, lengths: torch.Tensor) -> tuple:
    """(int32 ids, 0 past each row's length; bool mask; lengths)."""
    mask = mask_of(lengths, ids.shape[1])
    return (torch.where(mask, ids, 0).to(torch.int32), mask, lengths)


P31 = (1 << 31) - 1


def coefficients(seed: int, draw: int, family: str, k: int) -> dict:
    """Hash coefficients of draw ``draw`` (a pass number, say) as int64
    numpy arrays: 2U ``{"a1", "a2"}`` (k each, a2 odd), 4U ``{"a"}`` (4, k)
    rows ``[a1, a2, a3, a4]``, each below p = 2^31 - 1."""
    rng = np.random.default_rng([stream_key(seed, 3), int(draw)])
    if family == "2u":
        return {"a1": rng.integers(0, 1 << 32, k, dtype=np.int64),
                "a2": rng.integers(0, 1 << 32, k, dtype=np.int64) | 1}
    if family == "4u":
        return {"a": rng.integers(0, P31, (4, k), dtype=np.int64)}
    raise ValueError(f"family must be '2u' or '4u', got {family!r}")
