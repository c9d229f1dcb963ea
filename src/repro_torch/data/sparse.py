"""Padded-CSR sparse batch of tensors (port of ``repro.data.sparse``).

Binary feature sets are ``indices (n, max_nnz) int32`` plus a validity
``mask (n, max_nnz) bool``; one batch is one of the paper's chunks of 10K
sets.  ``from_lists`` builds it in numpy, then copies it to the device:
through a pinned host buffer and a ``non_blocking`` copy on the current
stream when the device is CUDA, so a loader thread can enqueue the copy of
chunk i+1 while chunk i is hashed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """A batch of binary sets in padded-CSR form."""

    indices: torch.Tensor                  # (n, max_nnz) int32, ids in [0, D)
    mask: torch.Tensor                     # (n, max_nnz) bool
    labels: Optional[torch.Tensor] = None  # (n,) float32 in {-1, +1}

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def nnz_per_row(self) -> torch.Tensor:
        """(n,) int32 valid-lane counts -- the kernels' ``counts``."""
        return self.mask.sum(dim=1, dtype=torch.int32)

    def nbytes(self) -> int:
        b = self.indices.numel() * 4 + self.mask.numel()
        if self.labels is not None:
            b += self.labels.numel() * 4
        return b


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int, value=0) -> np.ndarray:
    """``x`` padded with ``value`` along ``axis`` to a multiple of ``multiple``."""
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=value)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``device``; pinned + non_blocking for CUDA."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def from_lists(sets: Sequence[np.ndarray], labels: Optional[np.ndarray] = None,
               max_nnz: Optional[int] = None, lane_multiple: int = 128, *,
               device: DeviceLike = None) -> SparseBatch:
    """Build a SparseBatch from a list of index arrays; nnz is padded to a
    multiple of ``lane_multiple`` as in the reference."""
    dev = resolve_device(device)
    n = len(sets)
    if max_nnz is None:
        max_nnz = max((len(s) for s in sets), default=1) or 1
    max_nnz = ((max_nnz + lane_multiple - 1) // lane_multiple) * lane_multiple
    idx = np.zeros((n, max_nnz), np.int32)
    msk = np.zeros((n, max_nnz), bool)
    for i, s in enumerate(sets):
        m = min(len(s), max_nnz)
        idx[i, :m] = np.asarray(s[:m], np.int32)
        msk[i, :m] = True
    lab = None if labels is None else to_device(
        np.ascontiguousarray(labels, np.float32), dev)
    return SparseBatch(indices=to_device(idx, dev), mask=to_device(msk, dev),
                       labels=lab)


def to_dense(batch: SparseBatch, D: int) -> torch.Tensor:
    """Dense 0/1 matrix (n, D) float32.  Tests / small D only."""
    n, nnz = batch.indices.shape
    row = torch.arange(n, device=batch.device)[:, None]
    flat = (row * D + batch.indices.to(torch.int64)).reshape(-1)
    out = torch.zeros(n * D, dtype=torch.float32, device=batch.device)
    out.index_add_(0, flat, batch.mask.to(torch.float32).reshape(-1))
    return torch.clamp(out.reshape(n, D), max=1.0)


def slice_batch(batch: SparseBatch, start: int, size: int) -> SparseBatch:
    """Rows [start, start + size) of ``batch`` (views, no copy); as the
    reference's ``dynamic_slice``, a start past ``n - size`` is pulled
    back so the slice keeps ``size`` rows."""
    start = max(0, min(start, batch.n - size))
    return SparseBatch(
        indices=batch.indices[start:start + size],
        mask=batch.mask[start:start + size],
        labels=None if batch.labels is None
        else batch.labels[start:start + size])
