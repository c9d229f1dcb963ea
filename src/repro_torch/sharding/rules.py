"""Logical sharding rules and shard placement (port of
``repro.sharding.rules``).

Model code names *logical* axes; under the mesh of ``set_mesh`` they
resolve to the mesh's physical axes:
  "batch"  -> all data-parallel axes present in the mesh ("pod", "data")
  "data"   -> the same set (FSDP weight sharding)
  "model"  -> the tensor/expert-parallel axis ("model")
  "all"    -> every mesh axis
  None     -> replicated

``spec`` builds a ``PartitionSpec`` from logical names.  Binding a layout
to a tensor (``constrain``, ``named_sharding``) belongs to training on a
mesh, which is not ported: both raise.

The retrieval mesh adds a *placement* rule: ``place_shards`` maps S
``.idx`` shards onto the D positions of the mesh's ``"data"`` axis
round-robin (shard s -> position s mod D).  The mapping depends only on
the shard's index, so growing the tail of the shard list (a live append
or spill) never moves a placed shard -- what ``ShardedIndex.refresh``
relies on to keep unchanged shards' device corpora.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh

TRAINING_ON_A_MESH = ("binding a layout to a tensor is training on a mesh, "
                      "not ported: ROADMAP.md queue 1, 'training on a mesh'")

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or
    None (replicated) -- a tuple, like the reference's.  As jax's does, it
    stores a one-axis tuple as the name and an empty one as None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple)
            else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def current_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` this thread's current mesh inside the block."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def _resolve(axis, mesh: Mesh):
    if axis is None:
        return None
    if isinstance(axis, tuple):
        # tuple members are literal mesh axes ("data" does NOT expand to
        # pod+data here), except the logical names "batch" / "all"
        out = []
        for a in axis:
            if a in ("batch", "all"):
                r = _resolve(a, mesh)
                if isinstance(r, tuple):
                    out.extend(r)
                elif r is not None:
                    out.append(r)
            elif a in mesh.axis_names:
                out.append(a)
        return tuple(dict.fromkeys(out)) or None
    if axis == "all":
        return tuple(mesh.axis_names)
    if axis in ("batch", "data"):
        axes = tuple(n for n in ("pod", "data") if n in mesh.axis_names)
        return axes if axes else None
    if axis in mesh.axis_names:
        return axis
    return None


def spec(*axes) -> PartitionSpec:
    """``PartitionSpec`` of logical axis names under the current mesh
    (empty without one)."""
    mesh = current_mesh()
    if mesh is None:
        return PartitionSpec()
    return PartitionSpec(*[_resolve(a, mesh) for a in axes])


def _axis_size(mesh: Mesh, resolved) -> int:
    if resolved is None:
        return 1
    if isinstance(resolved, tuple):
        out = 1
        for r in resolved:
            out *= mesh.shape[r]
        return out
    return mesh.shape[resolved]


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Not ported (training on a mesh): raises."""
    raise NotImplementedError(f"constrain: {TRAINING_ON_A_MESH}")


def named_sharding(*axes):
    """Not ported (training on a mesh): raises."""
    raise NotImplementedError(f"named_sharding: {TRAINING_ON_A_MESH}")


# ---------------------------------------------------------------------------
# Shard placement (the retrieval mesh)
# ---------------------------------------------------------------------------

def data_axis_devices(mesh: Mesh, axis: str = "data"
                      ) -> Tuple[torch.device, ...]:
    """The device of each position along one named mesh axis.

    Collapses every other axis to its first coordinate, so a 2-D
    ``("data", "model")`` mesh yields one representative per
    data-parallel rank.  Positions may share a device.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
    i = mesh.axis_names.index(axis)
    devs = np.moveaxis(mesh.devices, i, 0)
    return tuple(devs.reshape(devs.shape[0], -1)[:, 0])


def place_shards(n_shards: int, mesh: Optional[Mesh] = None, *,
                 axis: str = "data") -> Optional[Tuple[torch.device, ...]]:
    """Round-robin shard -> position placement along the ``"data"`` axis:
    shard s lands on position ``s % D``.  Returns each shard's device, or
    None with no mesh (given or current).  A pure function of the shard
    index, so new tail shards never relocate an existing one."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    devs = data_axis_devices(mesh, axis)
    return tuple(devs[s % len(devs)] for s in range(n_shards))
