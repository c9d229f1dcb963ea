"""Logical sharding rules and shard placement (port of
``repro.sharding.rules``).

Model code names *logical* axes; under the mesh of ``set_mesh`` they
resolve to the mesh's physical axes:
  "batch"  -> all data-parallel axes present in the mesh ("pod", "data")
  "data"   -> the same set (FSDP weight sharding)
  "model"  -> the tensor/expert-parallel axis ("model")
  "all"    -> every mesh axis
  None     -> replicated

``spec`` builds a ``PartitionSpec`` from logical names.  ``constrain``
binds a layout to a tensor, as the reference's
``with_sharding_constraint`` does: without a mesh it returns ``x``
itself; under a process mesh (``launch.mesh.ProcessMesh``, training on a
mesh) the spec becomes DTensor placements and ``x`` (a DTensor, or a
plain tensor taken as replicated) is redistributed to them; an axis
whose extent does not divide its dim is dropped, exactly as the
reference drops it.  ``named_sharding`` is the ``NamedSharding`` of a
spec under the current mesh (None without one); ``NamedSharding.place``
puts a whole tensor under it, each rank keeping its chunk.  Chunks of
one dim over an axis tuple are numbered with the tuple's first axis
major, the reference's order (a ``_StridedShard`` where that is not the
mesh's order).

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

from repro_torch.launch.mesh import Mesh, ProcessMesh

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or
    None (replicated) -- a tuple, like the reference's.  As jax's does, it
    stores a one-axis tuple as the name and an empty one as None.  A leaf
    of the port's trees (``repro_torch.tree``), not a container."""

    _tree_leaf = True

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


def _drop_indivisible(shape, resolved, mesh) -> list:
    """The reference's rule: an entry whose extent does not divide its
    dim is dropped whole."""
    return [r if r is None or dim % _axis_size(mesh, r) == 0 else None
            for dim, r in zip(shape, resolved)]


def _greedy(shape, entries, mesh) -> list:
    """A parameter spec's literal axes, each kept while the extent so far
    divides the dim (the reference's launcher greedy-drops the rest); axes
    the mesh lacks are dropped."""
    out = []
    for dim, entry in zip(shape, entries):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        kept, size = [], 1
        for a in axes:
            if a in mesh.axis_names and a not in kept and \
                    dim % (size * mesh.shape[a]) == 0:
                kept.append(a)
                size *= mesh.shape[a]
        out.append(tuple(kept) or None)
    return out


def dim_axes(entries) -> list:
    """Each dim's mesh axes as a tuple, first axis major (() replicated)."""
    return [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
            for e in entries]


def placements_for(entries, mesh: ProcessMesh) -> list:
    """DTensor placements, one per mesh axis, of per-dim axis entries
    (each None, an axis or a tuple, first axis major)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    out = [Replicate() for _ in mesh.axis_names]
    for dim, axes in enumerate(dim_axes(entries)):
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx == sorted(idx):
            for i in idx:
                out[i] = Shard(dim)
        elif len(idx) == 2:
            # the minor axis comes first in the mesh: DTensor's strided
            # shard numbers the chunks major-axis first
            out[idx[1]] = _StridedShard(dim, split_factor=mesh.shape[axes[0]])
            out[idx[0]] = Shard(dim)
        else:
            raise NotImplementedError(f"dim {dim} over {axes}: more than "
                                      "two axes out of the mesh's order")
    return out


class Entries(tuple):
    """Each dim's mesh axes (a tuple, first major, or None): a leaf of the
    port's trees; slicing keeps the type."""

    _tree_leaf = True

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return Entries(out) if isinstance(i, slice) else out


def entries_of(placements, mesh: ProcessMesh, ndim: int) -> "Entries":
    """The inverse of ``placements_for``: each dim's axes, first major."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    major = [[] for _ in range(ndim)]
    minor = [[] for _ in range(ndim)]
    for a, p in zip(mesh.axis_names, placements):
        if isinstance(p, _StridedShard):
            minor[p.dim].append(a)
        elif isinstance(p, Shard):
            major[p.dim].append(a)
    return Entries(tuple(major[d] + minor[d]) or None for d in range(ndim))


def local_chunk(full: torch.Tensor, entries, mesh: ProcessMesh
                ) -> torch.Tensor:
    """This rank's chunk of a whole tensor under per-dim axis entries."""
    out = full
    for dim, axes in enumerate(dim_axes(entries)):
        if axes:
            size = full.shape[dim] // mesh.extent(axes)
            out = out.narrow(dim, mesh.index(axes) * size, size)
    return out


class NamedSharding:
    """A ``PartitionSpec`` of physical axis names bound to a mesh (the
    reference's ``jax.sharding.NamedSharding``).  ``greedy`` keeps, within
    a tuple, the axes whose extent so far divides the dim (parameter
    specs); otherwise an indivisible entry is dropped whole
    (``constrain``'s rule)."""

    def __init__(self, mesh, spec: PartitionSpec, greedy: bool = False):
        self.mesh, self.spec, self.greedy = mesh, PartitionSpec(*spec), greedy

    def entries(self, shape) -> list:
        parts = list(self.spec) + [None] * (len(shape) - len(self.spec))
        if self.greedy:
            return _greedy(shape, parts, self.mesh)
        literal = [tuple(a for a in axes if a in self.mesh.axis_names)
                   or None for axes in dim_axes(parts)]
        return _drop_indivisible(shape, literal, self.mesh)

    def placements(self, shape) -> list:
        return placements_for(self.entries(shape), self.mesh)

    def place(self, full: torch.Tensor):
        """``full`` (whole, the same on every rank) as a DTensor under
        this sharding: each rank keeps its chunk, on its device; nothing
        is communicated."""
        from torch.distributed.tensor import DTensor
        entries = self.entries(full.shape)
        chunk = local_chunk(full, entries, self.mesh)
        return DTensor.from_local(
            chunk.to(self.mesh.device).contiguous(), self.mesh.device_mesh,
            placements_for(entries, self.mesh), run_check=False,
            shape=full.shape, stride=full.contiguous().stride())

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Sharding constraint by logical axis names; ``x`` itself without a
    mesh (or under a retrieval ``Mesh``, whose positions are not ranks).

    Under a process mesh: ``x`` (a DTensor, or a plain tensor taken as
    replicated) redistributed to the spec's placements, dropping any axis
    whose extent does not divide its dim (e.g. 56 heads over a 16-way
    model axis), so model code never special-cases divisibility.
    """
    mesh = current_mesh()
    if not isinstance(mesh, ProcessMesh):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    entries = _drop_indivisible(x.shape, [_resolve(a, mesh) for a in axes],
                                mesh)
    entries += [None] * (x.dim() - len(entries))
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate() for _ in mesh.axis_names],
                               run_check=False)
    return x.redistribute(mesh.device_mesh, placements_for(entries, mesh))


def named_sharding(*axes) -> Optional[NamedSharding]:
    """The ``NamedSharding`` of ``spec(*axes)`` under the current mesh;
    None without one."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec(*axes))


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
