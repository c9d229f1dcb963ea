"""Device meshes (port of ``repro.launch.mesh``).

Two kinds of mesh, with the same ``axis_names`` / ``shape`` surface, so
that the sharding rules (``spec``, ``_resolve``, ``moe.ep_layout``) serve
both (and a third, ``AbstractMesh``, of that surface alone):

  * ``Mesh`` -- what ``jax.sharding.Mesh`` is to the reference's
    retrieval fan-out: an array of device *positions* with axis names,
    addressed by one controlling process (``make_debug_mesh``);
  * ``ProcessMesh`` -- training on a mesh: every position is a rank of a
    ``torch.distributed`` process group, one process per card (NCCL
    refuses two ranks on one card; gloo runs ranks on the CPU), carrying
    a ``torch.distributed.device_mesh.DeviceMesh`` of the same axis names
    and shape, and a process group per set of axes
    (``make_process_mesh``, ``make_production_mesh``).

  * ``AbstractMesh`` -- a shape and axis names, no device and no process
    group (``abstract_mesh``): what the dry run (``launch.dryrun``)
    places the production shardings over and the roofline
    (``roofline.analytic``) sizes collectives by, on a machine of any
    size, as the reference lowers over forced host devices.

``fake_world(shape, axes)`` joins this process, as rank 0, to a world of
``prod(shape)`` ranks on torch's ``"fake"`` process-group backend (whose
collectives return at once and move nothing) and yields that rank's
``ProcessMesh`` on the meta device (``fake_process_mesh``): the dry run
traces a step there (``roofline.traced``), each rank's shards at their
production shapes, on one machine.  The group is destroyed on the way
out, so the caller ends with no process group, as it began.

Production shapes: a single pod (16, 16) over ("data", "model"), and
multi-pod (2, 16, 16) over ("pod", "data", "model") -- the "pod" axis an
outer data-parallel axis.

A position is a rank of the mesh, not a device: ``make_debug_mesh`` takes
an explicit ``devices=`` list that may name one device several times (8
positions on the CPU in the tests, 4 on one card), as the reference's
tests force 8 host devices.  Code that places work on a mesh therefore
keys by position along an axis, never by ``torch.device`` equality.

Defined as functions, so importing this module touches no device.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """An ndarray of ``torch.device`` positions with one name per axis.

    ``shape`` maps each axis name to its extent, in axis order, as the
    reference's ``Mesh.shape`` does.  A CUDA position without an index
    is pinned to the current device when the mesh is built.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        for i, d in enumerate(arr.reshape(-1)):
            flat[i] = _position(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({axes}; devices {devs})"


def _position(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class AbstractMesh:
    """A mesh of shape only: ``axis_names``, ``shape`` (each axis name to
    its extent, in axis order) and ``size``; no device, no rank."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        dims = tuple(int(n) for n in shape)
        if len(dims) != len(self.axis_names) or min(dims, default=1) < 1:
            raise ValueError(f"a mesh of shape {dims} needs one positive "
                             f"extent per axis of {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        self._dims = dims

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._dims))

    @property
    def size(self) -> int:
        return int(np.prod(self._dims))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"AbstractMesh({axes})"


def abstract_mesh(shape: Sequence[int],
                  axes: Sequence[str] = ("data", "model")) -> AbstractMesh:
    """A shape-only mesh: no world-size check, nothing joined."""
    return AbstractMesh(shape, axes)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device: "DeviceLike" = None) -> "ProcessMesh":
    """The process mesh (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model"), over a world of 256 / 512 ranks (one
    card each, from ``torchrun``); raises ``ValueError`` naming the
    world's size otherwise."""
    shape, axes = production_shape(multi_pod)
    need = int(np.prod(shape))
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(f"mesh shape {shape} needs {need} devices (one "
                         f"rank each), the world has {world}")
    return make_process_mesh(shape, axes, device=device)


def make_debug_mesh(n_devices: int = 1, *,
                    axes: Sequence[str] = ("data", "model"),
                    shape: Optional[Tuple[int, ...]] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A small mesh of ``n_devices`` positions (tests, one-box serving).

    Positions are the first ``n_devices`` of ``devices`` -- by default
    the CUDA devices ``cuda:0 ... cuda:n-1``; an explicit list may repeat
    a device.  ``shape`` fixes the extent per axis (it must multiply to
    ``n_devices``); the default puts every position on the LAST axis,
    e.g. ``(1, n)`` over ("data", "model"), while ``axes=("data",)``
    builds the ``(n,)`` mesh the retrieval fan-out places shards on.
    Raises ``ValueError`` when fewer devices are given or present than
    the shape needs.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devs = list(devices)[:n_devices]
    if shape is None:
        shape = (1,) * (len(axes) - 1) + (n_devices,)
    need = int(np.prod(shape))
    if need != n_devices or len(devs) < need:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, "
                         f"asked for {n_devices}, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes))


# ---------------------------------------------------------------------------
# The process mesh (training on a mesh)
# ---------------------------------------------------------------------------

class ProcessMesh:
    """A mesh whose positions are the ranks of the default process group,
    laid out row-major over ``axis_names`` (rank r at the coordinates of r
    in ``shape``), as ``jax.sharding.Mesh`` lays devices out.

    ``device`` is this rank's device; ``device_mesh`` the
    ``DeviceMesh`` of the same names and shape (what DTensors are placed
    on); ``coords`` this rank's index along each axis.  ``group(axes)``
    is the process group of the ranks that differ from this one only
    along ``axes`` (built for every set of axes up front: every rank must
    create every group, in one order); ``index(axes)`` this rank's
    position in it with the first axis of ``axes`` major -- the
    reference's numbering of an axis tuple, which may differ from the
    group's own (ascending rank) order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        dims = tuple(int(n) for n in shape)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {dims} needs {len(dims)} "
                             f"axis names, got {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        self.world = dist.get_world_size()
        if int(np.prod(dims)) != self.world:
            raise ValueError(f"mesh shape {dims} needs {int(np.prod(dims))} "
                             f"ranks, the world has {self.world}")
        from torch.distributed.device_mesh import DeviceMesh
        self.rank = dist.get_rank()
        self.device = device
        self.ranks = np.arange(self.world).reshape(dims)
        self.device_mesh = DeviceMesh(device.type, torch.as_tensor(self.ranks),
                                      mesh_dim_names=self.axis_names)
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, dims))))
        self._groups: Dict[Tuple[str, ...], Tuple[object, Tuple[int, ...]]] = {}
        for n in range(1, len(dims) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes):
        """Every coset of ``axes`` becomes a group (all ranks call
        ``new_group`` for each, in one order); keep this rank's."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        arr = np.transpose(self.ranks, rest + keep).reshape(
            -1, int(np.prod([self.ranks.shape[i] for i in keep])))
        mine = None
        for row in arr:
            ranks = sorted(int(r) for r in row)
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (g, tuple(ranks))
        return mine

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return self.world

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def extent(self, axes) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        n = 1
        for a in axes:
            n *= self.ranks.shape[self.axis_names.index(a)]
        return n

    def group(self, axes):
        """The process group along ``axes`` (in any order)."""
        return self._groups[self._key(axes)][0]

    def group_ranks(self, axes) -> Tuple[int, ...]:
        """The global ranks of ``group(axes)``, in its (ascending) order."""
        return self._groups[self._key(axes)][1]

    def index(self, axes) -> int:
        """This rank's position along ``axes``, the first axis major."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        out = 0
        for a in axes:
            out = out * self.shape[a] + self.coords[a]
        return out

    def order(self, axes) -> Tuple[int, ...]:
        """For each member of ``group(axes)`` (in group order), its
        position along ``axes`` with the first axis major: the permutation
        from the group's order to the reference's numbering."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = self.ranks.shape
        out = []
        for r in self.group_ranks(axes):
            c = dict(zip(self.axis_names, np.unravel_index(r, dims)))
            idx = 0
            for a in axes:
                idx = idx * self.shape[a] + int(c[a])
            out.append(idx)
        return tuple(out)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ProcessMesh({axes}; rank {self.rank} on {self.device})"


def init_process_group(device: DeviceLike = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), or,
    without it, a group of one rank on an in-process store.  ``cuda``
    means NCCL, with rank r on card ``LOCAL_RANK``; ``cpu`` means gloo.
    There is no fallback from one to the other.  Returns this rank's
    device; a group that exists already is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        _PROCESS_MESHES.clear()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, device_id=dev if dev.type == "cuda" else None)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dev


_PROCESS_MESHES: Dict[tuple, ProcessMesh] = {}


def fake_process_mesh(shape: Sequence[int],
                      axes: Sequence[str] = ("data", "model"),
                      device: DeviceLike = "meta") -> ProcessMesh:
    """Rank 0's ``ProcessMesh`` of ``shape`` over the current world, which
    must be a ``"fake"`` one of ``prod(shape)`` ranks (``fake_world``);
    its tensors live on ``device`` (the meta device: shapes only).  Not
    cached, unlike ``make_process_mesh``'s."""
    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise ValueError("fake_process_mesh needs a 'fake' process group "
                         "(fake_world)")
    return ProcessMesh(shape, axes, torch.device(device))


@contextlib.contextmanager
def fake_world(shape: Sequence[int], axes: Sequence[str] = ("data", "model"),
               device: DeviceLike = "meta"):
    """This process as rank 0 of a ``"fake"`` world of ``prod(shape)``
    ranks, yielding ``fake_process_mesh(shape, axes, device)``; the group
    is destroyed on exit.  Raises ``RuntimeError`` if a process group
    exists already (one per process: run it in a child process)."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists in this process; a fake "
                           "world needs a process without one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield fake_process_mesh(shape, axes, device)
    finally:
        dist.destroy_process_group()


def make_process_mesh(shape: Optional[Sequence[int]] = None,
                      axes: Sequence[str] = ("data", "model"), *,
                      device: DeviceLike = None) -> ProcessMesh:
    """A ``ProcessMesh`` over the process group (joined first if it is not
    yet: ``init_process_group``).  The default shape puts every rank on
    the LAST axis, ``(1, world)`` over ("data", "model"): the reference's
    ``make_debug_mesh(len(jax.devices()))``.  A mesh of one shape, axes
    and device is built once per process group (its groups with it);
    every rank must ask for the same meshes in the same order."""
    dev = init_process_group(device)
    world = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axes) - 1) + (world,)
    key = (tuple(shape), tuple(axes), str(dev))
    if key not in _PROCESS_MESHES:
        _PROCESS_MESHES[key] = ProcessMesh(shape, axes, dev)
    return _PROCESS_MESHES[key]
