"""Device meshes (port of ``repro.launch.mesh``).

A ``Mesh`` is what ``jax.sharding.Mesh`` is to the reference: an array of
device *positions* with axis names, addressed by one controlling process.
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

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), on the first 256 / 512 CUDA devices; raises
    ``ValueError`` when the process has fewer -- always, in fact: a torch
    device index has 8 bits, so one process addresses at most 128 cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_debug_mesh(int(np.prod(shape)), axes=axes, shape=shape)


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
