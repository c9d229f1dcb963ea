"""Step-atomic checkpointing with keep-N GC and resume (port of
``repro.train.checkpoint``).

Layout:  <dir>/step_00001234/  arrays.npz  meta.json
Writes go to ``<dir>/.tmp_step_xxx`` then ``os.replace`` (atomic on POSIX),
so a crash mid-write never corrupts the latest checkpoint.

Arrays are keyed by their tree paths (``repro_torch.tree``: ``params/w``,
``opt_state/m/w``, ``step``), the reference's keys, and bfloat16 is stored
as uint16 and listed under ``bf16_keys``, as the reference stores it: a
checkpoint written by either package restores in the other.  (``np.savez``
stamps zip times, so the files are not byte-identical; the arrays are.)

On a process mesh a tree holds DTensors: ``save`` gathers each one whole
(``full_tensor()``) on every rank, in leaf order, on the calling thread;
rank 0 writes, then every rank meets at a barrier -- so a meshed save
holds exactly the arrays an unmeshed save of the same state does, and
loads in either package.  ``save_async`` gathers first and writes in its
thread.  ``restore(..., shardings=)`` loads whole arrays and places each
under its sharding (``rules.NamedSharding``): the elastic-rescale entry
point (``train.elastic``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import map_with_path, path_leaves, tree_map

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _whole(tree):
    """DTensor leaves gathered whole (every rank, leaf order)."""
    return tree_map(lambda x: x.full_tensor() if _is_dtensor(x) else x, tree)


def _writer() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Save a tree checkpoint. Returns the final directory path.  A tree
    with DTensor leaves is gathered whole on every rank; rank 0 writes and
    all ranks meet at a barrier."""
    from repro_torch.tree import tree_leaves
    if any(_is_dtensor(x) for x in tree_leaves(tree)):
        import torch.distributed as dist
        whole = _whole(tree)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if _writer():
            final = save(ckpt_dir, step, whole, keep=keep,
                         extra_meta=extra_meta)
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}_{os.getpid()}")
    final = os.path.join(ckpt_dir, name)
    os.makedirs(tmp, exist_ok=True)

    leaves = path_leaves(tree)
    arrays = {key: _host(leaf) for key, leaf in leaves}
    dtypes = {key: "bfloat16" for key, leaf in leaves if _bf16(leaf)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "n_arrays": len(arrays),
            "bf16_keys": dtypes, **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3
               ) -> threading.Thread:
    """Fire-and-forget checkpoint write.  The host copy happens up front
    (bfloat16 leaves stay tensors on the host), so the training loop can go
    on updating its tensors in place."""
    host_tree = tree_map(lambda x: x.detach().cpu().clone()
                         if isinstance(x, torch.Tensor) else np.asarray(x),
                         _whole(tree))
    t = threading.Thread(target=save if _writer() else (lambda *a, **k: None),
                         args=(ckpt_dir, step, host_tree),
                         kwargs={"keep": keep}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``template``: each leaf becomes a
    tensor of the saved dtype on the device of the template's leaf (the
    CPU where the template's leaf is not a tensor).  With ``shardings``
    (a tree of the template's structure of ``NamedSharding`` or None),
    each whole array is placed under its sharding, a DTensor; a template
    of DTensors and no ``shardings`` keeps each leaf's placements."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    bf16_keys = meta.get("bf16_keys", {})
    shard_of = (dict(path_leaves(shardings)) if shardings is not None
                else {})
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def load(key, leaf):
            arr = data[key]
            if key in bf16_keys:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            shd = shard_of.get(key)
            if shd is None and _is_dtensor(leaf):
                shd = _sharding_of(leaf)
            if shd is not None:
                return shd.place(t)
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            return t.to(dev)

        return map_with_path(load, template), step


def _sharding_of(leaf):
    """The ``NamedSharding`` a DTensor leaf of the template is placed
    under (its process mesh must be the current one)."""
    from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                            current_mesh, entries_of)
    mesh = current_mesh()
    if getattr(mesh, "device_mesh", None) is not leaf.device_mesh:
        raise ValueError("restoring a DTensor leaf needs its process mesh "
                         "current (set_mesh)")
    return NamedSharding(mesh, PartitionSpec(*entries_of(
        leaf.placements, mesh, leaf.dim())))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1)) for d in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
