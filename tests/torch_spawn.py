"""A pool of torch.distributed ranks for the multi-process port tests.

``RankPool(world)`` spawns ``world`` processes once (a module-scoped
fixture pays for the spawn once per file), each joined to one gloo
process group by a file rendezvous under a fresh temporary directory (no
port to collide between the suite's workers) and running torch on one
intra-op thread.  ``pool.run("module:function", *args)`` calls the
function in every rank with ``(rank, world, *args)`` and returns the
ranks' results in rank order.  A call that has not answered within its
timeout kills the whole group and fails the test, so a hung collective
never holds the suite; an exception in any rank fails it with that rank's
traceback.  Functions live in modules that import no JAX (the ranks
never load it).
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import tempfile
import traceback

import pytest

TIMEOUT = 90.0        # seconds a call may take before the group is killed


def _worker(rank: int, world: int, init_file: str, conn) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        target, args = msg
        try:
            mod, fn = target.split(":")
            out = getattr(importlib.import_module(mod), fn)(rank, world,
                                                            *args)
            conn.send((True, out))
        except BaseException:
            conn.send((False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 4):
        self.world = world
        self._dir = tempfile.TemporaryDirectory(prefix="rankpool_")
        ctx = mp.get_context("spawn")
        init_file = os.path.join(self._dir.name, "rendezvous")
        self._conns, self._procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, world, init_file, child),
                            daemon=True)
            p.start()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, target: str, *args, timeout: float = TIMEOUT) -> list:
        if not self._procs:
            pytest.fail("the rank pool was killed by an earlier timeout")
        for c in self._conns:
            c.send((target, args))
        out = []
        for r, c in enumerate(self._conns):
            if not c.poll(timeout):
                self.kill()
                pytest.fail(f"rank {r} gave no answer to {target} within "
                            f"{timeout} s: the group was killed")
            ok, value = c.recv()
            if not ok:
                errors = [value]
                for rest in self._conns[r + 1:]:
                    if rest.poll(timeout):
                        errors.append(rest.recv()[1])
                self.kill()
                pytest.fail(f"rank {r} failed in {target}:\n{errors[0]}")
            out.append(value)
        return out

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5)
        self._procs = []
        self._dir.cleanup()

    def close(self) -> None:
        if self._procs:
            for c in self._conns:
                c.send(None)
            for p in self._procs:
                p.join(30)
        self.kill()
