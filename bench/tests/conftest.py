"""CPU tests of the benchmark: run from the checkout's root with

    python -m pytest -q bench/tests

Cells run here at tiny sizes on the CPU through the whole harness, the
program's plain versions in place of its kernels; ``tiny`` shrinks a
cell's configuration and traffic by its driver's ``TINY``, nothing else.
No test file names a driver's size or its program call: each driver
declares its own, so a cell with a new driver is tested with no edit
here."""

import copy
import importlib
import io
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny(name: str, **traffic):
    """The cell ``name`` at a size the CPU runs in a fraction of a
    second; ``traffic`` overrides its traffic parameters further."""
    from bench import harness
    cell = harness.find_cell(name)
    cfg, tr = copy.deepcopy(cell.driver.TINY)
    cell.config.update(cfg)
    cell.traffic.update(tr, **traffic)
    return cell


def program_call(driver):
    """(owner, attribute name) of the call ``driver.PROGRAM_CALL`` names,
    ``"module:Class.method"``."""
    module, _, qualname = driver.PROGRAM_CALL.partition(":")
    *path, attr = qualname.split(".")
    owner = importlib.import_module(module)
    for name in path:
        owner = getattr(owner, name)
    return owner, attr


def execute(cell, *, seed=2**31 + 11, seconds=0.3, trace=False,
            control=False):
    """Run ``cell`` on the CPU; returns (result, stdout text, stderr)."""
    import torch
    from bench import harness
    out, err = io.StringIO(), io.StringIO()
    result = harness.execute(cell, seed=seed, seconds=seconds, trace=trace,
                             device=torch.device("cpu"),
                             t_start=time.perf_counter(), control=control,
                             out=out, err=err)
    return result, out.getvalue(), err.getvalue()

