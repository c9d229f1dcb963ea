"""CPU tests of the benchmark: run from the checkout's root with

    python -m pytest -q bench/tests

Cells run here at tiny sizes on the CPU through the whole harness, the
program's plain versions in place of its kernels; ``tiny`` shrinks a
cell's configuration and traffic, nothing else."""

import io
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "preprocess": ({"n_rows": 300, "k": 64,
                    "row_nnz": {"knots": [20, 45, 60]}},
                   {"chunk_rows": 100, "check_rows": 64,
                    "trace_seconds": 0.2}),
}


def tiny(name: str, **traffic):
    """The cell ``name`` at a size the CPU runs in a fraction of a
    second; ``traffic`` overrides its traffic parameters further."""
    from bench import harness
    cell = harness.find_cell(name)
    cfg, tr = TINY[cell.traffic["driver"]]
    cell.config.update(cfg)
    cell.traffic.update(tr, **traffic)
    return cell


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


@pytest.fixture
def cells():
    from bench import harness
    return [w["name"] for w in harness.load_benchmark()["workloads"]]
