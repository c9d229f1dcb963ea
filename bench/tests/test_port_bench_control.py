"""The comparison that decides ``correct`` fails where it has to: the
control (the reference in the program's place, one step below the
configuration's precision) and each fault a cell can have, planted in
the program underneath a run that is otherwise whole.  One chip: no
cell has an exchange between chips to leave out.

The control and the sound run cover every cell of ``BENCHMARK.json``.
The faults here are planted on ``SignatureEngine.packed_signatures``
and run in every cell whose driver names that call as its
``PROGRAM_CALL``; a driver that names another call brings its own fault
tests in a file of its own."""

import pytest

from bench import harness
from bench.harness import passes
from conftest import execute, program_call, tiny
from repro_torch.kernels.engine import PackedSignatures

CELL_NAMES = [w["name"] for w in harness.load_benchmark()["workloads"]]
ENGINE_CALL = "repro_torch.kernels.engine:SignatureEngine.packed_signatures"
ENGINE_CELLS = [n for n in CELL_NAMES if getattr(
    harness.find_cell(n).driver, "PROGRAM_CALL", None) == ENGINE_CALL]
# every row of every chunk kept and checked, so one altered word shows
WHOLE = {"keep_per_chunk": 100, "check_rows": 10**6}


def failed(result):
    return sorted(n for n, c in result["checks"].items() if not passes(c))


@pytest.mark.parametrize("name", CELL_NAMES)
def test_control_is_not_correct(name):
    result, _, err = execute(tiny(name), control=True)
    assert result["correct"] is False
    assert failed(result)
    assert "check " in err


def _engine_fault(kind, orig):
    last = {}

    def broken(self, batch):
        out = orig(self, batch)
        data = out.data.clone()
        if kind == "unchanged":
            data = last.get("data", data)
            last.setdefault("data", out.data)
        elif kind == "half":
            data[data.shape[0] // 2:] = 0
        elif kind == "altered":
            data[data.shape[0] // 2, 0] ^= 1
        return PackedSignatures(data, out.k, out.b, out.sentinel)
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ENGINE_CELLS)
def test_preprocess_faults_are_caught(monkeypatch, name, kind):
    cell = tiny(name, **WHOLE)
    owner, attr = program_call(cell.driver)
    monkeypatch.setattr(owner, attr, _engine_fault(kind, getattr(owner, attr)))
    result, _, _ = execute(cell)
    assert result["correct"] is False
    assert "rows_wrong" in failed(result)


def test_the_engine_faults_run_in_some_cell():
    """A misspelt ``ENGINE_CALL`` would leave the fault tests with no
    cell, which pytest reports as a skip, not as a failure."""
    assert ENGINE_CELLS


@pytest.mark.parametrize("name", CELL_NAMES)
def test_sound_run_is_correct(name):
    result, _, _ = execute(tiny(name, **WHOLE))
    assert result["correct"] is True, result["checks"]
