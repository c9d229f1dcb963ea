"""The comparison that decides ``correct`` fails where it has to: the
control (the reference in the program's place, one step below the
configuration's precision) and each fault a cell can have, planted in
the program underneath a run that is otherwise whole.  One chip: no
cell has an exchange between chips to leave out."""

import pytest

from bench.harness import passes
from conftest import execute, tiny
from repro_torch.kernels.engine import PackedSignatures, SignatureEngine

PREPROCESS = ["preprocess.webspam-4u", "preprocess.webspam-2u"]
# every row of every chunk kept and checked, so one altered word shows
WHOLE = {"keep_per_chunk": 100, "check_rows": 10**6}


def failed(result):
    return sorted(n for n, c in result["checks"].items() if not passes(c))


@pytest.mark.parametrize("name", PREPROCESS)
def test_control_is_not_correct(name):
    result, _, err = execute(tiny(name), control=True)
    assert result["correct"] is False
    assert failed(result)
    assert "check " in err


def _engine_fault(kind):
    orig = SignatureEngine.packed_signatures
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
@pytest.mark.parametrize("name", PREPROCESS)
def test_preprocess_faults_are_caught(monkeypatch, name, kind):
    monkeypatch.setattr(SignatureEngine, "packed_signatures",
                        _engine_fault(kind))
    result, _, _ = execute(tiny(name, **WHOLE))
    assert result["correct"] is False
    assert "rows_wrong" in failed(result)


@pytest.mark.parametrize("name", PREPROCESS)
def test_sound_run_is_correct(name):
    result, _, _ = execute(tiny(name, **WHOLE))
    assert result["correct"] is True, result["checks"]
