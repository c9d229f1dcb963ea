"""The harness finds everything by name, the description keeps to its
contract, the generators repeat, and a run prints one result line."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import generator as gen
from bench import harness
from conftest import ROOT, execute, program_call, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry_and_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("bench/")
    assert 1 <= len(cfg["why"]) <= 200 and 1 <= len(cfg["source"]) <= 200
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert {"source", "assumed", "guarantees"} <= set(data)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_found_by_name(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["traffic"]) and w["chips"] == 1
    assert len(w["why"]) <= 200
    cell = harness.find_cell(name)
    assert cell.driver.run
    # the driver's own CPU test size and the call its faults are planted on
    cfg, tr = cell.driver.TINY
    assert set(cfg) <= set(cell.config) and set(tr) <= set(cell.traffic)
    owner, attr = program_call(cell.driver)
    assert callable(getattr(owner, attr))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no.such-cell")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    if "bound" in metric:
        keys.add("bound")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert 1 <= len(metric["layer"]) <= 200
        assert callable(harness.reader(metric["name"]))
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELL_NAMES


def test_layer_names_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert layers["device_idle_share"] == {"device"}
    assert layers["mfu"] == {"whole window"}


def test_same_seed_same_data():
    a = gen.SetStream(2**31 + 3, 0, 1_000, 2**24, [20, 60])
    b = gen.SetStream(2**31 + 3, 0, 1_000, 2**24, [20, 60])
    c = gen.SetStream(2**31 + 4, 0, 1_000, 2**24, [20, 60])
    rows = torch.arange(0, 1_000, 7)
    assert torch.equal(a.ids(rows), b.ids(rows))
    assert torch.equal(a.lengths(rows), b.lengths(rows))
    assert not torch.equal(a.ids(rows), c.ids(rows))
    ids = a.ids(rows)
    assert int(ids.min()) >= 0 and int(ids.max()) < 2**24


def test_lengths_are_one_set_in_seed_order():
    a = gen.row_lengths(1, 10_000, [1_864, 5_592])
    b = gen.row_lengths(2, 10_000, [1_864, 5_592])
    assert np.array_equal(np.sort(a), np.sort(b))
    assert not np.array_equal(a, b)
    assert abs(a.mean() - 3_728) < 1
    assert a.min() == 1_864 and a.max() == 5_592


def test_webspam_lengths_have_the_published_median_and_mean():
    """Table 1: nonzeros a row median 3,889 (mean 3,728)."""
    cfg = harness.read_json(harness.BENCH_DIR / "configs" /
                            "webspam-k500-b8.json")
    nnz = cfg["row_nnz"]
    a = gen.row_lengths(2**31 + 9, cfg["n_rows"], nnz["knots"])
    assert abs(a.mean() - nnz["mean"]) < 0.5
    assert abs(np.median(a) - nnz["median"]) <= 0.5
    assert a.min() == nnz["knots"][0] and a.max() == nnz["knots"][-1]
    assert gen.padded_width(max(nnz["knots"])) == 5_632


@pytest.mark.parametrize("knots", [[5], [9, 3], [-1, 4]])
def test_bad_knots_are_refused(knots):
    with pytest.raises(ValueError):
        gen.row_lengths(1, 10, knots)


def test_rows_made_again_alone_are_the_same():
    data = gen.SetStream(9, 0, 500, 2**30, [30, 90])
    idx, mask, lengths = data.batch(100, 200, "cpu")
    rows = torch.tensor([150, 101])
    again, _, _ = gen.padded(data.ids(rows), data.lengths(rows))
    assert torch.equal(again, idx[[50, 1]])


def test_coefficients_repeat():
    a = gen.coefficients(7, 3, "4u", 500)["a"]
    assert np.array_equal(a, gen.coefficients(7, 3, "4u", 500)["a"])
    assert a.max() < 2**31 - 1
    assert (gen.coefficients(7, 3, "2u", 500)["a2"] % 2 == 1).all()


@pytest.mark.parametrize("name", CELL_NAMES)
@pytest.mark.parametrize("trace", [False, True])
def test_result_is_the_last_line(name, trace):
    result, out, err = execute(tiny(name), trace=trace)
    last = out.strip().splitlines()[-1]
    parsed = json.loads(last)
    assert list(parsed)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(parsed)
    assert parsed["correct"] is True and parsed["failed"] == 0
    assert set(parsed["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    checks = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert len(checks) == len(parsed["checks"])
    assert err.strip().splitlines()[-len(checks):] == checks
    if trace:
        assert {"busy_s", "window_s"} <= set(parsed["device"])
        assert "breakdown" in parsed
    else:
        names = {m["name"] for m in harness.find_cell(name).end_to_end}
        assert set(parsed["metrics"]) == names
        for m in parsed["metrics"].values():
            assert m["value"] > 0


def test_a_run_without_a_card_exits_with_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELL_NAMES[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_trace_view_reduces_intervals():
    view = harness.TraceView(
        window=(0.0, 100.0), ranges={"a": [(0.0, 40.0)], "b": [(50.0, 90.0)]},
        device=[("k1", 10.0, 30.0), ("k2", 20.0, 45.0), ("k1", 60.0, 70.0)],
        launched=[(5.0, "k1", 20.0), (6.0, "k2", 25.0), (55.0, "k1", 10.0),
                  (95.0, "k3", 1.0)],
        host_spans=[], work={})
    assert view.busy_intervals() == [(10.0, 45.0), (60.0, 70.0)]
    assert view.busy_s == pytest.approx(45e-6)
    assert view.under("a") == [("k1", 20.0), ("k2", 25.0)]
    assert view.under("b") == [("k1", 10.0)]
    bd = view.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    # each gap goes to the range open on the host where it begins
    assert dict(bd["idle_gaps"]) == {
        "a": pytest.approx(10e-6), "harness": pytest.approx(15e-6),
        "b": pytest.approx(30e-6)}


def test_an_unlinked_activity_attributes_nothing():
    work = {"k": 64, "b": 8, "four_u": False, "rows": [100],
            "nonzeros": [4_000]}
    view = harness.TraceView(
        window=(0.0, 100.0), ranges={"engine.call": [(0.0, 40.0)]},
        device=[("k1", 10.0, 30.0)], launched=[(5.0, "k1", 20.0)],
        host_spans=[], work=work)
    share = harness.reader("signature_roofline_share.preprocess")
    assert share(view) > 0
    orphan = dataclasses.replace(view, unlinked=1)
    assert orphan.under("engine.call") is None
    assert share(orphan) is None
