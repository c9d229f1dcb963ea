"""A cell of a new kind joins the benchmark by new files and new entries
in ``BENCHMARK.json`` alone, and the CPU tests then cover it.

A copy of ``bench/`` and ``BENCHMARK.json`` gains a probe cell with a
configuration, a traffic mix, a driver, a reader and a plain file of its
own; no file of the copy that was there before is edited.  The copy's
harness, isolation and control tests then run in a fresh interpreter
and have to pass, the probe cell's cases among them."""

import json
import os
import shutil
import subprocess
import sys

from bench.harness import applies
from conftest import ROOT

CELL, CONFIG, TRAFFIC = "probe.cell", "probe-config", "probe-traffic"
DRIVER, READER = "probe_driver", "probe_calls.probe"
DRIVER_SOURCE = '''"""The preprocessing driver's run, under a name, a size and a program
call of its own."""

from bench.drivers.preprocess import run  # noqa: F401

TINY = ({"n_rows": 200, "k": 32, "row_nnz": {"knots": [10, 30, 40]}},
        {"chunk_rows": 100, "check_rows": 32, "trace_seconds": 0.2})
PROGRAM_CALL = "repro_torch.kernels.engine:SignatureEngine.packed_signatures"
'''
READER_SOURCE = '''"""Engine calls in the traced window."""


def read(view):
    calls = view.ranges.get("engine.call")
    return float(len(calls)) if calls else None
'''
PLAIN_SOURCE = '''"""A plain file: numpy, torch and typing only."""

import numpy as np


def rows(n):
    return np.arange(n)
'''
FILES = ["test_port_bench_harness.py", "test_port_bench_isolation.py",
         "test_port_bench_control.py"]


def add_probe(root):
    """Write the probe cell's files and append its entries."""
    def traffic_of(w):
        return json.loads(
            (root / "bench/traffic" / f"{w['traffic']}.json").read_text())

    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = next(w for w in bench["workloads"]
                if traffic_of(w)["driver"] == "preprocess")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == base["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    cfg["name"] = CONFIG
    (root / "bench/configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    traffic = dict(traffic_of(base), driver=DRIVER)
    (root / "bench/traffic" / f"{TRAFFIC}.json").write_text(
        json.dumps(traffic))
    (root / "bench/drivers" / f"{DRIVER}.py").write_text(DRIVER_SOURCE)
    (root / "bench/metrics" / f"{READER}.py").write_text(READER_SOURCE)
    (root / "bench/reference_probe.py").write_text(PLAIN_SOURCE)

    bench["configs"].append(dict(cfg_entry, name=CONFIG,
                                 file=f"bench/configs/{CONFIG}.json"))
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": TRAFFIC, "chips": 1,
                               "why": "a probe of a new driver"})
    # the base cell's end-to-end metrics, the probe's too
    for m in bench["end_to_end"]:
        if base["name"] in m.get("workloads", []):
            m["workloads"].append(CELL)
    rate = next(m for m in bench["end_to_end"] if m["name"] != "setup_s" and
                applies(m, base["name"]))
    bench["per_layer"].append({
        "name": READER, "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "probe", "moves": rate["name"],
        "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_a_new_kind_of_cell_joins_by_new_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    add_probe(tmp_path)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")

    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         *[f"bench/tests/{f}" for f in FILES]],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]

    passed = {ln.split(" ", 1)[1].strip() for ln in proc.stdout.splitlines()
              if ln.startswith("PASSED ")}
    harness, isolation, control = (f"bench/tests/{f}::" for f in FILES)
    want = {harness + f"test_config_entry_and_file[{CONFIG}]",
            harness + f"test_cell_found_by_name[{CELL}]",
            harness + f"test_metric_entry[{READER}]",
            isolation + f"test_no_jax_and_no_jax_package[drivers/{DRIVER}.py]",
            isolation + "test_plain_files_import_nothing_of_the_program"
                        "[reference_probe.py]",
            isolation + "test_a_run_loads_no_forbidden_module",
            control + f"test_control_is_not_correct[{CELL}]",
            control + f"test_sound_run_is_correct[{CELL}]"}
    want |= {harness + f"test_result_is_the_last_line[{t}-{CELL}]"
             for t in ("False", "True")}
    want |= {control + f"test_preprocess_faults_are_caught[{CELL}-{kind}]"
             for kind in ("unchanged", "half", "altered")}
    assert want <= passed, sorted(want - passed)
    # nothing that was there before the probe was edited, by it or the run
    assert all(p.read_bytes() == b for p, b in before.items())
