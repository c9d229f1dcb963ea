"""Port parity for the multi-pod dry run (``repro_torch.launch.dryrun``)
and the analytic roofline (``repro_torch.roofline.analytic``,
``roofline.analysis.Roofline`` / ``analyze``) against the JAX package:

  * ``estimate`` == ``repro.roofline.analytic.estimate`` exactly (FLOPs,
    bytes, collective bytes and every breakdown entry) on every arch x
    cell the archs do not skip, on 16x16 and 2x16x16, published and smoke;
  * the per-GPU bytes of parameters, optimizer state and inputs == the
    reference dry run's placement (``_to_named`` + ``shard_shape``) on the
    same cells and meshes, the four anchors of the published configs
    among them, and a cell where the launcher's placement rule differs;
  * ``Roofline.finalize`` == the reference's field by field with the TPU
    constants patched in;
  * the CLI and the report on a machine without a card, every ok record
    carrying the traced step's temp and seconds.

The placement and estimate checks take the placed bytes
(``dryrun.place_cell``) and the analytic roofline (``analysis.analyze``
without a trace); the traced step has its own tests
(``test_torch_traced.py``).

The reference side runs in a subprocess: importing ``repro.launch.dryrun``
forces 512 host devices and initialises JAX's backend at import, which
this test process must not inherit.  Its meshes are
``jax.sharding.AbstractMesh``es with Auto axes (``jax.make_mesh`` builds
Explicit axes, which the reference's dry run cannot lower on).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.roofline import analysis as j_analysis
from repro_torch.configs import all_archs, cells_for, is_skipped
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, init_inputs
from repro_torch.roofline import analysis, hardware
from repro_torch.roofline.analytic import estimate
from repro_torch.sharding.rules import NamedSharding
from repro_torch.sharding.rules import PartitionSpec as P
from repro_torch.tree import path_leaves, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port test module runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, c.name) for a in sorted(all_archs()) for c in cells_for(a)
         if not is_skipped(a, c.name)]
MESHES = ("16x16", "2x16x16")

_ORACLE = r"""
import json, math, sys
import numpy as np
import jax
from jax.sharding import AbstractMesh, AxisType
from repro.launch import dryrun as jd
from repro.launch import steps as js
from repro.roofline.analytic import estimate

def mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

def placed(m, specs, avals):
    named = jd._to_named(m, specs, avals)
    return sum(math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
               for s, a in zip(jax.tree_util.tree_leaves(named),
                               jax.tree_util.tree_leaves(avals)))

out = {}
for arch, cell in json.loads(sys.argv[1]):
    for smoke in (False, True):
        prog = js.build_cell(arch, cell, smoke=smoke)
        for mp in (False, True):
            m = mesh(mp)
            rec = {"estimate": estimate(prog, m),
                   "params": placed(m, prog.param_specs, prog.param_avals),
                   "inputs": placed(m, prog.input_specs_tree,
                                    prog.input_avals)}
            if prog.opt_avals is not None:
                rec["opt_state"] = placed(m, prog.opt_specs, prog.opt_avals)
            key = f"{arch}|{cell}|{int(smoke)}|{'2x16x16' if mp else '16x16'}"
            out[key] = rec
print(json.dumps(out))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), **extra)
    return env


@pytest.fixture(scope="module")
def oracle():
    """The reference's estimates and placed bytes of every cell, smoke and
    published, on both meshes (one subprocess)."""
    out = subprocess.run(
        [sys.executable, "-c", _ORACLE, json.dumps(CELLS)],
        env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(name):
    return dryrun.production_mesh(multi_pod=name == "2x16x16")


_PLACED = {}


def _placed(arch, cell, smoke, mesh):
    key = (arch, cell, smoke, mesh)
    if key not in _PLACED:
        prog = build_cell(arch, cell, smoke=smoke, device="cpu")
        _PLACED[key] = dryrun.place_cell(prog, _mesh(mesh))
    return _PLACED[key]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch,cell", CELLS)
def test_estimate_matches_reference(oracle, arch, cell, smoke):
    prog = build_cell(arch, cell, smoke=smoke, device="cpu")
    for mesh in MESHES:
        want = oracle[f"{arch}|{cell}|{int(smoke)}|{mesh}"]["estimate"]
        got = estimate(prog, _mesh(mesh))
        assert got == want, (arch, cell, smoke, mesh)
        roof = analysis.analyze(prog, _mesh(mesh), smoke=smoke)
        assert roof.coll_breakdown["analytic"] == want["coll_breakdown"]
        assert roof.hlo_flops_per_chip == want["flops"]
        assert roof.hlo_bytes_per_chip == want["bytes"]
        assert roof.coll_bytes_per_chip == want["coll"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch,cell", CELLS)
def test_placed_bytes_match_reference(oracle, arch, cell, smoke):
    for mesh in MESHES:
        want = oracle[f"{arch}|{cell}|{int(smoke)}|{mesh}"]
        got = _placed(arch, cell, smoke, mesh)["args"]
        groups = [g for g in ("params", "opt_state", "inputs") if g in want]
        assert sorted(got) == sorted(groups), (arch, cell)
        for g in groups:
            assert got[g] == want[g], (arch, cell, smoke, mesh, g)
        assert sum(got.values()) == sum(want[g] for g in groups)


ANCHORS = {   # bytes a GPU of parameters + optimizer state + inputs
    ("wide-deep", "train_batch"): (360_964_272, 359_571_632),
    ("deepseek-7b", "train_4k"): (764_469_252, 514_555_908),
    ("deepseek-7b", "decode_32k"): (8_205_852_708, 4_129_390_612),
    ("gatedgcn", "minibatch_lg"): (30_947_348, 18_109_596),
}


@pytest.mark.parametrize("arch,cell", sorted(ANCHORS))
def test_anchor_cells(oracle, arch, cell):
    for mesh, want in zip(MESHES, ANCHORS[(arch, cell)]):
        ref = oracle[f"{arch}|{cell}|0|{mesh}"]
        assert sum(v for k, v in ref.items() if k != "estimate") == want
        assert sum(_placed(arch, cell, False, mesh)["args"].values()) == want


def test_placement_rule_is_not_the_launchers():
    """deepseek-7b's parameters on 2x16x16: the dry run widens a bare
    "data" to ("pod", "data") and pops from the right; the launcher's
    greedy rule reads "data" literally."""
    mesh = _mesh("2x16x16")
    prog = build_cell("deepseek-7b", "decode_32k", device="cpu")
    shapes, specs = prog.param_shapes(), prog.param_specs
    spec_of = dict(path_leaves(specs))
    greedy = 0
    for path, t in path_leaves(shapes):
        ents = NamedSharding(mesh, spec_of[path], greedy=True).entries(
            t.shape)
        greedy += math.prod(
            d // math.prod(mesh.shape[a] for a in (e or ()))
            for d, e in zip(t.shape, ents)) * t.element_size()
    got = _placed("deepseek-7b", "decode_32k", False, "2x16x16")
    assert got["args"]["params"] == 102_858_752
    assert greedy == 152_788_992


def test_placement_resolves_as_the_reference():
    m2, m3 = _mesh("16x16"), _mesh("2x16x16")
    assert dryrun.placement(m3, P("data", "model"), (64, 32)) == (
        ("pod", "data"), "model")
    # "data" inside a tuple stays literal; "batch" is every data axis
    assert dryrun.placement(m3, P(("data", "model")), (512,)) == (
        ("data", "model"),)
    assert dryrun.placement(m3, P(("batch", "model")), (512,)) == (
        ("pod", "data", "model"),)
    assert dryrun.placement(m3, P("all"), (1024,)) == (
        ("pod", "data", "model"),)
    # popped from the right until the dim divides
    assert dryrun.placement(m3, P(("model", "data")), (16,)) == ("model",)
    assert dryrun.placement(m3, P("batch"), (16,)) == ("pod",)
    assert dryrun.placement(m2, P("batch"), (8,)) == (None,)
    # axes the mesh lacks are dropped; missing entries replicate
    assert dryrun.placement(m2, P("pod", None), (4, 4, 4)) == (
        None, None, None)
    assert dryrun.local_shape(m3, P("data", "model"), (64, 32, 3)) == (
        2, 2, 3)


def test_abstract_mesh():
    m = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512 and m.axis_names == ("pod", "data", "model")
    assert list(m.shape) == ["pod", "data", "model"]
    with pytest.raises(ValueError):
        abstract_mesh((16,), ("data", "model"))
    with pytest.raises(ValueError):
        abstract_mesh((4, 4), ("data", "data"))
    # the launcher's production mesh still wants its 256 / 512 ranks
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()


@pytest.mark.parametrize("family_cell", [
    ("deepseek-7b", "train_4k"), ("deepseek-v3-671b", "decode_32k"),
    ("llama4-scout-17b-a16e", "prefill_32k"), ("gatedgcn", "ogb_products"),
    ("autoint", "train_batch"), ("mind", "retrieval_cand")])
def test_roofline_matches_reference_on_tpu_constants(monkeypatch,
                                                     family_cell):
    """With the reference's TPU constants patched in (one peak, the ICI
    rate for the link), ``finalize`` == the reference's field by field."""
    monkeypatch.setattr(hardware, "PEAK_FLOPS_BF16", 197e12)
    monkeypatch.setattr(hardware, "PEAK_FLOPS_F32", 197e12)
    monkeypatch.setattr(hardware, "HBM_BW", 819e9)
    monkeypatch.setattr(hardware, "NET_BW", 50e9)
    monkeypatch.setattr(hardware, "NVLINK_BW", 50e9)
    arch, cell = family_cell
    prog = build_cell(arch, cell, device="cpu")
    for mesh in MESHES:
        m = _mesh(mesh)
        est = estimate(prog, m)
        args = dict(arch=arch, cell=cell, mesh=mesh, chips=m.size,
                    hlo_flops_per_chip=est["flops"],
                    hlo_bytes_per_chip=est["bytes"],
                    coll_bytes_per_chip=est["coll"],
                    coll_breakdown={}, model_flops=1.7e15)
        want = j_analysis.Roofline(**args).finalize()
        got = analysis.Roofline(**args, family=prog.family).finalize()
        for f in ("compute_s", "memory_s", "collective_s", "bottleneck",
                  "useful_flop_frac", "peak_fraction"):
            assert getattr(got, f) == getattr(want, f), (f, mesh)
        assert got.row() == want.row()
        assert got.link == "net" and got.link_bw == 50e9


def test_roofline_on_h100_constants():
    """bfloat16 peak for the LM family, float32's for the others; the link
    by the mesh's size; one GPU crosses none."""
    lm = build_cell("deepseek-7b", "train_4k", device="cpu")
    gnn = build_cell("gatedgcn", "minibatch_lg", device="cpu")
    for prog, peak in ((lm, 989e12), (gnn, 67e12)):
        for shape, link, bw in (((16, 16), "net", 50e9),
                                ((1, 8), "nvlink", 450e9),
                                ((2, 4), "nvlink", 450e9),
                                ((1, 1), "none", None)):
            m = abstract_mesh(shape)
            r = analysis.analyze(prog, m)
            est = estimate(prog, m)
            assert r.compute_s == est["flops"] / peak
            assert r.memory_s == est["bytes"] / 3.35e12
            assert r.link == link and r.link_bw == bw
            assert r.collective_s == (est["coll"] / bw if bw else 0.0)
            assert r.step_s == max(r.compute_s, r.memory_s, r.collective_s)
            assert r.coll_breakdown == {
                "analytic": est["coll_breakdown"],
                "parsed_hlo_once_per_loop": None, "raw_hlo": None}
            assert r.mesh == "x".join(map(str, shape))
            assert r.chips == math.prod(shape)


def test_no_tpu_constant_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "16 * 2**30", "ICI_BW"):
            assert const not in text, (path, const)


_SERVE = [(a, c) for a, c in CELLS
          if build_cell(a, c, smoke=True, device="cpu").optimizer is None]


@pytest.mark.parametrize("arch,cell", _SERVE)
def test_output_bytes_are_the_steps_outputs(arch, cell):
    """At (1, 1) and smoke, a serving step's outputs on the CPU have the
    bytes the dry run places (a decode's cache aliased)."""
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    inputs = init_inputs(prog, gen)
    out = prog.step(model, inputs)
    rec = dryrun.run_cell(arch, cell, smoke=True,
                          mesh=abstract_mesh((1, 1)))["memory"]
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out))
    assert rec["output_bytes"] == nbytes
    if prog.kind == "lm_decode":
        cache = sum(t.numel() * t.element_size()
                    for t in tree_leaves(inputs["cache"]))
        assert rec["alias_bytes"] == cache
    else:
        assert rec["alias_bytes"] == 0


@pytest.mark.parametrize("arch,cell", [
    ("wide-deep", "train_batch"), ("autoint", "train_batch"),
    ("din", "train_batch"), ("mind", "train_batch"),
    ("gatedgcn", "full_graph_sm"), ("gatedgcn", "molecule"),
    ("gatedgcn", "minibatch_lg"), ("yi-34b", "train_4k"),
    ("deepseek-7b", "decode_32k")])
def test_args_bytes_are_the_launchers_tensors(arch, cell):
    """At (1, 1) and smoke, the tensors the launcher's own functions build
    (``init_params``, ``optimizer.init``, ``init_inputs``) hold exactly
    the dry run's ``args_bytes`` in ``args_leaves`` leaves, and a train
    step's outputs are the parameters, the state and one float32."""
    prog = build_cell(arch, cell, smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    trees = [model.params(), init_inputs(prog, gen)]
    if prog.optimizer is not None:
        trees.append(prog.optimizer.init(trees[0]))
    leaves = [t for tree in trees for t in tree_leaves(tree)]
    rec = dryrun.run_cell(arch, cell, smoke=True,
                          mesh=abstract_mesh((1, 1)))["memory"]
    assert rec["args_bytes"] == sum(t.numel() * t.element_size()
                                    for t in leaves)
    assert rec["args_leaves"] == len(leaves)
    if prog.optimizer is not None:
        assert rec["output_bytes"] == rec["alias_bytes"] + 4
        assert rec["total_per_chip_bytes"] == (rec["args_bytes"] + 4
                                               + rec["temp_bytes"])


def test_dry_run_touches_no_device(monkeypatch):
    """``run_cell`` places and traces on the meta device: it never
    initialises CUDA, and the fake world it traces in is gone after it, so
    the caller has no process group."""
    def no_cuda(*a, **k):
        raise AssertionError("the dry run initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch, cell in (("deepseek-v3-671b", "train_4k"),
                       ("wide-deep", "serve_bulk"),
                       ("gatedgcn", "ogb_products")):
        rec = dryrun.run_cell(arch, cell, multi_pod=True)
        assert rec["status"] == "ok" and rec["chips"] == 512
        temp = rec["memory"]["temp_bytes"]
        assert isinstance(temp, int) and temp > 0
        assert isinstance(rec["compile_s"], float) and rec["compile_s"] > 0
        assert not torch.distributed.is_initialized()
    assert not torch.distributed.is_initialized()


def test_run_all_records_an_error_and_goes_on(capsys):
    """A cell that raises in its worker process (here: a cell the arch
    lacks) is recorded as an error, and the next cell still runs."""
    recs = list(dryrun.run_all([("din", "no_such_cell"),
                                ("din", "serve_bulk")], [False]))
    assert [r["status"] for r in recs] == ["error", "ok"]
    assert recs[0]["error"] == "KeyError: \"din has no cell 'no_such_cell'\""
    assert "FAIL din/no_such_cell/16x16: KeyError" in capsys.readouterr().out


def test_cli_and_report_without_a_card(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = _env(CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--smoke", "--out", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    status = [r["status"] for r in recs]
    assert len(recs) == 80
    assert (status.count("ok"), status.count("skipped"),
            status.count("error")) == (72, 8, 0)
    lines = run.stdout.splitlines()
    assert sum(ln.startswith("OK   ") for ln in lines) == 72
    assert sum(ln.startswith("SKIP ") for ln in lines) == 8
    for r in recs:
        assert set(r) >= {"arch", "cell", "mesh", "status"}
        if r["status"] != "ok":
            continue
        assert set(r) == {"arch", "cell", "mesh", "chips", "status",
                          "lower_s", "compile_s", "memory", "cost",
                          "roofline", "trace"}
        assert isinstance(r["compile_s"], float)
        assert isinstance(r["memory"]["temp_bytes"], int)
        assert r["memory"]["temp_bytes"] >= 0
        b = r["cost"]["collective_breakdown"]
        assert b["raw_hlo"] is not None
        assert "_counts" in b["parsed_hlo_once_per_loop"]
        assert r["chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert r["roofline"]["link"] == "net"
        m = r["memory"]
        assert m["total_per_chip_bytes"] == (m["args_bytes"]
                                             + m["output_bytes"]
                                             - m["alias_bytes"]
                                             + m["temp_bytes"])
        assert m["fits_hbm"] == (m["total_per_chip_bytes"] <= 80e9)
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", "--jsonl",
         str(out)], env=env, capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    text = rep.stdout
    for head in ("## Dry-run matrix", "## Roofline (single-pod 16x16)",
                 "## Roofline (multi-pod 2x16x16)"):
        assert head in text
    assert "fits 80 GB HBM3" in text and "16G" not in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")
            and not ln.startswith("| arch")]
    assert len(rows) == 80 + 36 + 36
    assert sum("| SKIP: " in ln for ln in rows) == 8
    for ln in rows[:80]:        # temp GB and the trace's seconds, or none
        cells = [c.strip() for c in ln.split("|")[1:-1]]
        assert len(cells) == 8
        if "| SKIP: " in ln:
            assert cells[-4:] == ["–"] * 4
        else:
            float(cells[5]), float(cells[7])
