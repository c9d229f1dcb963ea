"""Port parity for GNN training (``configs/gatedgcn.py``, the GNN cells of
``configs/base.py``, ``launch/steps.py`` and ``launch/train.py`` for
GatedGCN) against ``repro.configs`` and ``repro.launch.steps`` at the
smoke config (2 layers, d 16): the reference's weights carried over
(``convert.gnn_params_from_jax``), the same numpy-seeded inputs.

Tolerances (float32): configs, cells and input specs exactly.  One train
step of each cell kind against the reference's ``_make_train_step`` with
AdamW from count 200 (the schedule's peak): the loss, every updated
parameter and AdamW's ``m`` to rtol 1e-5 (the scatter-adds sum in another
order), with an atol of 1e-5 of the leaf's largest value for ``m`` and
``v`` (``v`` to rtol 1e-4: squares of gradients that differ by ~1e-7).
Gradients with ``remat`` on equal those with it off bit for bit.
"""

import dataclasses
import functools
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import config_for_cell as j_config_for_cell
from repro.configs import get_arch as j_get_arch
from repro.configs import get_cell as j_get_cell
from repro.configs import input_specs as j_input_specs
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro_torch.configs import (cells_for, config_for_cell, get_arch,
                                 get_cell, input_specs)
from repro_torch.convert import gnn_params_from_jax, tree_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import gnn as t_gnn
from repro_torch.train import checkpoint
from repro_torch.tree import path_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
KINDS = {"gnn_train_full": "full_graph_sm",
         "gnn_train_sampled": "minibatch_lg",
         "gnn_train_graphs": "molecule"}
PEAK_COUNT = 200      # the schedule's peak, 3e-4
DTYPES = {"int32": torch.int32, "float32": torch.float32}


# -- configs and cells --------------------------------------------------------

def test_config_copy_and_cells():
    spec, want = get_arch("gatedgcn"), j_get_arch("gatedgcn")
    assert (spec.family, spec.source, spec.skip_cells) == (
        want.family, want.source, want.skip_cells) == (
        "gnn", "arXiv:2003.00982; paper", {})
    for got, ref in ((spec.config, want.config), (spec.smoke, want.smoke)):
        g, w = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert str(g.pop("param_dtype")) == "torch.float32"
        assert np.dtype(w.pop("param_dtype")) == np.float32
        assert g == w
    assert (spec.config.n_layers, spec.config.d_hidden, spec.config.remat) \
        == (16, 70, True)
    assert [(c.name, c.kind, c.dims) for c in cells_for("gatedgcn")] == [
        (c.name, c.kind, c.dims) for c in j_steps.cells_for("gatedgcn")]
    assert [c.name for c in cells_for("gatedgcn")] == list(CELLS)
    with pytest.raises(KeyError, match="no cell"):
        get_cell("gatedgcn", "train_4k")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("cell", CELLS)
def test_config_for_cell_and_input_specs_match_reference(cell, smoke):
    got_cfg = config_for_cell("gatedgcn", get_cell("gatedgcn", cell), smoke)
    want_cfg = j_config_for_cell("gatedgcn", j_get_cell("gatedgcn", cell),
                                 smoke)
    for field in ("n_layers", "d_hidden", "d_in", "n_classes", "readout",
                  "remat", "aggregator"):
        assert getattr(got_cfg, field) == getattr(want_cfg, field), field
    want = j_input_specs("gatedgcn", cell, smoke)
    got = input_specs("gatedgcn", cell, smoke)
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert got[key].shape == tuple(spec.shape), key
        assert got[key].dtype == DTYPES[str(spec.dtype)], key
    if not smoke and cell == "ogb_products":
        assert got["edge_index"].shape == (2, 61_859_328)
        assert got["node_feats"].shape == (2_449_408, 100)


# -- one train step against the reference -------------------------------------

def _numpy_inputs(specs, n_classes, seed):
    """Inputs of ``specs``' shapes from numpy: about a tenth of the edges
    and a third of the nodes masked, molecule graph ids block-diagonal."""
    rng = np.random.default_rng(seed)
    n = specs["node_feats"].shape[0]
    out = {}
    for name, spec in specs.items():
        shape = tuple(spec.shape)
        if name == "node_feats":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        elif name == "edge_index":
            out[name] = rng.integers(0, n, shape).astype(np.int32)
        elif name == "edge_mask":
            out[name] = (rng.random(shape) < 0.9).astype(np.float32)
        elif name == "node_mask":
            out[name] = (rng.random(shape) < 0.7).astype(np.float32)
        elif name == "labels":
            out[name] = rng.integers(0, n_classes, shape).astype(np.int32)
    if "graph_ids" in specs:
        g = specs["labels"].shape[0]
        out["graph_ids"] = np.repeat(np.arange(g, dtype=np.int32), n // g)
    return out


@functools.lru_cache(maxsize=None)
def _reference_step(cell):
    """The reference's smoke cell: its weights, AdamW state at count
    ``PEAK_COUNT``, numpy inputs, and its jitted step's result, as numpy."""
    prog = j_steps.build_cell("gatedgcn", cell, smoke=True)
    params = jax.tree_util.tree_map(np.array,
                                    prog.init_params(jax.random.PRNGKey(0)))
    state = prog.optimizer.init(params)
    state["count"] = jnp.int32(PEAK_COUNT)
    batch = _numpy_inputs(prog.input_avals, prog.config.n_classes, 1)
    after = jax.jit(prog.step)(params, state, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    return (params, jax.tree_util.tree_map(np.array, state), batch,
            jax.tree_util.tree_map(np.array, after))


def _close(got, want, path, rtol=1e-5, share=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=max(share * float(np.abs(want).max()), 1e-12), err_msg=path)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cell_step_matches_reference(kind):
    cell = KINDS[kind]
    params, state, batch, (j_p, j_s, j_loss) = _reference_step(cell)
    prog = t_steps.build_cell("gatedgcn", cell, smoke=True, device="cpu")
    assert (prog.kind, prog.family, prog.fused, prog.microbatch) == (
        kind, "gnn", False, 1)
    model = gnn_params_from_jax(params, prog.config, "cpu")
    t_state = tree_from_numpy(state, "cpu")
    t_p, t_s, t_loss = prog.step(
        model, model.params(), t_state,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert int(t_s["count"]) == int(j_s["count"]) == PEAK_COUNT + 1
    want_p = dict(path_leaves(j_p))
    start = dict(path_leaves(params))
    for path, p in path_leaves(t_p):
        np.testing.assert_allclose(p.numpy(), want_p[path], rtol=1e-5,
                                   atol=1e-7, err_msg=path)
        assert not np.array_equal(p.numpy(), start[path]), path
    for moment, rtol in (("m", 1e-5), ("v", 1e-4)):
        want = dict(path_leaves(j_s[moment]))
        for path, t in path_leaves(t_s[moment]):
            _close(t.numpy(), want[path], f"{moment} {path}", rtol=rtol)


def test_pick_optimizer_for_the_gnn_family_matches_reference():
    n = sum(t.numel() for _, t in path_leaves(
        t_gnn.gnn_param_shapes(get_arch("gatedgcn").config)))
    (j_o, j_fused), (t_o, t_fused) = (
        j_steps._pick_optimizer(n, family="gnn"),
        t_steps._pick_optimizer(n, family="gnn"))
    assert j_fused is t_fused is False
    p = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}
    g = {"w": np.cos(np.arange(12, dtype=np.float32)).reshape(3, 4)}
    j_s, t_s = j_o.init(p), t_o.init(tree_from_numpy(p, "cpu"))
    assert sorted(j_s) == sorted(t_s) == ["count", "m", "v"]
    for _ in range(3):
        j_u, j_s = j_o.update(g, j_s, p)
        t_u, t_s = t_o.update(tree_from_numpy(g, "cpu"), t_s,
                              tree_from_numpy(p, "cpu"))
        np.testing.assert_allclose(t_u["w"].numpy(), np.asarray(j_u["w"]),
                                   rtol=1e-6, atol=1e-12)


def test_remat_gradients_equal_none_bit_for_bit():
    """The published config's remat at smoke widths: one step's gradients
    with each layer recomputed equal the plain forward's bit for bit."""
    prog = t_steps.build_cell("gatedgcn", "full_graph_sm", smoke=True,
                              device="cpu")
    model = prog.init_params(torch.Generator().manual_seed(3))
    inputs = t_steps.init_inputs(prog, torch.Generator().manual_seed(4))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(prog.config, remat=remat)
        p = tree_map(lambda t: t.clone().requires_grad_(True), model.params())
        loss = t_gnn.gnn_loss(p, inputs, cfg)
        loss.backward()
        grads[remat] = [loss.detach()] + [t.grad for _, t in path_leaves(p)]
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))


@pytest.mark.parametrize("cell", CELLS)
def test_build_cell_init_inputs_and_step(cell):
    prog = t_steps.build_cell("gatedgcn", cell, smoke=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = prog.init_params(gen)
    inputs = t_steps.init_inputs(prog, gen)
    assert sorted(inputs) == sorted(prog.input_specs)
    for name, spec in prog.input_specs.items():
        assert inputs[name].shape == spec.shape, name
        assert inputs[name].dtype == spec.dtype, name
    n = prog.input_specs["node_feats"].shape[0]
    ei = inputs["edge_index"]
    assert 0 <= int(ei.min()) and int(ei.max()) < n
    assert int(inputs["labels"].max()) < prog.config.n_classes
    assert bool((inputs["edge_mask"] == 1).all())
    assert bool((inputs["node_mask"] == 1).all())
    if "graph_ids" in inputs:
        assert torch.equal(inputs["graph_ids"], torch.arange(
            4, dtype=torch.int32).repeat_interleave(n // 4))
    params = model.params()
    before = {p: t.clone() for p, t in path_leaves(params)}
    state = prog.optimizer.init(params)
    state["count"].fill_(PEAK_COUNT)
    new_p, state, loss = prog.step(model, params, state, inputs)
    assert math.isfinite(float(loss)) and int(state["count"]) == 201
    for path, t in path_leaves(new_p):
        assert not torch.equal(t, before[path]), path
    # the published config: cell dims, a (meta) parameter count
    full = t_steps.build_cell("gatedgcn", cell, device="cpu")
    assert full.config.remat and full.config.n_layers == 16
    assert full.config.readout == ("graph" if cell == "molecule" else "node")


# -- the launchers ------------------------------------------------------------

def _final_params(ckpt_dir):
    step = checkpoint.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        return step, {k: z[k] for k in z.files}


def test_train_launcher_resumes_gatedgcn(tmp_path, capsys, monkeypatch):
    common = ["--arch", "gatedgcn", "--device", "cpu", "--ckpt-every", "2",
              "--seed", "5"]
    straight = str(tmp_path / "straight")
    t_train.main(common + ["--steps", "4", "--ckpt-dir", straight])
    out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gatedgcn",
                                      "--smoke", "--steps", "2"])
    j_train.main()
    want = capsys.readouterr().out.splitlines()
    # the reference's first line, word for word but the count
    assert re.sub(r"[\d,]+ params", "N params", out[0]) == re.sub(
        r"[\d,]+ params", "N params", want[0]) == (
        "gatedgcn/full_graph_sm: N params, optimizer=fused-adafactor")
    assert out[0].split()[1] == want[0].split()[1]           # the count
    assert re.fullmatch(r"loss: first=\d+\.\d{4} last=\d+\.\d{4} \(4 steps "
                        r"from step 0, \d+ stragglers\)", out[-1]), out[-1]
    resumed = str(tmp_path / "resumed")
    t_train.main(common + ["--steps", "2", "--ckpt-dir", resumed])
    state = t_train.main(common + ["--steps", "4", "--ckpt-dir", resumed])
    assert "(2 steps from step 2" in capsys.readouterr().out
    assert int(state.step) == 4
    s1, a = _final_params(straight)
    s2, b = _final_params(resumed)
    assert s1 == s2 == 4 and sorted(a) == sorted(b)
    assert any(k.startswith("opt_state/m/layers/") for k in a)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("cell", ["molecule", "minibatch_lg"])
def test_train_launcher_other_cells(cell, capsys):
    t_train.main(["--arch", "gatedgcn", "--cell", cell, "--steps", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"gatedgcn/{cell}: [\d,]+ params, "
                        r"optimizer=fused-adafactor", out[0]), out[0]
    assert out[-1].startswith("loss: first=")


def test_gatedgcn_refusals(capsys):
    """What stays refused: no serving cell, no mesh path, no such cell."""
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "gatedgcn", "--device", "cpu"])
    assert "the GNN family has no serving cell" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_train.main(["--arch", "gatedgcn", "--mesh", "debug", "--device",
                      "cpu"])
    assert "The multi-GPU mesh path" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_train.main(["--arch", "gatedgcn", "--cell", "train_batch",
                      "--device", "cpu"])
    assert "no cell 'train_batch'" in capsys.readouterr().err
    with pytest.raises(KeyError, match="no cell"):
        t_steps.build_cell("gatedgcn", "serve_p99", smoke=True, device="cpu")
