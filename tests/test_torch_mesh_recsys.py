"""Port parity for training the recsys family on a mesh (``recsys_loss``
on local shards, ``launch.steps._mesh_step``, ``launch/train.py --mesh``)
on four gloo ranks (``torch_spawn.RankPool``) over ("data", "model")
meshes (2, 2) and (1, 4): the tables (``tables``, ``wide``,
``minhash_table``, ``item_table``) row-sharded over "model", the batch
split over "data".

Wide & Deep, AutoInt, DIN and MIND at smoke size on numpy batches, the
reference's weights, Adafactor state (count 200, the schedule's peak) and
frontend coefficients handed over (the reference draws the coefficients
per process).  Two train steps (the second from the meshed reference's
state after the first), each against the reference's jitted
``build_cell(arch, "train_batch").step`` under ``set_mesh`` of a
``jax.sharding.Mesh`` of the same shape on the forced host devices, its
inputs placed under the cell's specs, and against the port's unmeshed
step, to the tolerances ``test_torch_recsys_train.py`` states for one
unmeshed step: the loss to rtol 1e-6; parameters to rtol 1e-5 / atol
3e-7; the second moments to rtol 1e-4 with an atol of 1e-4 of the leaf's
largest; DIN's last attention bias (a true gradient of 0) held only to
the clipped step, its second moment to squared rounding.  The gradients
of ``recsys_loss`` on shards against ``jax.grad`` of the reference's loss
and against the port's unmeshed gradient: rtol 1e-5 and an atol of 1e-5
of the leaf's largest.  The reference disagrees with itself across the
two mesh shapes in the loss's 7th digit (summation order), inside these
tolerances.

Also: ``serve_p99`` and ``retrieval_cand`` steps given DTensor parameters
== the unmeshed port's scores (rtol 1e-6: the lookups' sums across
"model" add exact zeros, the frontend's row-shard bags sum in another
order) and the reference's jitted ``build_cell(arch, cell).step`` under
``set_mesh`` of the same shape, its parameters placed by the cell's specs
(the same rtol 1e-6 and atol 1e-7, inside the rtol 1e-5 that
``test_torch_recsys.py`` allows the unmeshed scores); ``launch.train --arch autoint --mesh debug --device cpu`` under
``torchrun`` at a world of 4, its resumed run == the unbroken one bit for
bit; and a (1, 4) Wide & Deep checkpoint restored onto (2, 2) through
``elastic.reshard_restore``.
"""

import functools
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.models import recsys as j_recsys
from repro.sharding import rules as j_rules
from repro.sharding.rules import set_mesh as j_set_mesh
from repro_torch.configs import get_arch
from repro_torch.convert import (adafactor_state_from_numpy,
                                 recsys_params_from_jax, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import recsys as t_recsys
from repro_torch.tree import path_leaves, tree_leaves, tree_map
from test_torch_mesh_launch import _torchrun
from test_torch_mesh_ops import _shard_of
from test_torch_mesh_train import PEAK_COUNT, SHAPES, _jmesh, _starts
from test_torch_recsys_train import ARCHS, SHIFT_FREE, _batch
from torch_spawn import RankPool

B = 32
SERVE_CELLS = ("serve_p99", "retrieval_cand")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _int32(batch):
    return {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _start(arch):
    """The reference's smoke weights, Adafactor state at count
    ``PEAK_COUNT``, frontend coefficients (or None) and two batches, as
    numpy."""
    cfg = j_get_arch(arch).smoke
    params = tree_to_numpy(jax.device_get(j_recsys.init_recsys_params(
        cfg, jax.random.PRNGKey(0))))
    coeffs = None
    if cfg.use_minhash_frontend:
        coeffs = tuple(np.asarray(a) for a in j_recsys._minhash_coeffs(
            cfg.arch_id, cfg.minhash_k))
    prog = j_steps.build_cell(arch, "train_batch", smoke=True)
    state = prog.optimizer.init(params)
    state["count"] = jnp.int32(PEAK_COUNT)
    batches = [_int32(_batch(get_arch(arch).smoke, 10 + i, B))
               for i in range(2)]
    return params, coeffs, tree_to_numpy(jax.device_get(state)), batches


def _placed(tree, specs, jmesh):
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: JNamed(jmesh, s), specs,
        is_leaf=lambda x: isinstance(x, JP)))


def _reference(arch, jmesh):
    """The reference's two meshed steps: [(loss, params, state)] after
    each, as numpy; the parameters stay sharded as placed."""
    params, _, state, batches = _start(arch)
    prog = j_steps.build_cell(arch, "train_batch", smoke=True)
    step = jax.jit(prog.step)
    out = []
    with j_set_mesh(jmesh):
        p = _placed(params, prog.param_specs, jmesh)
        s = _placed(jax.tree_util.tree_map(jnp.asarray, state),
                    prog.opt_specs, jmesh)
        for b in batches:
            p, s, loss = step(p, s, {k: jax.device_put(
                v, j_rules.named_sharding(*prog.input_specs_tree[k]))
                for k, v in b.items()})
            out.append((float(loss), tree_to_numpy(jax.device_get(p)),
                        tree_to_numpy(jax.device_get(s))))
        key = "item_table" if "item_table" in p else "tables"
        assert p[key].sharding.is_equivalent_to(
            JNamed(jmesh, prog.param_specs[key]), p[key].ndim)
    return out


def _unmeshed(arch, starts):
    _, coeffs, _, _ = _start(arch)
    prog = t_steps.build_cell(arch, "train_batch", smoke=True, device="cpu")
    out = []
    for params, state, b in starts:
        model = recsys_params_from_jax(params, prog.config,
                                       *(coeffs or (None, None)), device="cpu")
        p, s, loss = prog.step(model, model.params(),
                               adafactor_state_from_numpy(state, "cpu"),
                               tree_from_numpy(b, "cpu"))
        out.append((float(loss), tree_to_numpy(p), tree_to_numpy(s)))
    return out


def _compare_step(arch, got, want, start):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    w_p, s_p = dict(path_leaves(want[1])), dict(path_leaves(start))
    for path, a in path_leaves(got[1]):
        if arch == "din" and path == SHIFT_FREE:
            for moved in (a, w_p[path]):
                assert float(np.abs(moved - s_p[path]).max()) \
                    <= 3e-4 * (1 + 1e-5), path
            continue
        np.testing.assert_allclose(a, w_p[path], rtol=1e-5, atol=3e-7,
                                   err_msg=path)
        assert not np.array_equal(a, s_p[path]), path
    w_s = dict(path_leaves(want[2]))
    g_s = dict(path_leaves(got[2]))
    assert sorted(g_s) == sorted(w_s)
    assert int(g_s["count"]) == int(w_s["count"])
    for path, a in g_s.items():
        if path == "count":
            continue
        if arch == "din" and path.startswith(f"v/{SHIFT_FREE}"):
            assert max(float(a.max()), float(w_s[path].max())) < 1e-20
            continue
        np.testing.assert_allclose(
            a, w_s[path], rtol=1e-4,
            atol=1e-4 * float(np.abs(w_s[path]).max()), err_msg=path)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_reference_and_unmeshed(arch, shape, pool,
                                            host_devices):
    params, coeffs, state, batches = _start(arch)
    want = _reference(arch, _jmesh(shape, host_devices))
    starts = _starts((params, state), want[0], batches)
    got = pool.run("mesh_checks:train_steps", shape, arch, "train_batch",
                   starts, None, 1, None, coeffs)[0]
    assert int(dict(path_leaves(got[1][2]))["count"]) == PEAK_COUNT + 2
    for ref in (want, _unmeshed(arch, starts)):
        for (p, _, _), g, w in zip(starts, got, ref):
            _compare_step(arch, g, w, p)


def _close_grads(got, want):
    w = dict(path_leaves(want))
    assert sorted(w) == sorted(p for p, _ in path_leaves(got))
    for path, g in path_leaves(got):
        atol = max(1e-5 * float(np.abs(w[path]).max()), 1e-10)
        np.testing.assert_allclose(g, w[path], rtol=1e-5, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_on_shards(arch, shape, pool):
    params, coeffs, _, batches = _start(arch)
    loss, grads, _ = pool.run("mesh_checks:recsys_grads", shape, arch,
                              params, batches[0], coeffs)[0]
    j_cfg = j_get_arch(arch).smoke
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_recsys.recsys_loss),
                              static_argnums=2)(
        params, {k: jnp.asarray(v) for k, v in batches[0].items()}, j_cfg)
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-6)
    _close_grads(grads, tree_to_numpy(jax.device_get(j_grads)))
    model = recsys_params_from_jax(params, get_arch(arch).smoke,
                                   *(coeffs or (None, None)), device="cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(True),
                    model.params())
    t_loss = t_recsys.recsys_loss(model, tree_from_numpy(batches[0], "cpu"),
                                  live)
    t_grads = torch.autograd.grad(t_loss, tree_leaves(live))
    np.testing.assert_allclose(loss, float(t_loss.detach()), rtol=1e-6)
    it = iter(t_grads)
    _close_grads(grads, tree_to_numpy(tree_map(lambda _: next(it), live)))


def test_a_table_the_mesh_does_not_divide_stays_whole(pool):
    """DIN with 1,001 items on (1, 4): the greedy spec drops "model" from
    ``item_table`` (whole on every rank, its lookups summed over no axis);
    loss and gradients as unmeshed."""
    import dataclasses
    changes = {"item_vocab": 1001}
    j_cfg = dataclasses.replace(j_get_arch("din").smoke, **changes)
    params = tree_to_numpy(jax.device_get(j_recsys.init_recsys_params(
        j_cfg, jax.random.PRNGKey(1))))
    cfg = dataclasses.replace(get_arch("din").smoke, **changes)
    batch = _int32(_batch(cfg, 31, B))
    loss, grads, placements = pool.run(
        "mesh_checks:recsys_grads", (1, 4), "din", params, batch, None,
        changes)[0]
    assert placements == {"item_table": ["R", "R"]}
    model = recsys_params_from_jax(params, cfg, device="cpu")
    live = tree_map(lambda t: t.detach().requires_grad_(True),
                    model.params())
    t_loss = t_recsys.recsys_loss(model, tree_from_numpy(batch, "cpu"), live)
    t_grads = iter(torch.autograd.grad(t_loss, tree_leaves(live)))
    np.testing.assert_allclose(loss, float(t_loss.detach()), rtol=1e-6)
    _close_grads(grads, tree_to_numpy(tree_map(lambda _: next(t_grads),
                                               live)))


def _reference_scores(arch, cell, params, batch, jmesh):
    """The reference's jitted serving or retrieval step on ``jmesh``:
    parameters placed by the cell's specs, each input by its spec, or
    whole where the mesh does not divide its rows (a 1-query retrieval
    batch)."""
    prog = j_steps.build_cell(arch, cell, smoke=True)
    with j_set_mesh(jmesh):
        inputs = {}
        for k, v in batch.items():
            where = j_rules.named_sharding(*prog.input_specs_tree[k])
            try:
                where.shard_shape(v.shape)
            except ValueError:
                where = JNamed(jmesh, JP())
            inputs[k] = jax.device_put(v, where)
        return np.asarray(jax.jit(prog.step)(
            _placed(params, prog.param_specs, jmesh), inputs))


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_shards_matches_unmeshed(arch, cell, pool, host_devices):
    params, coeffs, _, _ = _start(arch)
    prog = t_steps.build_cell(arch, cell, smoke=True, device="cpu")
    n = 1 if cell == "retrieval_cand" else B
    batch = _int32(_batch(prog.config, 21, n))
    batch.pop("labels")
    model = recsys_params_from_jax(params, prog.config,
                                   *(coeffs or (None, None)), device="cpu")
    want = prog.step(model, tree_from_numpy(batch, "cpu")).numpy()
    for shape in SHAPES:
        got = pool.run("mesh_checks:recsys_scores", shape, arch, cell,
                       params, batch, coeffs)
        whole, _ = got[0]
        assert whole.shape == want.shape
        np.testing.assert_allclose(whole, want, rtol=1e-6, atol=1e-7,
                                   err_msg=str(shape))
        np.testing.assert_allclose(
            whole, _reference_scores(arch, cell, params, batch,
                                     _jmesh(shape, host_devices)),
            rtol=1e-6, atol=1e-7, err_msg=f"reference {shape}")
        for r, (_, local) in enumerate(got):
            # serving: rank r holds its "data" rows; retrieval: every
            # rank scores the one query whole
            part = (np.split(want, shape[0])[r // shape[1]]
                    if cell == "serve_p99" else want)
            np.testing.assert_allclose(local, part, rtol=1e-6, atol=1e-7)


def _final_arrays(ckpt_dir):
    from repro_torch.train import checkpoint
    step = checkpoint.latest_step(ckpt_dir)
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}",
                              "arrays.npz")) as z:
        return step, {k: z[k] for k in z.files}


def test_train_launcher_on_a_mesh_resumes(tmp_path, capsys):
    """The unbroken run checkpoints at steps 2 and 4; a new world resumed
    from a copy of its step-2 checkpoint alone ends at the same arrays."""
    common = ["--arch", "autoint", "--device", "cpu", "--seed", "3",
              "--steps", "4"]
    meshed = common + ["--mesh", "debug", "--ckpt-every", "2"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    runs = [_torchrun(meshed + ["--ckpt-dir", str(straight)], nproc=4)]
    assert runs[0].returncode == 0, runs[0].stderr[-3000:]
    resumed.mkdir()
    shutil.copytree(straight / "step_00000002", resumed / "step_00000002")
    runs.append(_torchrun(meshed + ["--ckpt-dir", str(resumed)], nproc=4))
    assert runs[1].returncode == 0, runs[1].stderr[-3000:]
    lines = runs[0].stdout.splitlines()
    assert "(2 steps from step 2" in runs[1].stdout
    s1, a = _final_arrays(straight)
    s2, b = _final_arrays(resumed)
    assert s1 == s2 == 4 and sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    t_train.main(common)
    plain = capsys.readouterr().out.splitlines()
    assert lines[0] == plain[0]
    got, want = (re.match(r"loss: first=([\d.]+) last=([\d.]+) \(4 steps",
                          ls[-1]) for ls in (lines, plain))
    assert got and want
    for g, w in zip(got.groups(), want.groups()):
        assert abs(float(g) - float(w)) <= 2e-4, (lines, plain)


def test_checkpoint_reshards_wide_deep(pool, tmp_path, host_devices):
    params, _, state, _ = _start("wide-deep")
    meshed = str(tmp_path / "meshed")
    got = pool.run("mesh_checks:reshard_checkpoint", meshed, "wide-deep",
                   params, state, "train_batch")
    want = dict(path_leaves(tree_to_numpy({"params": params,
                                           "opt_state": state})))
    step, placements, _, whole = got[0]
    assert step == 3
    for path, a in path_leaves(whole):
        np.testing.assert_array_equal(a, want[path], err_msg=path)
    assert placements["params/tables"] == ["R", "S(1)"]
    prog = t_steps.build_cell("wide-deep", "train_batch", smoke=True,
                              device="cpu")
    spec_of = dict(path_leaves({"params": prog.param_specs,
                                "opt_state": prog.opt_specs}))
    jm = _jmesh((2, 2), host_devices)
    for path, full in want.items():
        y = jax.device_put(full, JNamed(jm, JP(*spec_of[path])))
        for rank, (_, _, local, _) in enumerate(got):
            coords = np.unravel_index(rank, (2, 2))
            np.testing.assert_array_equal(
                local[path], _shard_of(y, coords, (2, 2), host_devices),
                err_msg=path)
