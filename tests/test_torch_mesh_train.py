"""Port parity for training the LM family on a mesh
(``launch.steps._mesh_step``, ``transformer.train_loss`` on local shards,
the sharded optimizers) on four gloo ranks
(``torch_spawn.RankPool``) over ("data", "model") meshes (2, 2) and
(1, 4) (and, in ``test_torch_mesh_launch.py``, ("pod", "data", "model")
(2, 1, 2)), against the reference's jitted ``_make_train_step`` under
``set_mesh`` of a ``jax.sharding.Mesh`` of the same shape on the forced
host devices, and against the port's unmeshed step.

Two train steps of deepseek-7b (AdamW; microbatch 1 and 2, the
reference's grouping of the global batch) and llama4-scout (momentum
Adafactor, top-1 expert parallelism) here, and of deepseek-v3 (MLA,
momentum Adafactor, all-to-all expert parallelism) in
``test_torch_mesh_ops.py``, at smoke size on numpy batches: the first from the reference's
weights and optimizer state (count 200, the schedule's peak), the second
from the state the meshed reference reached after it (count 201, moments
non-zero), so each step is held to the tolerances
``test_torch_lm_train.py`` states for one unmeshed step (float32): the
losses to rtol 1e-6; AdamW's
``m`` to rtol 1e-4 with an atol of 1e-5 of the leaf's largest value
(``v`` 1e-9 of it), and its parameters to 1e-6 absolute wherever the
reference's ``m`` exceeds 1e-5 of its leaf's largest (elsewhere at most
the two steps' distance); Adafactor's momentum to one bfloat16 ulp (rtol
2^-7) and its parameters to rtol 1e-5 / atol 1e-6, but for llama4-scout's
router, whose true gradient is 0 (top-1: its normalised weight is exactly
1), so that Adafactor scales rounding noise to a full step there in
every package.  The MoE archs
hold the meshed reference at their smoke capacity factor (both meshed
paths drop by ``_capacity_local``) and the unmeshed port at a factor
that drops nothing (16).  GatedGCN and the launcher:
``test_torch_mesh_launch.py``.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.models import transformer as j_tfm
from repro.sharding.rules import set_mesh as j_set_mesh
from repro_torch.convert import (adafactor_state_from_numpy,
                                 lm_params_from_jax, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import steps as t_steps
from repro_torch.tree import path_leaves
from torch_spawn import RankPool

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(2, 2), (1, 4)]
PEAK_COUNT = 200
NO_DROP = 16.0
LR = 3e-4


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


def _jmesh(shape, host_devices):
    n = int(np.prod(shape))
    return JMesh(np.array(host_devices[:n]).reshape(shape),
                 ("pod", "data", "model")[-len(shape):])


def _capacity(cfg, factor):
    if factor is None or cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


# -- the LM archs ----------------------------------------------------------------

LM_CASES = {
    "deepseek-7b": (7e9, 1),
    "deepseek-7b-micro2": (7e9, 2),
    "llama4-scout-17b-a16e": (60e9, 1),
    "deepseek-v3-671b": (60e9, 1),       # test_torch_mesh_ops.py runs it
}


@functools.lru_cache(maxsize=None)
def _lm_start(arch, optimizer_n):
    """The reference's smoke weights and optimizer state at count
    ``PEAK_COUNT``, and two numpy batches, all as numpy."""
    cfg = j_get_arch(arch).smoke
    params = jax.device_get(jax.jit(functools.partial(j_tfm.init_params, cfg))(
        jax.random.PRNGKey(0)))
    j_o, _ = j_steps._pick_optimizer(optimizer_n)
    state = j_o.init(params)
    state["count"] = jnp.int32(PEAK_COUNT)
    rng = np.random.default_rng(7)
    batches = [{k: rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    return params, tree_to_numpy(jax.device_get(state)), batches


def _lm_reference(arch, optimizer_n, microbatch, jmesh):
    """The reference's two meshed steps: [(loss, params, state)] after
    each, as numpy."""
    params, state, batches = _lm_start(arch, optimizer_n)
    cfg = j_get_arch(arch).smoke
    j_o, fused = j_steps._pick_optimizer(optimizer_n)
    step = jax.jit(j_steps._make_train_step(
        functools.partial(j_steps._lm_loss, cfg=cfg), j_o,
        microbatch=microbatch, fused=fused))
    p, s = params, jax.tree_util.tree_map(jnp.asarray, state)
    if fused:
        s["m"] = jax.tree_util.tree_map(lambda a: jnp.asarray(
            a, jnp.bfloat16), s["m"])
    out = []
    with j_set_mesh(jmesh):
        for b in batches:
            p, s, loss = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            out.append((float(loss), tree_to_numpy(jax.device_get(p)),
                        tree_to_numpy(jax.device_get(s))))
    return out


def _starts(start, after_first, batches):
    """The two steps' (parameters, state, batch): the handed-over start,
    then the meshed reference's state after the first step."""
    return [(start[0], start[1], batches[0]),
            (after_first[1], after_first[2], batches[1])]


def _lm_unmeshed(arch, optimizer_n, microbatch, factor, starts):
    prog = t_steps.build_cell(arch, "train_4k", smoke=True, device="cpu")
    prog.optimizer, prog.fused = t_steps._pick_optimizer(optimizer_n)
    prog.microbatch = microbatch
    prog.config = _capacity(prog.config, factor)
    out = []
    for params, state, b in starts:
        p = lm_params_from_jax(params, prog.config, "cpu").params()
        s = (adafactor_state_from_numpy(state, "cpu") if prog.fused
             else tree_from_numpy(state, "cpu"))
        p, s, loss = prog.step(None, p, s, tree_from_numpy(b, "cpu"))
        out.append((float(loss), tree_to_numpy(p), tree_to_numpy(s)))
    return out


def _close(got, want, path, rtol=1e-4, share=1e-5):
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=max(share * float(np.abs(want).max()), 1e-8), err_msg=path)


def _compare_lm(got, want, fused, start, frozen=()):
    """One step's (loss, params, state), as numpy, from the parameters
    ``start``."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    g_s, w_s = dict(path_leaves(got[2])), dict(path_leaves(want[2]))
    assert sorted(g_s) == sorted(w_s)
    assert int(g_s["count"]) == int(w_s["count"])
    w_p, s_p = dict(path_leaves(want[1])), dict(path_leaves(start))
    for path, p in path_leaves(got[1]):
        if path in frozen:
            continue
        assert not np.array_equal(p, s_p[path]), path
        if fused:
            np.testing.assert_allclose(p, w_p[path], rtol=1e-5, atol=1e-6,
                                       err_msg=path)
            continue
        m = w_s[f"m/{path}"]
        clear = np.abs(m) > 1e-5 * np.abs(m).max()
        diff = np.abs(p - w_p[path])
        assert float(diff[clear].max()) <= 1e-6, path
        assert float(diff.max()) <= 2 * 1.5 * LR, path
    for path, t in g_s.items():
        if path == "count" or any(f in path for f in frozen):
            continue
        if path.startswith("m/"):
            _close(t, w_s[path], path, rtol=2**-7 if fused else 1e-4)
        else:
            _close(t, w_s[path], path, share=1e-9)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", ["deepseek-7b", "deepseek-7b-micro2",
                                  "llama4-scout-17b-a16e"])
def test_lm_steps_match_reference_and_unmeshed(case, shape, pool,
                                               host_devices):
    check_lm_case(case, shape, pool, host_devices)


def check_lm_case(case, shape, pool, host_devices):
    """Two meshed steps of an ``LM_CASES`` case against the meshed
    reference and the unmeshed port."""
    arch = case.replace("-micro2", "")
    optimizer_n, micro = LM_CASES[case]
    params, state, batches = _lm_start(arch, optimizer_n)
    fused = t_steps._pick_optimizer(optimizer_n)[1]
    frozen = (("layers/ffn/router",) if arch == "llama4-scout-17b-a16e"
              else ())
    want = _lm_reference(arch, optimizer_n, micro,
                         _jmesh(shape, host_devices))
    starts = _starts((params, state), want[0], batches)
    got = pool.run("mesh_checks:train_steps", shape, arch, "train_4k",
                   starts, optimizer_n, micro)[0]
    for (p, _, _), g, w in zip(starts, got, want):
        _compare_lm(g, w, fused, p, frozen)
    assert int(got[1][2]["count"]) == PEAK_COUNT + 2
    if j_get_arch(arch).smoke.moe is not None:
        got = pool.run("mesh_checks:train_steps", shape, arch, "train_4k",
                       starts, optimizer_n, micro, NO_DROP)[0]
    plain = _lm_unmeshed(arch, optimizer_n, micro, NO_DROP, starts)
    for (p, _, _), g, w in zip(starts, got, plain):
        _compare_lm(g, w, fused, p, frozen)


