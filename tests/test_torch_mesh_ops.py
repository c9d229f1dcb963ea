"""Port parity for the pieces of training on a mesh, on four gloo ranks
(``torch_spawn.RankPool``) over ("data", "model") meshes (2, 2) and
(1, 4), against the JAX package on ``jax.sharding.Mesh``es of the same
shape over the forced host devices:

  * ``rules.constrain`` / ``named_sharding``: each rank's local chunk is
    the reference's shard on the device at its mesh coordinates, an
    indivisible axis dropped; without a mesh ``constrain`` returns ``x``
    and ``named_sharding`` None;
  * ``moe.moe_ffn_ep`` at T = 64 (the all-to-all path) and T = 6 (the
    psum fallback), on DTensors through ``local_map``: the output and
    the gradients of sum(y^2) with respect to every parameter and to x
    against the port's ``_moe_ffn_dense`` and the reference's
    ``moe_ffn_ep`` (its gradients taken as its ``test_moe_ep_gradients``
    takes them), at a capacity that drops nothing, to rtol 1e-5 with an
    atol of 1e-5 of the compared array's largest value;
  * two train steps of deepseek-v3 (``test_torch_mesh_train.py``'s
    check, tolerances there);
  * ``compression.compressed_psum_int8`` over a ("dp",) mesh of 4 ranks
    against the reference's ``make_compressed_allreduce`` bit for bit,
    the uniform draws handed over; top-k with error feedback exactly;
  * a state saved on a (1, 4) mesh restores on (2, 2)
    (``elastic.reshard_restore``) and unmeshed, leaf for leaf, and its
    arrays are the bytes of an unmeshed save of the same state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamed
from jax.sharding import PartitionSpec as JP

from repro.models import moe as j_moe
from repro.optim import compression as j_comp
from repro.sharding import rules as j_rules
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.launch import steps as t_steps
from repro_torch.models import moe as t_moe
from repro_torch.optim import compression as t_comp
from repro_torch.sharding import rules as t_rules
from repro_torch.train import checkpoint
from repro_torch.tree import path_leaves
from test_torch_mesh_train import SHAPES, _jmesh, _lm_start, check_lm_case
from torch_spawn import RankPool


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


def _shard_of(arr, coords, shape, host_devices):
    """The reference's shard of ``arr`` on the device at ``coords``."""
    dev = np.array(host_devices[:int(np.prod(shape))]).reshape(shape)[coords]
    for s in arr.addressable_shards:
        if s.device == dev:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {dev}")


# -- constrain / named_sharding ------------------------------------------------

LAYOUTS = [((8, 4), ("batch", None)), ((8, 4), (None, "model")),
           ((8, 4), ("batch", "model")), ((8, 4), ("all", None)),
           ((16, 4), (("data", "model"),)), ((6, 8), ("model", None)),
           ((4, 6), (None, "model")), ((8, 4, 2), ("batch", None, "model"))]


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("xshape,axes", LAYOUTS)
def test_constrain_layout_matches_reference(xshape, axes, shape, pool,
                                            host_devices):
    got = pool.run("mesh_checks:layout", shape, xshape, axes)
    jm = _jmesh(shape, host_devices)
    x = np.arange(int(np.prod(xshape)), dtype=np.float32).reshape(xshape)
    with j_rules.set_mesh(jm):
        y = jax.jit(lambda a: j_rules.constrain(a, *axes))(x)
        spec = tuple(j_rules.named_sharding(*axes).spec)
    for rank, (local, t_spec) in enumerate(got):
        coords = np.unravel_index(rank, shape)
        np.testing.assert_array_equal(
            local, _shard_of(y, coords, shape, host_devices))
        assert tuple(t_spec) == spec


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("xshape,spec", [
    ((16, 4), (("model", "data"), None)),     # the E % 256 experts' order
    ((16, 4), (("data", "model"), None)),
    ((4, 16, 8), (None, "data", "model")), ((8, 6), ("model", "data"))])
def test_parameter_placement_matches_reference(xshape, spec, shape, pool,
                                               host_devices):
    """A parameter spec's placement (``NamedSharding(..., greedy=True)``):
    each rank's chunk is the reference's shard at its coordinates, an axis
    tuple numbered with its first axis major."""
    got = pool.run("mesh_checks:placed", shape, xshape, spec)
    x = np.arange(int(np.prod(xshape)), dtype=np.float32).reshape(xshape)
    y = jax.device_put(x, JNamed(_jmesh(shape, host_devices), JP(*spec)))
    for rank, local in enumerate(got):
        np.testing.assert_array_equal(
            local, _shard_of(y, np.unravel_index(rank, shape), shape,
                             host_devices))


def test_constrain_is_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert t_rules.current_mesh() is None
    assert t_rules.constrain(x, "batch", "model") is x
    assert t_rules.named_sharding("batch") is None


# -- moe_ffn_ep ------------------------------------------------------------------

MOE_CFG = dict(n_experts=8, top_k=2, d_ff=32, n_shared=1, router="sigmoid",
               capacity_factor=8.0)


def _allclose(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
        err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("T", [64, 6], ids=["a2a", "psum"])
def test_moe_ffn_ep_matches_dense_and_reference(T, shape, pool,
                                                host_devices):
    j_cfg = j_moe.MoEConfig(**MOE_CFG)
    params = jax.device_get(j_moe.init_moe_params(
        jax.random.PRNGKey(0), 64, j_cfg, jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (T, 64)))
    loss = lambda p, xx: jnp.sum(j_moe.moe_ffn(p, xx, j_cfg) ** 2)
    with j_rules.set_mesh(_jmesh(shape, host_devices)):
        j_y = np.asarray(jax.jit(lambda p, xx: j_moe.moe_ffn(p, xx, j_cfg))(
            params, x))
        j_g, j_gx = jax.device_get(jax.jit(jax.grad(loss, (0, 1)))(params,
                                                                   x))
    cfg = t_moe.MoEConfig(**MOE_CFG)
    tp = {k: v.requires_grad_(True) if isinstance(v, torch.Tensor) else
          {kk: vv.requires_grad_(True) for kk, vv in v.items()}
          for k, v in tree_from_numpy(params, "cpu").items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    dense = t_moe._moe_ffn_dense(tp, tx, cfg)
    (dense ** 2).sum().backward()
    d_g = {path: t.grad.numpy() for path, t in path_leaves(tp)}
    y, grads, gx = pool.run("mesh_checks:moe_ep", shape, MOE_CFG,
                            tree_to_numpy(params), x)[0]
    for want, what in ((dense.detach().numpy(), "dense"), (j_y, "reference")):
        _allclose(y, want, f"output vs {what}")
    for path, g in path_leaves(grads):
        _allclose(g, d_g[path], f"d {path} vs dense")
        _allclose(g, np.asarray(dict(path_leaves(j_g))[path]),
                  f"d {path} vs reference")
    _allclose(gx, tx.grad.numpy(), "dx vs dense")
    _allclose(gx, np.asarray(j_gx), "dx vs reference")


# -- deepseek-v3 -----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_deepseek_v3_steps_match_reference_and_unmeshed(shape, pool,
                                                        host_devices):
    check_lm_case("deepseek-v3-671b", shape, pool, host_devices)


# -- compression -----------------------------------------------------------------

def test_compressed_psum_int8_matches_reference_bit_for_bit(pool,
                                                          host_devices):
    n = 96
    rng = np.random.default_rng(11)
    g = (rng.standard_normal(4 * n) * np.repeat([1.0, 3.0, 0.01, 7.0], n)
         ).astype(np.float32)
    key = jax.random.PRNGKey(5)
    draws = np.asarray(jax.random.uniform(key, (n,)))
    jm = JMesh(np.array(host_devices[:4]), ("dp",))
    f = jax.jit(j_comp.make_compressed_allreduce(jm, "dp", spec=JP("dp")))
    want = np.asarray(f(g, key))
    got = pool.run("mesh_checks:compressed", g, draws)
    for rank, part in enumerate(got):
        np.testing.assert_array_equal(part, want[rank * n:(rank + 1) * n])
    q_j, s_j = j_comp.quantize_int8(jnp.asarray(g[:n]), key)
    q_t, s_t = t_comp.quantize_int8(torch.from_numpy(g[:n]),
                                    draws=torch.from_numpy(draws.copy()))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)
    np.testing.assert_array_equal(
        t_comp.dequantize_int8(q_t, s_t).numpy(),
        np.asarray(j_comp.dequantize_int8(q_j, s_j)))


def test_topk_error_feedback_is_exact():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    g[1, :3] = g[0, 0] = 2.5          # ties, broken to the lower index
    residual = (rng.standard_normal((6, 7)) * 0.1).astype(np.float32)
    for k in (1, 5, 42):
        want = j_comp.topk_error_feedback(jnp.asarray(g),
                                          jnp.asarray(residual), k)
        got = t_comp.topk_error_feedback(torch.from_numpy(g),
                                         torch.from_numpy(residual), k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the checkpoint across meshes -------------------------------------------------

def test_checkpoint_reshards_across_meshes(pool, tmp_path, host_devices):
    arch = "deepseek-7b"
    params, state, _ = _lm_start(arch, 7e9)
    meshed = str(tmp_path / "meshed")
    got = pool.run("mesh_checks:reshard_checkpoint", meshed, arch, params,
                   state)
    tree = {"params": params, "opt_state": state}
    want = dict(path_leaves(tree_to_numpy(tree)))
    step, placements, _, whole = got[0]
    assert step == 3
    for path, a in path_leaves(whole):
        np.testing.assert_array_equal(a, want[path], err_msg=path)
    # each rank's chunk on (2, 2) is the reference's shard there
    prog = t_steps.build_cell(arch, "train_4k", smoke=True, device="cpu")
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
    # unmeshed: the same arrays, the same bytes as an unmeshed save
    t_tree = tree_from_numpy(tree, "cpu")
    back, _ = checkpoint.restore(meshed, t_tree)
    for path, t in path_leaves(back):
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    plain = str(tmp_path / "plain")
    checkpoint.save(plain, 3, t_tree)
    with np.load(os.path.join(meshed, "step_00000003", "arrays.npz")) as a, \
            np.load(os.path.join(plain, "step_00000003", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
