"""Port parity for the MoE FFN's no-mesh path (``models/moe.py``) against
``repro.models.moe._moe_ffn_dense``, the oracle (the reference's
expert-parallel path fails its own test): both routers, with and without
a shared expert, capacities that keep every assignment and ones that drop
many, the capacity rule and the load-balance loss.

Tolerances: float32; expert products and the weighted combine round in
another order in each package: 1e-5 absolute and relative on outputs of
order 1.  Routing is exact: the same top-k experts, and the same set of
dropped (token, slot) assignments as the reference's stable sort gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro_torch.convert import tree_from_numpy
from repro_torch.models import moe as t_moe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


D = 32


def _reference_drops(topi: np.ndarray, n_experts: int, capacity: int):
    """(token, slot) assignments the reference drops: per expert, those
    after its first ``capacity`` in (token, slot) order."""
    seen = np.zeros(n_experts, np.int64)
    dropped = set()
    for t, row in enumerate(topi):
        for j, e in enumerate(row):
            if seen[e] >= capacity:
                dropped.add((t, j))
            seen[e] += 1
    return dropped


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("case", ["fits", "crowded", "tight"])
def test_moe_ffn_dense_matches_reference(router, n_shared, case):
    """``fits``: the published capacity factor 1.25 keeps everything;
    ``crowded``: 24 copies of one token overflow its experts; ``tight``:
    capacity factor 0.5."""
    capacity_factor = 0.5 if case == "tight" else 1.25
    cfg_j = j_moe.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=n_shared,
                            capacity_factor=capacity_factor, router=router)
    cfg_t = t_moe.MoEConfig(**dataclasses.asdict(cfg_j))
    params = j_moe.init_moe_params(jax.random.PRNGKey(0), D, cfg_j,
                                   jnp.float32)
    rng = np.random.default_rng(1)
    T = 64
    x = rng.normal(size=(T, D)).astype(np.float32)
    if case == "crowded":
        x[40:] = x[0]
    want = j_moe._moe_ffn_dense(params, jnp.asarray(x), cfg_j)
    p = tree_from_numpy(params, "cpu")
    got = t_moe.moe_ffn(p, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    C = t_moe._capacity(T, cfg_t)
    assert C == j_moe._capacity(T, cfg_j)
    logits = jnp.asarray(x) @ params["router"]
    scores = (jax.nn.sigmoid(logits) if router == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    _, j_topi = jax.lax.top_k(scores, cfg_j.top_k)
    topv, topi = t_moe.route(p, torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(j_topi))
    dp = t_moe.dispatch(topv, topi, cfg_t.n_experts, C)
    slot = dp.order % cfg_t.top_k
    dropped = {(int(t), int(j)) for t, j, kept
               in zip(dp.tok, slot, dp.keep) if not kept}
    assert dropped == _reference_drops(np.asarray(j_topi),
                                       cfg_t.n_experts, C)
    assert bool(dropped) == (case != "fits")


def test_capacity_rule_and_load_balance_loss():
    for T, E, k, cf in ((64, 8, 2, 1.25), (2, 256, 8, 1.25),
                        (32768, 16, 1, 1.25), (8192, 256, 8, 1.25)):
        cj = j_moe.MoEConfig(n_experts=E, top_k=k, d_ff=8,
                             capacity_factor=cf)
        ct = t_moe.MoEConfig(n_experts=E, top_k=k, d_ff=8,
                             capacity_factor=cf)
        assert t_moe._capacity(T, ct) == j_moe._capacity(T, cj)
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    topi = np.argsort(-logits, axis=-1)[:, :2].astype(np.int32)
    got = t_moe.moe_load_balance_loss(torch.from_numpy(logits),
                                      torch.from_numpy(topi), 8)
    want = j_moe.moe_load_balance_loss(jnp.asarray(logits),
                                       jnp.asarray(topi), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
