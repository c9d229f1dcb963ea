"""Port parity for the GNN model (``repro_torch.models.gnn``) against
``repro.models.gnn`` at smoke size (2 layers, d 16): the reference's
weights carried over (``convert.gnn_params_from_jax``), the same
numpy-seeded graphs and features.

Tolerances (float32): ``gatedgcn_layer``'s ``h`` and ``e``, the forward's
node logits and graph readout, and the loss to rtol 1e-5 (the scatter-adds
sum in another order: ~1e-7 measured), with an atol of 1e-6 for elements
near zero.  The sampler, with the reference's draws handed over, and
``subgraph_sizes`` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as j_gnn
from repro_torch.convert import gnn_params_from_jax
from repro_torch.models import gnn as t_gnn
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


D, D_IN, CLASSES, LAYERS = 16, 12, 4, 2
RTOL, ATOL = 1e-5, 1e-6


def _configs(readout="node", remat=False):
    return (j_gnn.GNNConfig("t", LAYERS, D, D_IN, CLASSES, readout=readout,
                            remat=remat),
            t_gnn.GNNConfig("t", LAYERS, D, D_IN, CLASSES, readout=readout,
                            remat=remat))


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's weights for ``_configs`` (any readout), as numpy."""
    return jax.tree_util.tree_map(np.array, j_gnn.init_gnn_params(
        _configs()[0], jax.random.PRNGKey(0)))


def _batch(seed, n=40, e=160, n_graphs=None):
    """A graph of ``n`` nodes and ``e`` random edges, about a tenth of them
    masked, labels and a node mask; ``n_graphs`` blocks of nodes with
    per-graph labels for the graph readout."""
    rng = np.random.default_rng(seed)
    out = {"node_feats": rng.standard_normal((n, D_IN)).astype(np.float32),
           "edge_index": rng.integers(0, n, (2, e)).astype(np.int32),
           "edge_mask": (rng.random(e) < 0.9).astype(np.float32),
           "node_mask": (rng.random(n) < 0.7).astype(np.float32)}
    if n_graphs:
        out["labels"] = rng.integers(0, CLASSES, n_graphs).astype(np.int32)
        out["graph_ids"] = np.repeat(np.arange(n_graphs, dtype=np.int32),
                                     n // n_graphs)
    else:
        out["labels"] = rng.integers(0, CLASSES, n).astype(np.int32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _toy_graph(n=12, p=0.4, seed=0):
    """``tests/test_gnn.py``'s toy graph: a random adjacency, no loops."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < p
    np.fill_diagonal(adj, False)
    src, dst = np.nonzero(adj)
    return n, src.astype(np.int32), dst.astype(np.int32)


# -- the layer --------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_gatedgcn_layer_matches_reference(masked):
    n, src, dst = _toy_graph()
    rng = np.random.default_rng(1)
    h = rng.standard_normal((n, D)).astype(np.float32)
    e = rng.standard_normal((src.shape[0], D)).astype(np.float32)
    mask = ((rng.random(src.shape[0]) < 0.7) if masked
            else np.ones(src.shape[0])).astype(np.float32)
    lp = {k: np.array(v[0]) for k, v in _params()["layers"].items()}
    want = j_gnn.gatedgcn_layer(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(h),
        jnp.asarray(e), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(mask), n)
    got = t_gnn.gatedgcn_layer(
        {k: torch.from_numpy(v) for k, v in lp.items()}, torch.from_numpy(h),
        torch.from_numpy(e), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), n)
    for name, g, w in zip("he", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_gatedgcn_layer_matches_dense_oracle():
    """The layer (float32) against ``tests/test_gnn.py``'s float64 oracle,
    ``np.add.at`` for the scatters, to 1e-5 (float32 rounding)."""
    n, src, dst = _toy_graph()
    rng = np.random.default_rng(2)
    h = rng.standard_normal((n, D)).astype(np.float32)
    e = rng.standard_normal((src.shape[0], D)).astype(np.float32)
    lp = {k: np.array(v[0]) for k, v in _params()["layers"].items()}
    got_h, got_e = t_gnn.gatedgcn_layer(
        {k: torch.from_numpy(v) for k, v in lp.items()}, torch.from_numpy(h),
        torch.from_numpy(e), torch.from_numpy(src), torch.from_numpy(dst),
        torch.ones(src.shape[0]), n)
    lp = {k: v.astype(np.float64) for k, v in lp.items()}
    h, e = h.astype(np.float64), e.astype(np.float64)
    hs, hd = h[src], h[dst]
    e_np = hd @ lp["A"] + hs @ lp["B"] + e @ lp["C"]
    gate = 1 / (1 + np.exp(-e_np))
    gate_sum = np.zeros((n, D))
    np.add.at(gate_sum, dst, gate)
    msg = gate / (gate_sum[dst] + 1e-6) * (hs @ lp["V"])
    agg = np.zeros((n, D))
    np.add.at(agg, dst, msg)

    def norm(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w

    want_h = h + np.maximum(norm(h @ lp["U"] + agg, lp["ln_h"]), 0)
    want_e = e + np.maximum(norm(e_np, lp["ln_e"]), 0)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_e.numpy(), want_e, rtol=1e-5, atol=1e-5)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("readout", ["node", "graph"])
def test_gnn_forward_and_loss_match_reference(readout, remat):
    j_cfg, t_cfg = _configs(readout, remat)
    j_b, t_b = _both(_batch(3, n_graphs=4 if readout == "graph" else None))
    j_p = jax.tree_util.tree_map(jnp.asarray, _params())
    t_p = gnn_params_from_jax(_params(), t_cfg, "cpu").params()
    want = np.asarray(j_gnn.gnn_forward(j_p, j_b, j_cfg))
    got = t_gnn.gnn_forward(t_p, t_b, t_cfg)
    assert got.shape == want.shape == ((4 if readout == "graph" else 40),
                                       CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(t_gnn.gnn_loss(t_p, t_b, t_cfg)),
                               float(j_gnn.gnn_loss(j_p, j_b, j_cfg)),
                               rtol=RTOL)


def test_masked_edges_carry_no_message():
    """All edges masked == no edges at all (``tests/test_gnn.py``'s case)."""
    _, t_cfg = _configs()
    t_p = gnn_params_from_jax(_params(), t_cfg, "cpu").params()
    _, t_b = _both(_batch(4))
    t_b["edge_mask"] = torch.zeros_like(t_b["edge_mask"])
    none = dict(t_b, edge_index=torch.zeros_like(t_b["edge_index"]))
    torch.testing.assert_close(t_gnn.gnn_forward(t_p, t_b, t_cfg),
                               t_gnn.gnn_forward(t_p, none, t_cfg),
                               rtol=1e-5, atol=1e-5)


def test_param_tree_and_shapes_match_reference():
    _, t_cfg = _configs()
    want = {p: (tuple(v.shape), str(v.dtype))
            for p, v in path_leaves(_params())}
    model = t_gnn.init_gnn_params(t_cfg, torch.Generator().manual_seed(0))
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in path_leaves(model.params())}
    assert got == want
    meta = t_gnn.gnn_param_shapes(t_cfg)
    assert {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for p, v in path_leaves(meta)} == want
    assert all(v.device.type == "meta" for _, v in path_leaves(meta))
    for path, v in path_leaves(model.params()):
        if path.startswith("layers/ln_"):
            assert torch.equal(v, torch.ones_like(v)), path
    # scales: N(0, 1/fan_in) weights, N(0, 1) edge embedding
    std = {p: float(v.std()) for p, v in path_leaves(model.params())}
    assert abs(std["layers/A"] * D ** 0.5 - 1) < 0.1
    assert abs(std["embed_in"] * D_IN ** 0.5 - 1) < 0.2


# -- the sampler ------------------------------------------------------------

def _csr(degrees, seed):
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, len(degrees), indptr[-1]).astype(np.int32)
    return indptr, indices


def _reference_draws(key, frontier0, fanouts):
    """The (F, fanout) draws ``j_gnn.neighbor_sample`` takes from ``key``,
    hop by hop (its key splits, replayed)."""
    draws, F = [], frontier0
    for fanout in fanouts:
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.randint(sub, (F, fanout), 0,
                                                 1 << 30)))
        F *= fanout
    return draws


GRAPHS = {
    # degrees 1..9, every node has neighbors
    "dense": (np.random.default_rng(2).integers(1, 10, 100), 16, (4, 3)),
    # zero-degree nodes inside and at the end (indptr[last] == nnz: the
    # clamp), seeds among them
    "holes": (np.where((np.arange(50) % 5 == 0) | (np.arange(50) == 49),
                       0, np.random.default_rng(3).integers(1, 6, 50)), 12,
              (3, 2, 2)),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_neighbor_sample_matches_reference(graph):
    degrees, n_seeds, fanouts = GRAPHS[graph]
    indptr, indices = _csr(degrees, 4)
    n = len(degrees)
    rng = np.random.default_rng(5)
    seeds = rng.choice(n, n_seeds, replace=False).astype(np.int32)
    if graph == "holes":
        seeds[:2] = [0, n - 1]               # zero degree, the last one too
        assert degrees[0] == degrees[n - 1] == 0
    key = jax.random.PRNGKey(7)
    want = j_gnn.neighbor_sample(
        key, j_gnn.CSRGraph(indptr=jnp.asarray(indptr),
                            indices=jnp.asarray(indices)),
        jnp.asarray(seeds), fanouts)
    got = t_gnn.neighbor_sample(
        None, t_gnn.CSRGraph(indptr=torch.from_numpy(indptr),
                             indices=torch.from_numpy(indices)),
        torch.from_numpy(seeds), fanouts,
        draws=_reference_draws(key, n_seeds, fanouts))
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        assert got[name].numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    if graph == "holes":
        assert not np.asarray(want["edge_mask"]).all()


def test_neighbor_sample_invariants_with_its_own_draws():
    """The port's own draws: fixed shapes, every valid edge's source a CSR
    neighbor of its destination, a zero-degree frontier node's edges
    masked, and the same generator seed giving the same subgraph."""
    degrees, n_seeds, fanouts = GRAPHS["holes"]
    indptr, indices = _csr(degrees, 6)
    g = t_gnn.CSRGraph(indptr=torch.from_numpy(indptr),
                       indices=torch.from_numpy(indices))
    seeds = torch.arange(n_seeds, dtype=torch.int32) * 4
    sub = t_gnn.neighbor_sample(torch.Generator().manual_seed(0), g, seeds,
                                fanouts)
    n_sub, e_sub = t_gnn.subgraph_sizes(n_seeds, fanouts)
    assert sub["nodes"].shape == (n_sub,)
    assert sub["edge_index"].shape == (2, e_sub)
    assert sub["edge_mask"].dtype == torch.bool
    nodes = sub["nodes"].numpy()
    for (s, d), valid in zip(sub["edge_index"].T.numpy(),
                             sub["edge_mask"].numpy()):
        d_glob = nodes[d]
        assert valid == (degrees[d_glob] > 0)
        if valid:
            assert nodes[s] in indices[indptr[d_glob]:indptr[d_glob + 1]]
    again = t_gnn.neighbor_sample(torch.Generator().manual_seed(0), g, seeds,
                                  fanouts)
    for name in sub:
        assert torch.equal(sub[name], again[name]), name
    with pytest.raises(ValueError, match="draws"):
        t_gnn.neighbor_sample(None, g, seeds, fanouts,
                              draws=[np.zeros((n_seeds, 1), np.int64)])


@pytest.mark.parametrize("n_seeds,fanouts", [
    (1024, (15, 10)), (8, (3, 2)), (16, (4, 3)), (5, ()), (3, (2, 2, 2))])
def test_subgraph_sizes_match_reference(n_seeds, fanouts):
    assert t_gnn.subgraph_sizes(n_seeds, fanouts) == j_gnn.subgraph_sizes(
        n_seeds, fanouts)
    if fanouts == (15, 10):
        assert t_gnn.subgraph_sizes(n_seeds, fanouts) == (169_984, 168_960)


def test_remat_forward_equals_plain_bit_for_bit():
    """``cfg.remat`` recomputes the same operations: the loss and every
    gradient equal the plain forward's bit for bit on the CPU."""
    _, t_b = _both(_batch(8))
    grads = {}
    for remat in (False, True):
        _, t_cfg = _configs(remat=remat)
        p = tree_map(lambda t: t.clone().requires_grad_(True),
                     gnn_params_from_jax(_params(), t_cfg, "cpu").params())
        loss = t_gnn.gnn_loss(p, t_b, t_cfg)
        loss.backward()
        grads[remat] = (loss.detach(), {k: v.grad for k, v in
                                        path_leaves(p)})
    assert torch.equal(grads[False][0], grads[True][0])
    for k, v in grads[False][1].items():
        assert torch.equal(v, grads[True][1][k]), k
