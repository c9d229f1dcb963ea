"""Port parity for the rest of the recsys family: AutoInt (``self-attn``,
with the minhash frontend), DIN (``target-attn``) and MIND
(``multi-interest``) against ``repro.models.recsys`` on their smoke
configs, and ``retrieval_scores`` of all four archs, with the reference's
weights and frontend coefficients handed over in this process
(``convert.recsys_params_from_jax``).  Inputs are made with numpy and fed
to both; DIN and MIND get a history mask with holes.

Each model runs at its init scale and with its embedding tables scaled
x30, where MIND's squash and routing softmax and DIN's attention leave
their near-linear range.

Tolerances: float32 matrix products, softmaxes and the frontend's slot
sums round in another order in each package: rtol 1e-5, and an atol of
1e-5 of the largest |logit| (MIND's logits are ~1e-4 at init, and a logit
near 0 carries the rounding of its larger terms).  Retrieval chunked ==
unchunked exactly: a row's logit does not depend on its neighbours.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells_for as j_cells_for
from repro.configs import get_arch as j_get_arch
from repro.configs import input_specs as j_input_specs
from repro.launch import steps as j_steps
from repro.models import recsys as j_recsys
from repro_torch.configs import cells_for, get_arch, input_specs
from repro_torch.convert import recsys_params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.steps import build_cell, init_inputs
from repro_torch.models import recsys as t_recsys
from repro_torch.tree import path_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ("wide-deep", "autoint", "din", "mind")
NEW_ARCHS = ("autoint", "din", "mind")
CELLS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
B = 32          # SMOKE_RECSYS["batch"]
N_CAND = 128    # SMOKE_RECSYS["n_candidates"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _smoke(arch, scale=1.0):
    """The reference's smoke model (embedding tables x ``scale``) and the
    port's copy of it."""
    j_cfg = j_get_arch(arch).smoke
    t_cfg = get_arch(arch).smoke
    params = j_recsys.init_recsys_params(j_cfg, jax.random.PRNGKey(0))
    for key in ("tables", "item_table"):
        if key in params:
            params[key] = params[key] * scale
    a1 = a2 = None
    if j_cfg.use_minhash_frontend:
        a1, a2 = j_recsys._minhash_coeffs(j_cfg.arch_id, j_cfg.minhash_k)
    model = recsys_params_from_jax(params, t_cfg, a1, a2, device="cpu")
    return j_cfg, params, model


def _batch(cfg, seed, n=B):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.interaction in ("concat", "self-attn"):
        out["field_ids"] = rng.integers(0, cfg.vocab, (n, cfg.n_fields))
    else:
        out["hist_ids"] = rng.integers(0, cfg.item_vocab, (n, cfg.seq_len))
        mask = (rng.random((n, cfg.seq_len)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        out["hist_mask"] = mask
        out["target_id"] = rng.integers(0, cfg.item_vocab, (n,))
    if cfg.use_minhash_frontend:
        out["set_ids"] = rng.integers(0, 1 << cfg.minhash_s, (n, cfg.set_nnz))
        out["set_counts"] = rng.integers(1, cfg.set_nnz, (n,))
    return out


def _both(batch):
    def cast(v):
        return v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
    return ({k: jnp.asarray(cast(v)) for k, v in batch.items()},
            {k: torch.from_numpy(cast(v)) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    for name in ("config", "smoke"):
        j_cfg = getattr(j_get_arch(arch), name)
        t_cfg = getattr(get_arch(arch), name)
        j_fields = dataclasses.asdict(j_cfg)
        t_fields = dataclasses.asdict(t_cfg)
        assert j_fields.pop("param_dtype") == jnp.float32
        assert t_fields.pop("param_dtype") == torch.float32
        assert t_fields == j_fields
    assert get_arch(arch).source == j_get_arch(arch).source
    assert get_arch(arch).family == "recsys"
    assert [(c.name, c.kind, c.dims) for c in cells_for(arch)] == [
        (c.name, c.kind, c.dims) for c in j_cells_for(arch)]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, cell, smoke):
    want = j_input_specs(arch, cell, smoke)
    got = input_specs(arch, cell, smoke)
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        if key == "n_candidates":
            assert got[key] == spec
            continue
        assert got[key].shape == tuple(spec.shape), key
        assert str(got[key].dtype) == f"torch.{spec.dtype}", key


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_keep_the_reference_tree(arch):
    _, params, model = _smoke(arch)
    j_paths = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path), np.asarray(leaf))
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   params)[0]]
    t_paths = path_leaves(model.params())
    assert [p for p, _ in t_paths] == [p for p, _ in j_paths]
    for (_, t), (_, j) in zip(t_paths, j_paths):
        np.testing.assert_array_equal(t.detach().numpy(), j)
    names = {n for n, _ in model.named_parameters()}
    assert names == {p.replace("/", ".") for p, _ in t_paths}
    fresh = t_recsys.init_recsys_params(model.cfg, torch.Generator())
    assert [(p, tuple(t.shape)) for p, t in path_leaves(fresh.params())] == [
        (p, j.shape) for p, j in j_paths]


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_logits_and_scores_match_reference(arch, scale):
    j_cfg, params, model = _smoke(arch, scale)
    j_batch, t_batch = _both(_batch(model.cfg, 2))
    logits = t_recsys.recsys_logits(model, t_batch)
    assert logits.shape == (B,) and logits.dtype == torch.float32
    _close(logits.detach().numpy(),
           j_recsys.recsys_logits(params, j_batch, j_cfg))
    scores = t_recsys.serve_scores(model, t_batch)
    _close(scores.numpy(), j_recsys.serve_scores(params, j_batch, j_cfg))


def test_din_mask_drops_history():
    """A masked-out step of DIN's history does not reach the score."""
    _, _, model = _smoke("din", 30.0)
    batch = _batch(model.cfg, 3)
    batch["hist_mask"][:, 5:] = 0.0
    moved = dict(batch, hist_ids=batch["hist_ids"].copy())
    moved["hist_ids"][:, 5:] = (moved["hist_ids"][:, 5:] + 1) % 1000
    a = t_recsys.serve_scores(model, _both(batch)[1])
    b = t_recsys.serve_scores(model, _both(moved)[1])
    assert torch.equal(a, b)
    moved["hist_ids"][:, 0] = (moved["hist_ids"][:, 0] + 1) % 1000
    assert not torch.equal(a, t_recsys.serve_scores(model, _both(moved)[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scores_match_reference(arch, monkeypatch):
    j_cfg, params, model = _smoke(arch, 30.0)
    query = _batch(model.cfg, 4, n=1)
    j_q, t_q = _both(query)
    want = j_recsys.retrieval_scores(params, j_q, j_cfg, N_CAND)
    whole = t_recsys.retrieval_scores(model, t_q, N_CAND)
    monkeypatch.setattr(t_recsys, "RETRIEVAL_CHUNK", 40)   # 40, 40, 40, 8
    chunked = t_recsys.retrieval_scores(model, t_q, N_CAND)
    assert whole.shape == (N_CAND,)
    assert torch.equal(chunked, whole)
    _close(whole.numpy(), want)
    prog = build_cell(arch, "retrieval_cand", smoke=True, device="cpu")
    assert prog.n_candidates == N_CAND and "n_candidates" not in prog.input_specs
    assert torch.equal(prog.step(model, t_q), chunked)
    # candidate c is the explicit batch's row with c in the candidate slot
    rows = {k: v.repeat(5, *[1] * (v.dim() - 1)) for k, v in t_q.items()}
    cand = torch.tensor([0, 1, 7, 99, 127], dtype=torch.int32)
    if "target_id" in rows:
        rows["target_id"] = cand
    else:
        rows["field_ids"][:, -1] = cand
    explicit = t_recsys.recsys_logits(model, rows).detach()
    torch.testing.assert_close(whole[cand.long()], explicit, rtol=1e-6,
                               atol=0)
    with pytest.raises(ValueError, match="batch 1"):
        t_recsys.retrieval_scores(model, {k: v.repeat(2, *[1] * (v.dim() - 1))
                                          for k, v in t_q.items()}, 8)


def test_embedding_bags_match_reference():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 4)).astype(np.float32)
    ids = rng.integers(0, 50, (7, 5)).astype(np.int32)
    mask = (rng.random((7, 5)) < 0.6).astype(np.float32)
    mask[0] = 0.0                              # an empty bag: mean over 1
    tt, ti, tm = map(torch.from_numpy, (table, ids, mask))
    for combiner in ("sum", "mean"):
        got = t_recsys.embedding_bag(tt, ti, tm, combiner)
        want = j_recsys.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                      jnp.asarray(mask), combiner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(
        t_recsys.embedding_bag_seq(tt, ti).numpy(),
        np.asarray(j_recsys.embedding_bag_seq(jnp.asarray(table),
                                              jnp.asarray(ids))))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cell_programs_are_seeded_and_in_range(arch):
    for cell in CELLS:
        prog = build_cell(arch, cell, smoke=True, device="cpu")
        cfg = prog.config
        inputs = init_inputs(prog, torch.Generator().manual_seed(5))
        again = init_inputs(prog, torch.Generator().manual_seed(5))
        assert all(torch.equal(inputs[k], again[k]) for k in inputs)
        for key, spec in prog.input_specs.items():
            assert inputs[key].shape == spec.shape
            assert inputs[key].dtype == spec.dtype
        if "hist_ids" in inputs:
            for key in ("hist_ids", "target_id"):
                assert 0 <= int(inputs[key].min())
                assert int(inputs[key].max()) < cfg.item_vocab
            assert bool((inputs["hist_mask"] == 1).all())
        if "labels" in inputs:
            assert set(inputs["labels"].unique().tolist()) <= {0.0, 1.0}
        if cell == "retrieval_cand":
            assert all(v.shape[0] == 1 for v in inputs.values())
    m1 = prog.init_params(torch.Generator().manual_seed(4))
    m2 = prog.init_params(torch.Generator().manual_seed(4))
    for (name, p1), (_, p2) in zip(m1.state_dict().items(),
                                   m2.state_dict().items()):
        assert torch.equal(p1, p2), name
    sprog = build_cell(arch, "serve_p99", smoke=True, device="cpu")
    scores = sprog.step(m1, init_inputs(sprog, torch.Generator().manual_seed(6)))
    assert scores.shape == (B,) and bool(((scores > 0) & (scores < 1)).all())


def test_reference_build_cell_agrees_on_kinds():
    for arch in ARCHS:
        for cell in CELLS:
            j_prog = j_steps.build_cell(arch, cell, smoke=True)
            t_prog = build_cell(arch, cell, smoke=True, device="cpu")
            assert t_prog.kind == j_prog.kind
            assert sorted(t_prog.input_specs) == sorted(j_prog.input_avals)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_entry_point_serves_each_arch(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--requests", "2",
                "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"2 requests, batch 32: p50=\d+\.\dms p99=\d+\.\dms",
                        line), line
