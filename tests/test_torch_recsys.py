"""Port parity for Wide & Deep serving with the minhash frontend: the
port's ``repro_torch.models.recsys`` against ``repro.models.recsys`` on
the ``wide-deep-smoke`` config, with the reference's weights and frontend
coefficients handed over in this process (the reference draws its
coefficients from Python's per-process string hash, so another process
would hold other ones).  Inputs are made with numpy and fed to both.

Tolerances: the signatures are integers, bit-identical.  The frontend's
embedding sums slots in order where ``sigbag_ref`` uses ``jnp.sum``'s
tree, ~1e-8 apart at the 0.01-scale init: atol 1e-6.  The scores go
through float32 matrix products and a 6-field wide sum, each free to
round in another order: rtol 1e-5, atol 1e-6.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import input_specs as j_input_specs
from repro.kernels import ref as kref
from repro.models import recsys as j_recsys
from repro_torch.configs import get_arch, input_specs
from repro_torch.convert import recsys_params_from_jax
from repro_torch.launch import serve, train
from repro_torch.launch.steps import build_cell, init_inputs
from repro_torch.models import recsys as t_recsys


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B = 32          # SMOKE_RECSYS["batch"]


@pytest.fixture(scope="module")
def smoke():
    """The reference's smoke model and the port's copy of it."""
    j_cfg = j_get_arch("wide-deep").smoke
    t_cfg = get_arch("wide-deep").smoke
    params = j_recsys.init_recsys_params(j_cfg, jax.random.PRNGKey(0))
    a1, a2 = j_recsys._minhash_coeffs(j_cfg.arch_id, j_cfg.minhash_k)
    model = recsys_params_from_jax(params, t_cfg, a1, a2, device="cpu")
    return j_cfg, t_cfg, params, model


def _batch(cfg, seed, n=B):
    rng = np.random.default_rng(seed)
    return {
        "field_ids": rng.integers(0, cfg.vocab, (n, cfg.n_fields)),
        "set_ids": rng.integers(0, 1 << cfg.minhash_s, (n, cfg.set_nnz)),
        "set_counts": rng.integers(1, cfg.set_nnz, (n,)),
    }


def _both(batch):
    j = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in batch.items()}
    return j, t


def test_config_copy_matches_reference():
    for name in ("config", "smoke"):
        j_cfg = getattr(j_get_arch("wide-deep"), name)
        t_cfg = getattr(get_arch("wide-deep"), name)
        j_fields = dataclasses.asdict(j_cfg)
        t_fields = dataclasses.asdict(t_cfg)
        assert j_fields.pop("param_dtype") == jnp.float32
        assert t_fields.pop("param_dtype") == torch.float32
        assert t_fields == {key: j_fields.pop(key) for key in t_fields}
        # what the copy leaves out belongs to other interactions: unset here
        assert not any(j_fields.values()), j_fields
    assert get_arch("wide-deep").source == j_get_arch("wide-deep").source
    for cell in ("serve_p99", "serve_bulk"):
        for smoke in (True, False):
            want = j_input_specs("wide-deep", cell, smoke)
            got = input_specs("wide-deep", cell, smoke)
            assert sorted(got) == sorted(want)
            for key, spec in want.items():
                assert got[key].shape == tuple(spec.shape)
                assert str(got[key].dtype) == f"torch.{spec.dtype}"


def test_unported_archs_and_kinds_raise():
    """What the port refuses: an arch the reference does not have, a cell
    the arch does not have (GatedGCN trains in the GNN cells, not in a
    recsys one), an unknown interaction and the mesh path of the train
    launcher."""
    with pytest.raises(KeyError, match="not in the port"):
        get_arch("graphsage")
    assert get_arch("gatedgcn").family == "gnn"
    with pytest.raises(KeyError, match="no cell"):
        build_cell("gatedgcn", "train_batch", smoke=True, device="cpu")
    with pytest.raises(SystemExit):
        train.main(["--arch", "gatedgcn", "--cell", "train_batch",
                    "--device", "cpu"])
    with pytest.raises(KeyError, match="no cell"):
        build_cell("wide-deep", "train_4k", smoke=True, device="cpu")
    cfg = dataclasses.replace(get_arch("wide-deep").smoke,
                              interaction="cross")
    with pytest.raises(ValueError, match="interaction"):
        t_recsys.init_recsys_params(cfg, torch.Generator())
    with pytest.raises(SystemExit):
        train.main(["--arch", "wide-deep", "--mesh", "single-pod",
                    "--device", "cpu"])


def test_embedding_lookup_matches_reference():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(3, 50, 4)).astype(np.float32)
    ids = rng.integers(0, 50, (7, 3)).astype(np.int32)
    got = t_recsys.embedding_lookup(torch.from_numpy(table),
                                    torch.from_numpy(ids))
    want = j_recsys.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_keeps_the_reference_names_and_values(smoke):
    _, t_cfg, params, model = smoke
    names = dict(model.named_parameters())
    n_layers = len(params["deep"]["w"])
    assert sorted(names) == sorted(
        ["tables", "wide", "minhash_table"]
        + [f"deep.{p}.{i}" for p in "wb" for i in range(n_layers)])
    np.testing.assert_array_equal(names["tables"].numpy(),
                                  np.asarray(params["tables"]))
    np.testing.assert_array_equal(names["deep.w.1"].numpy(),
                                  np.asarray(params["deep"]["w"][1]))
    assert dict(model.named_buffers()).keys() == {"a1", "a2"}
    assert model.a1.dtype == torch.int32 and model.a1.shape == (t_cfg.minhash_k,)


def test_minhash_frontend_matches_reference(smoke):
    j_cfg, t_cfg, params, model = smoke
    j_batch, t_batch = _both(_batch(t_cfg, 1))
    a1, a2 = j_recsys._minhash_coeffs(j_cfg.arch_id, j_cfg.minhash_k)
    j_sig = kref.minhash2u_ref(j_batch["set_ids"],
                               j_batch["set_counts"].reshape(-1, 1),
                               jnp.asarray(a1), jnp.asarray(a2),
                               s=j_cfg.minhash_s, b=j_cfg.minhash_b)
    t_sig = model.signatures(t_batch["set_ids"], t_batch["set_counts"])
    assert t_sig.dtype == torch.int32
    np.testing.assert_array_equal(t_sig.numpy(), np.asarray(j_sig, np.int32))
    got = t_recsys.minhash_frontend(model, t_batch["set_ids"],
                                    t_batch["set_counts"])
    want = j_recsys.minhash_frontend(params, j_batch["set_ids"],
                                     j_batch["set_counts"], j_cfg)
    assert got.shape == (B, t_cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_serve_scores_match_reference(smoke):
    j_cfg, t_cfg, params, model = smoke
    j_batch, t_batch = _both(_batch(t_cfg, 2))
    got = t_recsys.serve_scores(model, t_batch)
    want = j_recsys.serve_scores(params, j_batch, j_cfg)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    logits = t_recsys.recsys_logits(model, t_batch)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(j_recsys.recsys_logits(params, j_batch, j_cfg)),
        rtol=1e-5, atol=1e-6)


def test_frontend_changes_scores(smoke):
    """The hashed feature contributes: new set ids, new scores."""
    _, t_cfg, _, model = smoke
    batch = _batch(t_cfg, 3)
    moved = dict(batch, set_ids=(batch["set_ids"] + 7) % (1 << t_cfg.minhash_s))
    s1 = t_recsys.serve_scores(model, _both(batch)[1])
    s2 = t_recsys.serve_scores(model, _both(moved)[1])
    assert not torch.allclose(s1, s2)


def test_cell_program_is_seeded_and_in_range():
    prog = build_cell("wide-deep", "serve_p99", smoke=True, device="cpu")
    cfg = prog.config
    m1 = prog.init_params(torch.Generator().manual_seed(4))
    m2 = prog.init_params(torch.Generator().manual_seed(4))
    for (name, p1), (_, p2) in zip(m1.state_dict().items(),
                                   m2.state_dict().items()):
        assert torch.equal(p1, p2), name
    assert bool((m1.a2 & 1).all())
    inputs = init_inputs(prog, torch.Generator().manual_seed(5))
    assert {k: tuple(v.shape) for k, v in inputs.items()} == {
        "field_ids": (B, cfg.n_fields), "set_ids": (B, cfg.set_nnz),
        "set_counts": (B,)}
    assert all(v.dtype == torch.int32 for v in inputs.values())
    assert 0 <= int(inputs["field_ids"].min()) and \
        int(inputs["field_ids"].max()) < cfg.vocab
    assert 0 <= int(inputs["set_ids"].min()) and \
        int(inputs["set_ids"].max()) < 1 << cfg.minhash_s
    assert 1 <= int(inputs["set_counts"].min()) and \
        int(inputs["set_counts"].max()) < cfg.set_nnz
    scores = prog.step(m1, inputs)
    assert scores.shape == (B,) and bool(((scores > 0) & (scores < 1)).all())


def test_serve_entry_point(capsys, monkeypatch):
    serve.main(["--arch", "wide-deep", "--smoke", "--requests", "2",
                "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"2 requests, batch 32: p50=\d+\.\dms p99=\d+\.\dms",
                        line), line
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "wide-deep", "--smoke", "--requests", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gatedgcn", "--device", "cpu"])
    assert "no serving cell" in capsys.readouterr().err
