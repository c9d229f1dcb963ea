"""Port parity for the slice as a whole: raw shards -> SignatureStream ->
SignatureCache (.sig shards) -> OnlineTrainer, and ``preprocess_shards``,
JAX package against the port on ``TINY`` with the same coefficients.

Integers are held bit for bit (the .sig bytes).  The SGD/ASGD weights
are held to rtol 1e-4, atol 1e-6: the gradient is a scatter-add over the
Eq. (5) tokens, and XLA and PyTorch sum colliding tokens in different
orders, so the float32 weights may differ in the last bits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bbit import pack_codes as j_pack_codes
from repro.data import TINY as J_TINY
from repro.data import generate as j_generate
from repro.data.pipeline import SignatureStream as JStream
from repro.data.pipeline import make_sharded_dataset as j_make_sharded
from repro.data.pipeline import read_shard_binary
from repro.data.preprocess import preprocess_shards as j_preprocess
from repro.kernels import batch_signatures as j_batch_signatures
from repro.models import linear as jl
from repro.train import OnlineTrainer as JTrainer
from repro.train import SignatureCache as JCache
from repro.train import make_family as j_make_family
from repro_torch.convert import (coefficients_of, sgd_state_from_jax,
                                  sgd_state_to_numpy)
from repro_torch.core.u32 import from_numpy
from repro_torch.data.pipeline import SignatureStream as TStream
from repro_torch.data.pipeline import make_sharded_dataset as t_make_sharded
from repro_torch.data.preprocess import preprocess_shards as t_preprocess
from repro_torch.data.synthetic import TINY, generate
from repro_torch.kernels import batch_signatures
from repro_torch.models import linear as tl
from repro_torch.train.online import OnlineTrainer as TTrainer
from repro_torch.train.online import SignatureCache as TCache
from repro_torch.train.online import make_family


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, B, S = 128, 8, 16
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def shard_paths(tmp_path_factory):
    return j_make_sharded(J_TINY, str(tmp_path_factory.mktemp("raw")),
                          n_shards=3)


def _families(scheme, densify, seed):
    jfam = j_make_family(jax.random.PRNGKey(seed), scheme, K, S,
                         densify=densify)
    tfam = make_family(scheme, K, S, densify=densify,
                       coefficients=coefficients_of(jfam), device="cpu")
    return jfam, tfam


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("scheme,densify,kind", [
    ("oph", "rotation", "svm"),
    ("oph", "sentinel", "logistic"),
    ("2u", "rotation", "svm"),
])
def test_online_path_matches_reference(shard_paths, tmp_path, scheme,
                                       densify, kind):
    jfam, tfam = _families(scheme, densify, seed=0)
    _, jtest = j_generate(J_TINY)
    _, ttest = generate(TINY, device="cpu")
    jsig_te = j_batch_signatures(jtest, jfam, b=B, backend="interpret",
                                 packed=True)
    tsig_te = batch_signatures(ttest, tfam, b=B, packed=True)
    hyper = dict(k=K, b=B, kind=kind, average=True, lam=1e-4, eta0=0.5,
                 batch_size=16, avg_start=10.0)

    jcache = JCache(JStream(shard_paths, jfam, b=B, chunk_size=64,
                            packed=True, backend="interpret"),
                    cache_dir=str(tmp_path / "jax"))
    tcache = TCache(TStream(shard_paths, tfam, b=B, chunk_size=64,
                            packed=True), cache_dir=str(tmp_path / "torch"))
    with JTrainer(**hyper) as jt, TTrainer(**hyper, device="cpu") as tt:
        _, jstats, jacc = jt.fit(
            jcache, 3, eval_fn=lambda tr: tr.evaluate(jsig_te, jtest.labels))
        _, tstats, tacc = tt.fit(
            tcache, 3, eval_fn=lambda tr: tr.evaluate(tsig_te, ttest.labels))
        jpaths, tpaths = list(jcache.paths), list(tcache.paths)
        assert [os.path.basename(p) for p in jpaths] == \
            [os.path.basename(p) for p in tpaths]
        assert len(tpaths) > 1
        for jp, tp in zip(jpaths, tpaths):
            assert _read(jp) == _read(tp), os.path.basename(tp)
        assert tcache.stats.reduction() > 1.0
        jstate, tstate = sgd_state_to_numpy(jt.state), sgd_state_to_numpy(tt.state)

    assert [s.source for s in tstats] == ["hash", "cache", "cache"]
    assert [s.examples for s in tstats] == [s.examples for s in jstats]
    for key in ("w", "bias", "avg_w", "avg_bias"):
        np.testing.assert_allclose(tstate[key], jstate[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert tstate["t"] == jstate["t"]
    assert np.abs(tstate["avg_w"]).max() > 0          # ASGD ran
    one_example = 1.0 / ttest.n
    np.testing.assert_allclose(tacc, jacc, atol=one_example + 1e-7)
    if kind == "svm":          # logistic at this eta0 learns slower
        assert tacc[-1] > 0.8


@pytest.mark.parametrize("scheme,densify", [("2u", "rotation"),
                                            ("4u", "rotation"),
                                            ("oph", "sentinel")])
def test_preprocess_shards_byte_identical(shard_paths, tmp_path, scheme,
                                          densify):
    jfam, tfam = _families(scheme, densify, seed=1)
    jst = j_preprocess(shard_paths, str(tmp_path / "jax"), jfam, b=B,
                       chunk_size=100, backend="interpret")
    tst = t_preprocess(shard_paths, str(tmp_path / "torch"), tfam, b=B,
                       chunk_size=100)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) > 1
    for name in names:
        assert _read(tmp_path / "jax" / name) == _read(tmp_path / "torch" / name)
    assert (tst.examples, tst.bytes_in, tst.bytes_out) == \
        (jst.examples, jst.bytes_in, jst.bytes_out)


def test_synthetic_shards_match_reference(shard_paths, tmp_path):
    """Both packages draw the same data from the same spec."""
    tpaths = t_make_sharded(TINY, str(tmp_path), n_shards=3)
    for jp, tp in zip(shard_paths, tpaths):
        jsets, jlab = read_shard_binary(jp)
        tsets, tlab = read_shard_binary(tp)
        np.testing.assert_array_equal(tlab, jlab)
        assert len(jsets) == len(tsets)
        for a, b in zip(jsets, tsets):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,sentinel", [("svm", False), ("logistic", True)])
def test_sgd_step_from_converted_state(kind, sentinel):
    """Ten packed-feature steps from the same (converted) state agree."""
    rng = np.random.default_rng(4)
    k, b, n = 64, 4, 16
    dim = k << b
    jstate = jl.sgd_svm_init(dim, avg_start=3.0)
    jstate.model.w = jnp.asarray(rng.normal(size=dim).astype(np.float32))
    tstate = sgd_state_from_jax(jstate, "cpu")
    code_bits = b + 1 if sentinel else b
    step = dict(lam=1e-3, eta0=0.25, b=b, feature_kind="packed", kind=kind,
                average=True, k=k, sentinel=sentinel)
    for _ in range(10):
        v = rng.integers(0, 2**code_bits if sentinel else 2**b, (n, k))
        words = np.asarray(j_pack_codes(jnp.asarray(v.astype(np.uint32)),
                                        code_bits))
        y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
        jstate = jl.sgd_svm_step(jstate, jnp.asarray(words), jnp.asarray(y),
                                 **step)
        tl.sgd_svm_step(tstate, from_numpy(words, "cpu"), torch.from_numpy(y),
                        **step)
    want, got = sgd_state_to_numpy(jstate), sgd_state_to_numpy(tstate)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    jm, tm = jl.asgd_model(jstate), tl.asgd_model(tstate)
    np.testing.assert_allclose(tm.w.numpy(), np.asarray(jm.w), rtol=RTOL,
                               atol=ATOL)

