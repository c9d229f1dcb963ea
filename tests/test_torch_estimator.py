"""Port parity: the Appendix-A estimators (Theorem-1 variances, P̂_b, the
OPH variants) and ``oph_match_fraction`` / ``hash_evaluations`` against
the JAX package, rtol 1e-5; and the Appendix-A sequence of
``examples/resemblance.py`` at a small size, with equal signatures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as je
from repro.core import hashing as jh
from repro.core import minhash as jm
from repro.core import oph as joph
from repro.core.bbit import lowest_bits
from repro.data import sparse as jsparse
from repro.data.synthetic import TABLE5_PAIRS, word_pair_sets
from repro_torch.convert import family_from_jax
from repro_torch.core import estimator as te
from repro_torch.core import oph as toph
from repro_torch.core.bbit import lowest_bits as t_lowest_bits
from repro_torch.core.minhash import minhash_signatures
from repro_torch.core.u32 import from_numpy, to_numpy
from repro_torch.data import sparse as tsparse


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f(x):
    return float(np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x))


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_variances(b):
    for R, f1, f2, D, k in [(0.925, 948, 940, 2**18, 256),
                            (0.052, 39063, 2278, 2**18, 64),
                            (0.5, 10, 12, 2**30, 500)]:
        np.testing.assert_allclose(
            _f(te.theoretical_variance(R, f1, f2, D, b, k)),
            _f(je.theoretical_variance(R, f1, f2, D, b, k)), rtol=1e-5)
        assert te.theoretical_variance_minwise(R, k) == \
            je.theoretical_variance_minwise(R, k)
    # arrays of pairs at once
    f1 = np.array([948, 12234, 206]); f2 = np.array([940, 11272, 186])
    R = np.array([0.925, 0.877, 0.712], np.float32)
    np.testing.assert_allclose(
        te.theoretical_variance(torch.from_numpy(R), torch.from_numpy(f1),
                                torch.from_numpy(f2), 2**18, b, 256).numpy(),
        np.asarray(je.theoretical_variance(jnp.asarray(R), jnp.asarray(f1),
                                           jnp.asarray(f2), 2**18, b, 256)),
        rtol=1e-5)


@pytest.mark.parametrize("sentinel", [False, True])
def test_p_hat_and_oph_estimators(sentinel):
    rng = np.random.default_rng(int(sentinel))
    b, k = 4, 64
    s1 = rng.integers(0, 2**b, (5, k)).astype(np.uint32)
    s2 = np.where(rng.random((5, k)) < 0.7, s1,
                  rng.integers(0, 2**b, (5, k))).astype(np.uint32)
    if sentinel:      # EMPTY bins, some jointly empty
        s1[:, :9] = 0xFFFFFFFF
        s2[:, 5:12] = 0xFFFFFFFF
        s1[4], s2[4] = 0xFFFFFFFF, 0xFFFFFFFF       # a row empty in both
    j1, j2 = jnp.asarray(s1), jnp.asarray(s2)
    t1, t2 = from_numpy(s1, "cpu"), from_numpy(s2, "cpu")
    for tf, jf in [(te.empirical_p_hat, je.empirical_p_hat),
                   (te.empirical_p_hat_oph, je.empirical_p_hat_oph),
                   (toph.oph_match_fraction, joph.oph_match_fraction)]:
        np.testing.assert_allclose(tf(t1, t2).numpy(), np.asarray(jf(j1, j2)),
                                   rtol=1e-5)
    np.testing.assert_allclose(
        te.estimate_resemblance_oph(t1, t2, 3000, 2800, 2**20, b).numpy(),
        np.asarray(je.estimate_resemblance_oph(j1, j2, 3000, 2800, 2**20, b)),
        rtol=1e-5, atol=1e-6)


def test_hash_evaluations():
    for scheme in ("minhash", "oph"):
        assert toph.hash_evaluations(10_000, 3728.5, 500, scheme) == \
            joph.hash_evaluations(10_000, 3728.5, 500, scheme)
    with pytest.raises(ValueError):
        toph.hash_evaluations(1, 1, 1, "vw")


def test_appendix_a_sequence():
    """``examples/resemblance.py`` at D = 2^16, k = 64, 3 repetitions over
    the Table-5 pairs that fit: signatures equal, P̂_b and R̂_b to rtol
    1e-5."""
    D, K, reps = 1 << 16, 64, 3
    for name, f1, f2, R in TABLE5_PAIRS:
        if f1 + f2 > D // 8:
            continue
        s1, s2 = word_pair_sets(D, f1, f2, R, seed=1)
        jb = jsparse.from_lists([s1, s2])
        tb = tsparse.from_lists([s1, s2], device="cpu")
        for b in (1, 2, 4):
            for rep in range(reps):
                fam = jh.Hash2U.create(jax.random.PRNGKey(rep * 31 + b), K, 16)
                jsig = lowest_bits(jm.minhash_signatures(jb.indices, jb.mask, fam), b)
                tsig = t_lowest_bits(minhash_signatures(
                    tb.indices, tb.mask, family_from_jax(fam, "cpu")), b)
                np.testing.assert_array_equal(to_numpy(tsig), np.asarray(jsig))
                jp = float(je.empirical_p_hat(jsig[0], jsig[1]))
                tp = float(te.empirical_p_hat(tsig[0], tsig[1]))
                assert tp == pytest.approx(jp, rel=1e-5)
                assert float(te.estimate_resemblance(tp, f1, f2, D, b)) == \
                    pytest.approx(float(je.estimate_resemblance(jp, f1, f2, D, b)),
                                  rel=1e-5, abs=1e-6)
