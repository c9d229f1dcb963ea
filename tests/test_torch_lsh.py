"""Port parity: ``core.lsh`` offline dedup (band keys, the S-curve,
candidate pairs, Theorem-1 verification) against the JAX package: equal
keys and pair lists, r̂ to rtol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from repro.core import Hash2U, lowest_bits, minhash_signatures
from repro.core import lsh as jlsh
from repro.data import sparse as jsparse
from repro_torch.convert import family_from_jax
from repro_torch.core import lsh as tlsh
from repro_torch.core.bbit import lowest_bits as t_lowest_bits
from repro_torch.core.minhash import minhash_signatures as t_minhash
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


S = 20
D = 1 << S


def planted_corpus(n_base=240, n_dup=24, size=400, swap=0.05, seed=18):
    """``n_base`` random sets; set ``n_base + i`` copies set i with
    ``swap`` of its ids replaced (R ~ 0.9)."""
    rng = np.random.default_rng(seed)
    sets = [np.unique(rng.integers(0, D, size)) for _ in range(n_base)]
    for i in range(n_dup):
        s = sets[i].copy()
        pos = rng.choice(s.size, int(swap * s.size), replace=False)
        s[pos] = rng.integers(0, D, pos.size)
        sets.append(np.unique(s))
    return sets


@pytest.fixture(scope="module")
def corpus():
    sets = planted_corpus()
    cfg = jlsh.LSHConfig(n_bands=16, rows_per_band=4, b=8)
    fam = Hash2U.create(jax.random.PRNGKey(18), cfg.k, S)
    jb = jsparse.from_lists(sets)
    tb = tsparse.from_lists(sets, device="cpu")
    jsig = lowest_bits(minhash_signatures(jb.indices, jb.mask, fam), cfg.b)
    tsig = t_lowest_bits(t_minhash(tb.indices, tb.mask,
                                   family_from_jax(fam, "cpu")), cfg.b)
    np.testing.assert_array_equal(to_numpy(tsig), np.asarray(jsig))
    return sets, cfg, jsig, tsig


def test_band_keys_equal(corpus):
    _, cfg, jsig, tsig = corpus
    tcfg = tlsh.LSHConfig(cfg.n_bands, cfg.rows_per_band, cfg.b)
    np.testing.assert_array_equal(to_numpy(tlsh.band_keys(tsig, tcfg)),
                                  np.asarray(jlsh.band_keys(jsig, cfg)))
    with pytest.raises(ValueError):
        tlsh.band_keys(tsig[:, :10], tcfg)


def test_dedup_finds_the_planted_pairs(corpus):
    sets, cfg, jsig, tsig = corpus
    sizes = [len(s) for s in sets]
    want = jlsh.dedup(jsig, sizes, D, cfg, threshold=0.8)
    got = tlsh.dedup(tsig, sizes, D,
                     tlsh.LSHConfig(cfg.n_bands, cfg.rows_per_band, cfg.b),
                     threshold=0.8)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    np.testing.assert_allclose([r for _, _, r in got], [r for _, _, r in want],
                               rtol=1e-5)
    assert {(i, j) for i, j, _ in got} == {(i, 240 + i) for i in range(24)}


def test_candidate_pairs_equal_on_crowded_buckets():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 6, (40, 5)).astype(np.uint32)   # buckets of many
    keys[7] = keys[3]
    want = jlsh.candidate_pairs(keys)
    got = tlsh.candidate_pairs(keys)
    assert got == want and (3, 7) in got
    assert tlsh.candidate_pairs(np.arange(12, dtype=np.uint32).reshape(4, 3)) == []
    assert tlsh.dedup(from_numpy(np.arange(16, dtype=np.uint32).reshape(2, 8), "cpu"),
                      [8, 8], 256, tlsh.LSHConfig(2, 4, 8)) == []


@pytest.mark.parametrize("R", [0.2, 0.6, 0.95])
def test_match_probability(R):
    cfg = tlsh.LSHConfig(n_bands=16, rows_per_band=4, b=8)
    want = jlsh.match_probability(R, 800, 800, 2**18,
                                  jlsh.LSHConfig(16, 4, 8))
    assert tlsh.match_probability(R, 800, 800, 2**18, cfg) == \
        pytest.approx(want, rel=1e-5)
    assert cfg.k == 64
