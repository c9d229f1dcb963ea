"""Port parity: ``core.minhash`` (permutations, 2U both variants, 4U BitMod
and 4U Mod), the 4U Mod arithmetic, the Eq. (5) one-hot expansion and the
storage accounting, the sparse helpers, the Appendix-A word pairs and the
legacy ``kernels.ops`` wrappers against the JAX package.  Integer outputs
are bit-identical; floats agree to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bbit as jbbit
from repro.core import hashing as jh
from repro.core import minhash as jm
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro_torch.convert import family_from_jax
from repro_torch.core import bbit as tbbit
from repro_torch.core import hashing as th
from repro_torch.core import minhash as tm
from repro_torch.core.u32 import from_numpy, narrow, to_numpy
from repro_torch.data import sparse as tsparse
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S, D = 16, 1 << 16
P = 2**31 - 1


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(18)
    out = [rng.choice(D, rng.integers(1, 200), replace=False) for _ in range(11)]
    return out[:4] + [np.zeros(0, np.int64)] + out[4:]


def _jax_family(name, k):
    key = jax.random.PRNGKey(k + 7)
    if name == "perm":
        return jh.PermutationFamily.create(key, k, D)
    if name in ("2u-high", "2u-low"):
        return jh.Hash2U.create(key, k, S, name[3:])
    return jh.Hash4U.create(key, k, S, use_bitmod=name == "4u-bitmod")


@pytest.mark.parametrize("k", [1, 64, 96])
@pytest.mark.parametrize("name", ["perm", "2u-high", "2u-low", "4u-bitmod",
                                  "4u-mod"])
def test_minhash_signatures_bit_exact_and_padding_invariant(sets, name, k):
    fam = _jax_family(name, k)
    port = family_from_jax(fam, "cpu")
    outs = []
    for max_nnz in (256, 384):           # padding must not change a signature
        jb = jsparse.from_lists(sets, max_nnz=max_nnz)
        tb = tsparse.from_lists(sets, max_nnz=max_nnz, device="cpu")
        want = np.asarray(jm.minhash_signatures(jb.indices, jb.mask, fam))
        got = to_numpy(tm.minhash_signatures(tb.indices, tb.mask, port))
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[0][4] == 0xFFFFFFFF).all()         # the empty set


@pytest.mark.parametrize("name", ["perm", "2u-high", "4u-mod"])
def test_minhash_signatures_honour_any_mask_on_the_cpu(sets, name):
    """On the CPU the plain path takes any mask, as the reference does."""
    fam = _jax_family(name, 64)
    jb = jsparse.from_lists(sets, max_nnz=256)
    mask = np.asarray(jb.mask) & (np.random.default_rng(1).random((len(sets), 256)) < 0.6)
    want = np.asarray(jm.minhash_signatures(jb.indices, jnp.asarray(mask), fam))
    got = tm.minhash_signatures(torch.from_numpy(np.array(jb.indices)),
                                torch.from_numpy(mask),
                                family_from_jax(fam, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_prefix_counts_refuses_a_hole():
    mask = torch.tensor([[True, True, False], [True, False, False],
                         [False, False, False]])
    assert tm.prefix_counts(mask).tolist() == [2, 1, 0]
    with pytest.raises(ValueError, match="valid lanes first"):
        tm.prefix_counts(torch.tensor([[True, False, True]]))


def test_4u_mod_matches_reference_everywhere_and_bitmod_in_domain():
    """Mod is a true modulo: bit-exact with the reference's Mod path for
    coefficients >= p and indices >= 2^31 too, where BitMod parts from it;
    inside the domain the two agree."""
    rng = np.random.default_rng(4)
    t = np.concatenate([[0, 1, P - 1, P, 2**31, 2**32 - 1],
                        rng.integers(0, 2**32, 300)]).astype(np.uint32)
    for hi_coef in (P, 2**32):
        a = rng.integers(0, hi_coef, (4, 1), dtype=np.int64).astype(np.uint32)
        a = np.concatenate([a, np.array([[P], [P + 1], [2**32 - 1], [0]],
                                        np.uint32)], axis=1)
        for bitmod in (True, False):
            want = np.asarray(jh.Hash4U(jnp.asarray(a), 24, bitmod)(jnp.asarray(t)))
            port = th.Hash4U.from_numpy(a, 24, "cpu", use_bitmod=bitmod)
            got = to_numpy(narrow(port(torch.from_numpy(t.view(np.int32)))))
            np.testing.assert_array_equal(got, want)
    a = rng.integers(0, P, (4, 16), dtype=np.int64).astype(np.uint32)
    t_dom = torch.from_numpy(rng.integers(0, 2**31, 500).astype(np.int32))
    mod = th.Hash4U.from_numpy(a, 31, "cpu", use_bitmod=False)
    bit = th.Hash4U.from_numpy(a, 31, "cpu")
    assert torch.equal(mod(t_dom), bit(t_dom))


def test_slow_mod_mersenne31_bit_exact():
    rng = np.random.default_rng(5)
    hi = np.concatenate([[0, 1, P, 2**32 - 1], rng.integers(0, 2**32, 200)]).astype(np.uint32)
    lo = np.concatenate([[0, P, 2**32 - 1, 2**32 - 1], rng.integers(0, 2**32, 200)]).astype(np.uint32)
    want = np.asarray(jh._slow_mod_mersenne31(jnp.asarray(hi), jnp.asarray(lo)))
    got = th._slow_mod_mersenne31(torch.from_numpy(hi.astype(np.int64)),
                                  torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(to_numpy(narrow(got)), want)


def test_permutation_family_layout_and_storage():
    ref = jh.PermutationFamily.create(jax.random.PRNGKey(2), 5, 256)
    port = family_from_jax(ref, "cpu")
    assert port.table.shape == (256, 5) and port.table.is_contiguous()
    np.testing.assert_array_equal(port.perms.numpy(), np.asarray(ref.perms))
    t = np.array([0, 3, 255, 17], np.int32)
    np.testing.assert_array_equal(port(torch.from_numpy(t)).numpy(),
                                  np.asarray(ref(jnp.asarray(t))))
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    p1 = th.PermutationFamily.create(4, 300, generator=g1, device="cpu")
    p2 = th.PermutationFamily.create(4, 300, generator=g2, device="cpu")
    assert torch.equal(p1.table, p2.table)
    assert (p1.table.sort(dim=0).values == torch.arange(300)[:, None]).all()
    for fam in (ref, jh.Hash2U.create(jax.random.PRNGKey(0), 200, 24),
                jh.Hash4U.create(jax.random.PRNGKey(0), 200, 24)):
        assert th.family_storage_bytes(family_from_jax(fam, "cpu")) == \
            jh.family_storage_bytes(fam)
    assert th.family_storage_bytes(th.Hash2U.create(200, 24, device="cpu")) == 1600


@pytest.mark.parametrize("b", [1, 4])
def test_expand_onehot_and_matches(b):
    rng = np.random.default_rng(b)
    sig = rng.integers(0, 2**b, (6, 9)).astype(np.uint32)
    sig[0, :3] = [2**b, 2**b + 5, 0xFFFFFFFF]       # out of its block
    want = np.asarray(jbbit.expand_onehot(jnp.asarray(sig), b))
    got = tbbit.expand_onehot(from_numpy(sig, "cpu"), b)
    np.testing.assert_array_equal(got.numpy(), want)
    s2 = np.where(rng.random(sig.shape) < 0.5, sig, sig ^ 1).astype(np.uint32)
    np.testing.assert_allclose(
        tm.signature_matches(from_numpy(sig, "cpu"), from_numpy(s2, "cpu")).numpy(),
        np.asarray(jm.signature_matches(jnp.asarray(sig), jnp.asarray(s2))),
        rtol=1e-5)
    x1, x2 = (rng.random((4, 30)) < 0.4).astype(np.float32), (rng.random((4, 30)) < 0.4).astype(np.float32)
    np.testing.assert_allclose(
        tm.resemblance(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
        np.asarray(jm.resemblance(jnp.asarray(x1), jnp.asarray(x2))), rtol=1e-5)


def test_storage_bits():
    assert tbbit.storage_bits(200, 8) == jbbit.storage_bits(200, 8) == 1600
    assert tbbit.vw_storage_bits(256) == jbbit.vw_storage_bits(256)
    assert tbbit.vw_storage_bits(1 << 14, 16) == jbbit.vw_storage_bits(1 << 14, 16)
    assert tbbit.raw_storage_bits(3728.5) == jbbit.raw_storage_bits(3728.5)


def test_sparse_helpers(sets):
    x = np.arange(10).reshape(2, 5)
    for mult, axis in ((4, 1), (3, 0), (5, 1)):
        np.testing.assert_array_equal(tsparse.pad_to_multiple(x, mult, axis, 7),
                                      jsparse.pad_to_multiple(x, mult, axis, 7))
    jb = jsparse.from_lists(sets, np.ones(len(sets)), max_nnz=256)
    tb = tsparse.from_lists(sets, np.ones(len(sets)), max_nnz=256, device="cpu")
    np.testing.assert_array_equal(tsparse.to_dense(tb, D).numpy(),
                                  np.asarray(jsparse.to_dense(jb, D)))
    for start, size in ((0, 3), (4, 5), (10, 4)):     # (10, 4) runs past the end
        js, ts = jsparse.slice_batch(jb, start, size), tsparse.slice_batch(tb, start, size)
        np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
        np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
        np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))


def test_word_pairs_and_table5():
    assert tsyn.TABLE5_PAIRS == jsyn.TABLE5_PAIRS
    for _, f1, f2, R in tsyn.TABLE5_PAIRS[:4]:
        for a, b in zip(tsyn.word_pair_sets(1 << 18, f1, f2, R, seed=1),
                        jsyn.word_pair_sets(1 << 18, f1, f2, R, seed=1)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["minhash2u", "minhash4u", "oph2u",
                                   "oph4u", "sigbag", "batch_signatures"])
def test_legacy_ops(sets, which):
    jb = jsparse.from_lists(sets, max_nnz=256)
    tb = tsparse.from_lists(sets, max_nnz=256, device="cpu")
    jc = jnp.sum(jb.mask.astype(jnp.int32), axis=1, keepdims=True)
    tc = tb.nnz_per_row()[:, None]
    key = jax.random.PRNGKey(11)
    if which == "minhash2u":
        f = jh.Hash2U.create(key, 64, S)
        want = jops.minhash2u(jb.indices, jc, f.a1, f.a2, s=S, b=8, use_pallas=False)
        got = tops.minhash2u(tb.indices, tc, from_numpy(f.a1, "cpu"),
                             from_numpy(f.a2, "cpu"), s=S, b=8)
    elif which == "minhash4u":
        f = jh.Hash4U.create(key, 64, S)
        want = jops.minhash4u(jb.indices, jc, f.a, s=S, b=4, use_pallas=False)
        got = tops.minhash4u(tb.indices, tc, from_numpy(f.a, "cpu"), s=S, b=4)
    elif which == "oph2u":
        f = jh.Hash2U.create(key, 1, S)
        want = jops.oph2u(jb.indices, jc, f.a1, f.a2, s=S, k=64, b=8, use_pallas=False)
        got = tops.oph2u(tb.indices, tc, from_numpy(f.a1, "cpu"),
                         from_numpy(f.a2, "cpu"), s=S, k=64, b=8)
    elif which == "oph4u":
        f = jh.Hash4U.create(key, 1, S)
        want = jops.oph4u(jb.indices, jc, f.a, s=S, k=32, densify="sentinel",
                          b=4, use_pallas=False)
        got = tops.oph4u(tb.indices, tc, from_numpy(f.a, "cpu"), s=S, k=32,
                         densify="sentinel", b=4)
    elif which == "sigbag":
        rng = np.random.default_rng(3)
        tok = rng.integers(0, 16, (7, 5)).astype(np.int32)
        table = rng.standard_normal((5, 16, 4)).astype(np.float32)
        want = jops.sigbag(jnp.asarray(tok), jnp.asarray(table), use_pallas=False)
        got = tops.sigbag(torch.from_numpy(tok), torch.from_numpy(table))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        return
    else:
        f = jh.Hash2U.create(key, 128, S)
        want = jops.batch_signatures(jb, f, b=8)
        got = tops.batch_signatures(tb, family_from_jax(f, "cpu"), b=8)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
