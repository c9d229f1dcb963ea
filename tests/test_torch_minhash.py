"""Port parity: the k-pass minhash kernels' plain versions (with the fused
b-bit mask and pack epilogue) and the minhash engine path against the
JAX package, bit-exact.

The JAX kernels run in Pallas interpret mode, as the JAX tests run them on
the CPU; ``repro.kernels.ref`` is the second reference.  Every batch
holds rows with no nonzero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import Hash2U, Hash4U
from repro.data.sparse import from_lists as j_from_lists
from repro.kernels import batch_signatures as j_batch_signatures
from repro.kernels import ref as jref
from repro.kernels.minhash import minhash2u_pallas, minhash4u_pallas
from repro.kernels.pack import pack_block as j_pack_block
from repro_torch.convert import family_from_jax
from repro_torch.core.bbit import pack_codes
from repro_torch.core.u32 import from_numpy, to_numpy
from repro_torch.data.sparse import from_lists
from repro_torch.kernels import batch_signatures
from repro_torch.kernels import minhash as kmin


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S, NNZ = 16, 256


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(6)
    sets = [rng.choice(1 << S, rng.integers(1, 220), replace=False)
            for _ in range(14)]
    sets = sets[:5] + [np.zeros(0, np.int64)] + sets[5:] + [np.zeros(0, np.int64)]
    return (j_from_lists(sets, max_nnz=NNZ),
            from_lists(sets, max_nnz=NNZ, device="cpu"))


@pytest.mark.parametrize("b,pack", [(0, False), (8, False), (8, True)])
@pytest.mark.parametrize("family", ["2u", "4u"])
def test_minhash_kernel_plain_vs_pallas(batches, family, b, pack):
    jb, tb = batches
    k = 128
    counts = jnp.sum(jb.mask.astype(jnp.int32), axis=1, keepdims=True)
    tcounts = tb.nnz_per_row()
    if family == "2u":
        fam = Hash2U.create(jax.random.PRNGKey(1), k, S)
        want = minhash2u_pallas(jb.indices, counts, fam.a1, fam.a2, s=S, b=b,
                                pack=pack, interpret=True)
        ref = jref.minhash2u_ref(jb.indices, counts, fam.a1, fam.a2, s=S, b=b)
        got = kmin.minhash2u(tb.indices, tcounts, from_numpy(fam.a1, "cpu"),
                             from_numpy(fam.a2, "cpu"), s=S, b=b, pack=pack)
    else:
        fam = Hash4U.create(jax.random.PRNGKey(2), k, S)
        want = minhash4u_pallas(jb.indices, counts, fam.a, s=S, b=b,
                                pack=pack, interpret=True)
        ref = jref.minhash4u_ref(jb.indices, counts, fam.a, s=S, b=b)
        got = kmin.minhash4u(tb.indices, tcounts, from_numpy(fam.a, "cpu"),
                             s=S, b=b, pack=pack)
    if pack:
        np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))
    # empty sets: every lane keeps the 0xFFFFFFFF pad, b-bit masked
    assert (to_numpy(got)[[5, 15]] == (0xFFFFFFFF if b == 0 else 2**b - 1)).all()


@pytest.mark.parametrize("k", [64, 100])
@pytest.mark.parametrize("family", ["2u", "4u"])
def test_minhash_engine_packed_vs_interpret(batches, family, k):
    """k = 100 is not a whole number of 128-lane blocks: the reference
    packs after its kernel, the port in its kernel's epilogue (here its
    plain version), with the same words."""
    jb, tb = batches
    cls = Hash2U if family == "2u" else Hash4U
    fam = cls.create(jax.random.PRNGKey(k), k, S)
    want = j_batch_signatures(jb, fam, b=8, backend="interpret", packed=True)
    got = batch_signatures(tb, family_from_jax(fam, "cpu"), b=8, packed=True)
    assert (got.k, got.b, got.code_bits) == (want.k, want.b, want.code_bits)
    np.testing.assert_array_equal(to_numpy(got.data), np.asarray(want.data))


@pytest.mark.parametrize("variant", ["high", "low"])
@pytest.mark.parametrize("k,b", [(64, 0), (100, 8), (128, 4)])
def test_minhash2u_engine_vs_ref(batches, k, b, variant):
    jb, tb = batches
    fam = Hash2U.create(jax.random.PRNGKey(k + b), k, S, variant=variant)
    want = j_batch_signatures(jb, fam, b=b, backend="ref")
    got = batch_signatures(tb, family_from_jax(fam, "cpu"), b=b)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_minhash_plain_row_chunking(batches, monkeypatch):
    """The plain version's row chunks (which bound its (rows, nnz, k)
    intermediate) give the same result as one pass."""
    _, tb = batches
    fam = family_from_jax(Hash4U.create(jax.random.PRNGKey(9), 128, S), "cpu")
    counts = tb.nnz_per_row()
    whole = kmin.minhash4u_plain(tb.indices, counts, fam.a, s=S, b=8,
                                 pack=True)
    monkeypatch.setattr(kmin, "_PLAIN_ELEMS", NNZ * 128 * 3)   # 3 rows a chunk
    chunked = kmin.minhash4u_plain(tb.indices, counts, fam.a, s=S, b=8,
                                   pack=True)
    for w, c in zip(whole, chunked):
        np.testing.assert_array_equal(to_numpy(c), to_numpy(w))


# The fused pack at any k: 1 (one live lane), 33 (a warp and one lane),
# 100 and the paper's 500 (a ragged last warp), 640 (two blocks a row at
# 128 threads, the second partly live)
RAGGED_K = (1, 33, 100, 500, 640)


@pytest.fixture(scope="module")
def ragged(batches):
    """Rows 3-8 of ``batches``, their first 64 slots (row 5 empty): the
    reference's batch and the port's indices and counts."""
    jb, tb = batches
    jidx, jmask = jb.indices[3:9, :64], jb.mask[3:9, :64]
    counts = jnp.sum(jmask.astype(jnp.int32), axis=1, keepdims=True)
    return (jidx, counts), (tb.indices[3:9, :64].contiguous(),
                            tb.mask[3:9, :64].sum(1, dtype=torch.int32))


@pytest.fixture(scope="module")
def ragged_want(ragged):
    """(family, k, b) -> the port's coefficients, the reference's b-bit
    minima and its ``pack_block`` words of them; the minima once for each
    (family, k), masked to b bits as the reference masks them."""
    (jidx, counts), _ = ragged
    minima, words = {}, {}

    def want(family, k, b):
        if (family, k, b) in words:
            return words[family, k, b]
        if (family, k) not in minima:
            key = jax.random.PRNGKey(100 + k)
            if family == "2u":
                fam = Hash2U.create(key, k, S)
                coef = (fam.a1, fam.a2)
                sig = jref.minhash2u_ref(jidx, counts, *coef, s=S)
            else:
                fam = Hash4U.create(key, k, S)
                coef = (fam.a,)
                sig = jref.minhash4u_ref(jidx, counts, fam.a, s=S)
            minima[family, k] = (tuple(from_numpy(np.asarray(c), "cpu")
                                       for c in coef), sig)
        coef, sig = minima[family, k]
        sig = sig & jnp.uint32((1 << b) - 1)
        words[family, k, b] = (coef, np.asarray(sig),
                               np.asarray(j_pack_block(sig, b)))
        return words[family, k, b]

    return want


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("k", RAGGED_K)
@pytest.mark.parametrize("family", ["2u", "4u"])
def test_minhash_plain_packs_any_k(ragged, ragged_want, family, k, b,
                                   threads):
    """``pack=True`` at every k, code width dividing 32 and launch shape:
    ceil(k b / 32) words a row, zero padded past k, equal to the
    ``pack_codes`` bitstream of the codes and to the reference's
    ``pack_block`` of its own minima."""
    _, (idx, counts) = ragged
    coef, sig_want, words_want = ragged_want(family, k, b)
    fn = kmin.minhash2u if family == "2u" else kmin.minhash4u
    sig, words = fn(idx, counts, *coef, s=S, b=b, pack=True, threads=threads)
    assert words.shape == (idx.shape[0], -(-k * b // 32))
    np.testing.assert_array_equal(to_numpy(sig), sig_want)
    np.testing.assert_array_equal(to_numpy(words), words_want)
    assert torch.equal(words, pack_codes(sig, b))


def _kernel_epilogue_words(codes, b, threads, four_u):
    """A model of ``csrc/minhash.cu``'s fused pack: the launch geometry of
    ``minhash2u_launch`` / ``minhash4u_launch`` (2U's block cut to k
    rounded up to 32, one function a thread when that block covers k,
    else JPT = 4; 4U always JPT), and ``pack_codes_warp`` in every warp
    whose first lane is live: lanes past k give 0, and a word is stored
    only where its first code is live.  Stores go into rows 64 words
    wider than ceil(k b / 32), so a stray store shows; a second store of
    one word raises."""
    n, k = codes.shape
    bd = threads if four_u else min(threads, -(-k // 32) * 32)
    jpt = 4 if four_u or k > bd else 1
    per = 32 // b
    out = np.full((n, -(-k * b // 32) + 64), -1, np.int64)
    stored = set()
    for by in range(-(-k // (bd * jpt))):
        for u in range(jpt):
            for warp in range(0, bd, 32):
                first = by * bd * jpt + u * bd + warp
                if first >= k:
                    continue
                j = first + np.arange(32)
                lanes = np.where(j < k, codes[:, np.minimum(j, k - 1)], 0)
                for lane in range(0, 32, per):
                    if first + lane >= k:
                        continue
                    w = (first + lane) // per
                    assert w not in stored, f"word {w} stored twice"
                    stored.add(w)
                    out[:, w] = sum(lanes[:, lane + i] << (i * b)
                                    for i in range(per))
    return out


@pytest.mark.parametrize("k", RAGGED_K + (1024,))
@pytest.mark.parametrize("family", ["2u", "4u"])
def test_kernel_epilogue_model_packs_any_k(family, k):
    """The kernel's pack rule, modelled at every launch shape a table may
    name and every code width dividing 32 up to 16: each of a row's
    ceil(k b / 32) words stored once and equal to ``pack_codes``, none
    past the row's end."""
    rng = np.random.default_rng(k)
    for b in (1, 2, 4, 8, 16):
        codes = rng.integers(0, 1 << b, (3, k))
        want = to_numpy(pack_codes(from_numpy(codes, "cpu"), b))
        for threads in kmin.MINHASH_THREADS:
            got = _kernel_epilogue_words(codes, b, threads, family == "4u")
            words = want.shape[1]
            assert (got[:, words:] == -1).all(), (b, threads)
            np.testing.assert_array_equal(got[:, :words], want.astype(np.int64),
                                          err_msg=f"b={b} threads={threads}")
