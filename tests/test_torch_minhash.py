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
from repro_torch.convert import family_from_jax
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
    """k = 100 is not a whole number of 128-lane blocks: the packed words
    come from the unfused pack epilogue in both packages."""
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
