"""Port parity: the OPH kernels' plain versions, the densifiers and the
OPH engine path against the JAX package, bit-exact.

The JAX kernels run as the JAX tests run them on the CPU: Pallas in
interpret mode (engine backend ``"interpret"``); ``repro.kernels.ref``
is the second reference.  Every batch holds rows with no nonzero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oph as joph
from repro.data.sparse import from_lists as j_from_lists
from repro.kernels import batch_signatures as j_batch_signatures
from repro.kernels import ref as jref
from repro.kernels.oph import oph2u_pallas, oph4u_pallas
from repro_torch.convert import family_from_jax
from repro_torch.core import oph as toph
from repro_torch.core.u32 import EMPTY, from_numpy, to_numpy
from repro_torch.data.sparse import from_lists
from repro_torch.kernels import batch_signatures
from repro_torch.kernels import oph as koph


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


def _sets(n, seed, D=1 << S, max_set=200):
    rng = np.random.default_rng(seed)
    sets = [rng.choice(D, rng.integers(1, max_set + 1), replace=False)
            for _ in range(n - 2)]
    return sets[:3] + [np.zeros(0, np.int64)] + sets[3:] + [np.zeros(0, np.int64)]


@pytest.fixture(scope="module")
def batches():
    sets = _sets(16, seed=5)
    return (j_from_lists(sets, max_nnz=NNZ),
            from_lists(sets, max_nnz=NNZ, device="cpu"))


@pytest.mark.parametrize("code_b", [0, 8])
@pytest.mark.parametrize("family", ["2u", "4u"])
def test_oph_kernel_plain_vs_pallas(batches, family, code_b):
    jb, tb = batches
    k = 64
    bin_bits = k.bit_length() - 1
    fam = joph.OPH.create(jax.random.PRNGKey(11), k, S, family).base
    counts = jnp.sum(jb.mask.astype(jnp.int32), axis=1, keepdims=True)
    tcounts = tb.nnz_per_row()
    assert int(tcounts.min()) == 0
    if family == "2u":
        want = oph2u_pallas(jb.indices, counts, fam.a1, fam.a2, s=S,
                            bin_bits=bin_bits, code_b=code_b, interpret=True)
        ref = jref.oph2u_ref(jb.indices, counts, fam.a1, fam.a2, s=S,
                             bin_bits=bin_bits, k_lanes=128)
        got = koph.oph2u(tb.indices, tcounts, from_numpy(fam.a1, "cpu"),
                         from_numpy(fam.a2, "cpu"), s=S, bin_bits=bin_bits,
                         code_b=code_b)
    else:
        want = oph4u_pallas(jb.indices, counts, fam.a, s=S, bin_bits=bin_bits,
                            code_b=code_b, interpret=True)
        ref = jref.oph4u_ref(jb.indices, counts, fam.a, s=S,
                             bin_bits=bin_bits, k_lanes=128)
        got = koph.oph4u(tb.indices, tcounts, from_numpy(fam.a, "cpu"), s=S,
                         bin_bits=bin_bits, code_b=code_b)
    assert got.shape == (16, k)
    want = np.asarray(want)[:, :k]
    np.testing.assert_array_equal(to_numpy(got), want)
    ref = np.asarray(ref)[:, :k]
    if code_b:
        ref = np.where(ref == 0xFFFFFFFF, 1 << code_b, ref & ((1 << code_b) - 1))
    np.testing.assert_array_equal(want, ref)
    empty_rows = to_numpy(got)[[3, 15]]
    assert (empty_rows == (1 << code_b if code_b else 0xFFFFFFFF)).all()


@pytest.mark.parametrize("densify,b,packed", [
    (d, b, p) for d in ("rotation", "sentinel", "optimal", "fast")
    for b, p in ((0, False), (8, False), (8, True))])
def test_oph2u_engine_vs_interpret(batches, densify, b, packed):
    jb, tb = batches
    fam = joph.OPH.create(jax.random.PRNGKey(3), 64, S, "2u", densify)
    want = j_batch_signatures(jb, fam, b=b, backend="interpret", packed=packed)
    got = batch_signatures(tb, family_from_jax(fam, "cpu"), b=b, packed=packed)
    if packed:
        assert (got.k, got.b, got.sentinel) == (want.k, want.b, want.sentinel)
        want, got = want.data, got.data
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("densify", ["rotation", "sentinel"])
def test_oph4u_engine_packed_vs_interpret(batches, densify):
    jb, tb = batches
    fam = joph.OPH.create(jax.random.PRNGKey(4), 128, S, "4u", densify)
    want = j_batch_signatures(jb, fam, b=8, backend="interpret", packed=True)
    got = batch_signatures(tb, family_from_jax(fam, "cpu"), b=8, packed=True)
    np.testing.assert_array_equal(to_numpy(got.data), np.asarray(want.data))


def test_oph_permutation_reference(batches):
    jb, tb = batches
    fam = joph.OPH.create(jax.random.PRNGKey(8), 64, S, "perm", "rotation")
    want = joph.oph_signatures(jb.indices, jb.mask, fam, b=8)
    got = batch_signatures(tb, family_from_jax(fam, "cpu"), b=8)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("densify", ["rotation", "optimal", "fast"])
def test_densifiers_bit_exact(densify):
    """Sparse sentinel rows (most bins empty), an all-empty row, and a
    bin width near 2^31 so rotation's ``donor + C*dist`` wraps."""
    rng = np.random.default_rng(9)
    k, bin_width = 64, 1 << 25
    sig = rng.integers(0, bin_width, (6, k)).astype(np.uint32)
    sig[rng.random((6, k)) < 0.8] = 0xFFFFFFFF
    sig[2] = 0xFFFFFFFF
    fn_j = {"rotation": lambda x: joph.densify_rotation(x, bin_width),
            "optimal": joph.densify_optimal, "fast": joph.densify_fast}
    fn_t = {"rotation": lambda x: toph.densify_rotation(x, bin_width),
            "optimal": toph.densify_optimal, "fast": toph.densify_fast}
    want = np.asarray(fn_j[densify](jnp.asarray(sig)))
    got = to_numpy(fn_t[densify](from_numpy(sig, "cpu")))
    np.testing.assert_array_equal(got, want)
    assert (got[2] == 0xFFFFFFFF).all() and (got[[0, 1, 3]] != 0xFFFFFFFF).all()
    if densify == "rotation":
        assert (got.astype(np.uint64) < bin_width).sum() < got.size  # borrowed


def test_split_hash_and_oph_validation():
    h = np.array([0, 1, 2**16 - 1, 12345], np.uint32)
    jb_, jo = joph.split_hash(jnp.asarray(h), 16, 6)
    tb_, to_ = toph.split_hash(torch.from_numpy(h.astype(np.int64)), 16, 6)
    np.testing.assert_array_equal(tb_.numpy(), np.asarray(jb_))
    np.testing.assert_array_equal(to_.numpy(), np.asarray(jo))
    base = toph.Hash2U.create(1, 16, device="cpu")
    with pytest.raises(ValueError):
        toph.OPH(base, 48)
    with pytest.raises(ValueError):
        toph.OPH(base, 64, "bogus")
    assert int(EMPTY) == 0xFFFFFFFF
