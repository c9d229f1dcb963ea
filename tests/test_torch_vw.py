"""Port parity: ``core.vw.VWHasher`` in both randomness modes against the
JAX package, identical vectors; and the dense baseline it feeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.vw import VWHasher as JVW
from repro.data import sparse as jsparse
from repro_torch.convert import vw_from_jax
from repro_torch.core.vw import VWHasher
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


D = 1 << 16


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(12)
    sets = [rng.choice(D, rng.integers(1, 300), replace=False) for _ in range(9)]
    sets.insert(3, np.zeros(0, np.int64))
    return (jsparse.from_lists(sets, max_nnz=384),
            tsparse.from_lists(sets, max_nnz=384, device="cpu"))


@pytest.mark.parametrize("m_bits", [1, 6, 10])
@pytest.mark.parametrize("mode", ["full", "u2"])
def test_vw_vectors_identical(batches, mode, m_bits):
    jb, tb = batches
    ref = JVW.create(jax.random.PRNGKey(m_bits), m_bits, mode=mode, D=D)
    port = vw_from_jax(ref, "cpu")
    want = np.asarray(ref(jb.indices, jb.mask))
    got = port(tb.indices, tb.mask)
    assert got.dtype == torch.float32 and got.shape == (10, 1 << m_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[3] == 0).all()                    # the empty set
    # a binary row's entries are signed counts summing to +-(its nnz)
    nnz = tb.nnz_per_row().numpy()
    assert (np.abs(got.numpy()).sum(1) <= nnz).all()


def test_vw_bins_signs_and_values(batches):
    jb, tb = batches
    ref = JVW.create(jax.random.PRNGKey(3), 8, mode="u2")
    port = vw_from_jax(ref, "cpu")
    t = np.array([0, 1, D - 1, 12345], np.int32)
    jbins, jsigns = ref.bins_and_signs(jnp.asarray(t))
    bins, signs = port.bins_and_signs(torch.from_numpy(t))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    vals = np.random.default_rng(0).standard_normal(jb.indices.shape).astype(np.float32)
    want = np.asarray(ref(jb.indices, jb.mask, jnp.asarray(vals)))
    got = port(tb.indices, tb.mask, torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_vw_create_is_seeded():
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    for mode in ("full", "u2"):
        a = VWHasher.create(5, mode, D=1000, generator=g1, device="cpu")
        b = VWHasher.create(5, mode, D=1000, generator=g2, device="cpu")
        x = torch.arange(0, 1000, dtype=torch.int32)
        assert torch.equal(a.bins_and_signs(x)[0], b.bins_and_signs(x)[0])
        bins, signs = a.bins_and_signs(x)
        assert int(bins.min()) >= 0 and int(bins.max()) < 32
        assert set(signs.unique().tolist()) == {-1.0, 1.0}
    with pytest.raises(ValueError):
        VWHasher.create(5, "full", device="cpu")
