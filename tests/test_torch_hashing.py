"""Port parity: 2U / 4U hashing and BitMod against ``repro.core.hashing``,
bit-exact, including adversarial coefficients and indices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro_torch.core import hashing as th
from repro_torch.core.u32 import M32, from_numpy, narrow, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


P = 2**31 - 1
RNG = np.random.default_rng(20)
# indices: the extremes, then random ids over [0, 2^31)
T = np.concatenate([[0, 1, 2**31 - 1, 2**31 - 2, 65535, 65536],
                    RNG.integers(0, 2**31, 250)]).astype(np.int32)


def _port(x) -> np.ndarray:
    return to_numpy(narrow(x))


@pytest.mark.parametrize("variant", ["high", "low"])
@pytest.mark.parametrize("s", [16, 24, 31, 32])
def test_hash2u_bit_exact(s, variant):
    a1 = np.concatenate([[0, 2**32 - 1, 1, 2**32 - 1],
                         RNG.integers(0, 2**32, 12)]).astype(np.uint32)
    a2 = np.concatenate([[1, 2**32 - 1, 2**32 - 1, 2**31 + 1],
                         RNG.integers(0, 2**32, 12) | 1]).astype(np.uint32)
    ref = jh.Hash2U(jnp.asarray(a1), jnp.asarray(a2), s, variant)
    port = th.Hash2U.from_numpy(a1, a2, s, variant, device="cpu")
    want = np.asarray(ref(jnp.asarray(T)))
    np.testing.assert_array_equal(_port(port(torch.from_numpy(T))), want)


@pytest.mark.parametrize("s", [16, 24, 31])
def test_hash4u_bit_exact(s):
    # coefficients at and around p: p-1, p and p+1 lie outside the
    # reference's documented domain (< p) but must still agree bit for bit;
    # a3 = p with a4 = 0 drives BitMod through v2 == p
    edge = np.array([[0, P - 1, P, P + 1, 5, 0],
                     [P - 1, P, P + 1, 0, 7, 0],
                     [P, P + 1, 1, P - 1, 9, P],
                     [P + 1, 0, P - 1, P, 2**31, 0]], np.uint32)
    a = np.concatenate([edge, RNG.integers(0, P, (4, 10)).astype(np.uint32)],
                       axis=1)
    ref = jh.Hash4U(jnp.asarray(a), s)
    port = th.Hash4U.from_numpy(a, s, device="cpu")
    want = np.asarray(ref(jnp.asarray(T)))
    np.testing.assert_array_equal(_port(port(torch.from_numpy(T))), want)


def test_mod_mersenne31_bit_exact():
    """BitMod on raw (hi, lo) pairs: v = p, 2p, p - 1, the v2 == p case
    (v1 = p), and random values below 2^62."""
    vals = [0, 1, P - 1, P, P + 1, 2 * P, 2 * P + 1, 2**31, 2**32 - 1,
            2**62 - 1, P * P, (2**30 - 1) << 32]
    vals += [int(v) for v in RNG.integers(0, 2**62, 200, dtype=np.int64)]
    hi = np.array([v >> 32 for v in vals], np.uint32)
    lo = np.array([v & M32 for v in vals], np.uint32)
    want = np.asarray(jh.mod_mersenne31(jnp.asarray(hi), jnp.asarray(lo)))
    got = th.mod_mersenne31(torch.from_numpy(hi.astype(np.int64)),
                            torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(_port(got), want)
    assert (want[np.array(vals) == P] == 0).all()


def test_families_from_generator_are_seeded_and_in_range():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    f1 = th.Hash2U.create(64, 20, generator=g1, device="cpu")
    f2 = th.Hash2U.create(64, 20, generator=g2, device="cpu")
    assert torch.equal(f1.a1, f2.a1) and torch.equal(f1.a2, f2.a2)
    assert (f1.a2 & 1).all()
    h4 = th.Hash4U.create(32, 20, generator=g1, device="cpu")
    assert (to_numpy(h4.a) < P).all()
    t = torch.from_numpy(T)
    assert int(f1(t).max()) < 2**20 and int(h4(t).max()) < 2**20
    with pytest.raises(ValueError):
        th.Hash4U.create(4, 32, device="cpu")


def test_u32_round_trip():
    v = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    t = from_numpy(v, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(t), v)


@pytest.mark.parametrize("family", ["2u", "4u", "perm"])
def test_oph_create_draws_a_single_function(family):
    from repro_torch.core.oph import OPH, oph_signatures

    oph = OPH.create(64, 12, family, "rotation",
                     generator=torch.Generator().manual_seed(3), device="cpu")
    assert oph.base.k == 1 and oph.bin_width == 1 << 6
    idx = torch.randint(0, 1 << 12, (5, 40), dtype=torch.int32)
    mask = torch.ones_like(idx, dtype=torch.bool)
    sig = to_numpy(oph_signatures(idx, mask, oph, b=0))
    assert sig.shape == (5, 64) and (sig != 0xFFFFFFFF).all()
