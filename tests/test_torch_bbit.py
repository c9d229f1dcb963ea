"""Port parity: b-bit codes and packing against ``repro.core.bbit`` and
``repro.kernels.pack``, bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bbit as jb
from repro.kernels import pack as jp
from repro_torch.core import bbit as tb
from repro_torch.kernels import pack as tp
from repro_torch.core.u32 import from_numpy, to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RNG = np.random.default_rng(21)


@pytest.mark.parametrize("k", [64, 100, 128])
@pytest.mark.parametrize("code_bits", [1, 2, 4, 8, 9, 16, 17])
def test_pack_unpack_codes_bit_exact(code_bits, k):
    v = RNG.integers(0, 2**code_bits, (7, k)).astype(np.uint32)
    want = np.asarray(jb.pack_codes(jnp.asarray(v), code_bits))
    got = tb.pack_codes(from_numpy(v, "cpu"), code_bits)
    np.testing.assert_array_equal(to_numpy(got), want)
    back = tb.unpack_codes(from_numpy(want, "cpu"), code_bits, k)
    np.testing.assert_array_equal(to_numpy(back), v)
    np.testing.assert_array_equal(
        to_numpy(back), np.asarray(jb.unpack_codes(jnp.asarray(want),
                                                   code_bits, k)))


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
def test_pack_signatures_bit_exact(b):
    v = RNG.integers(0, 2**b, (5, 100)).astype(np.uint32)
    want = np.asarray(jb.pack_signatures(jnp.asarray(v), b))
    got = tb.pack_signatures(from_numpy(v, "cpu"), b)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(
        to_numpy(tb.unpack_signatures(got, b, 100)), v)
    if 100 * b % 32 == 0:   # lane-aligned packing == the bitstream
        np.testing.assert_array_equal(
            want, np.asarray(jb.pack_codes(jnp.asarray(v), b)))


@pytest.mark.parametrize("b", [4, 8])
def test_lowest_bits_and_expand_tokens(b):
    v = RNG.integers(0, 2**32, (6, 64), dtype=np.uint64).astype(np.uint32)
    low = np.asarray(jb.lowest_bits(jnp.asarray(v), b))
    got = tb.lowest_bits(from_numpy(v, "cpu"), b)
    np.testing.assert_array_equal(to_numpy(got), low)
    tok = np.asarray(jb.expand_tokens(jnp.asarray(low), b))
    np.testing.assert_array_equal(tb.expand_tokens(got, b).numpy(), tok)


@pytest.mark.parametrize("sentinel", [False, True])
def test_pack_device_bit_exact(sentinel):
    k, b = 100, 8
    v = RNG.integers(0, 2**b, (9, k)).astype(np.uint32)
    if sentinel:
        v[RNG.random((9, k)) < 0.3] = 0xFFFFFFFF
    jspec, tspec = jp.PackSpec(k, b, sentinel), tp.PackSpec(k, b, sentinel)
    assert (jspec.code_bits, jspec.words) == (tspec.code_bits, tspec.words)
    want = np.asarray(jp.pack_device(jnp.asarray(v), jspec))
    got = tp.pack_device(from_numpy(v, "cpu"), tspec)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(to_numpy(tp.unpack_device(got, tspec)), v)
    if sentinel:
        codes = tp.encode_sentinel(from_numpy(v, "cpu"), b)
        np.testing.assert_array_equal(
            to_numpy(codes), np.asarray(jp.encode_sentinel(jnp.asarray(v), b)))
        np.testing.assert_array_equal(to_numpy(tp.decode_sentinel(codes, b)), v)


def test_can_pack_in_kernel_matches_reference():
    for args in [(512, 512, 8, 128), (512, 500, 8, 128), (128, 128, 9, 128),
                 (128, 128, 16, 128), (64, 64, 4, 32), (96, 96, 1, 32)]:
        assert tp.can_pack_in_kernel(*args) == jp.can_pack_in_kernel(*args)
