"""Port parity for the packed-match kernel module: the port's plain
version against the JAX package's Pallas kernel (interpret mode) and its
``packed_match_ref`` oracle, bit-exact, over code widths 1..32 (9 =
sentinel b = 8, codes straddling words), k not a multiple of 32, and
query / corpus counts that do not tile.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here its wrapper's refusal of CPU tensors and
the SWAR masks it hands the kernel are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bbit import pack_codes as j_pack_codes
from repro.kernels import packed_match as j_packed_match
from repro.kernels.hamming import packed_match_pallas
from repro.kernels.pack import PackSpec as JPackSpec
from repro.kernels.ref import packed_match_ref
from repro_torch.core.u32 import from_numpy
from repro_torch.kernels import hamming as kham
from repro_torch.kernels.pack import PackSpec
from repro_torch.kernels.ref import packed_match_plain

BLK_Q, BLK_N, BLK_K = 8, 128, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's plain-version compares would otherwise take every
    core from the timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes(rng, n, k, code_bits, sentinel, alphabet=4):
    """Codes from a small alphabet (so many positions agree), with EMPTY
    (2^(code_bits-1)) sprinkled in for sentinel wires."""
    top = (1 << code_bits) - 1 if code_bits < 32 else 0xFFFFFFFF
    c = rng.integers(0, min(top, alphabet - 1) + 1, (n, k)).astype(np.uint32)
    c[rng.random((n, k)) < 0.1] = np.uint32(top)       # the largest code
    if sentinel:
        c[rng.random((n, k)) < 0.3] = np.uint32(1 << (code_bits - 1))
    return c


def _wires(seed, nq, nc, k, code_bits, sentinel):
    rng = np.random.default_rng(seed)
    q = _codes(rng, nq, k, code_bits, sentinel)
    c = _codes(rng, nc, k, code_bits, sentinel)
    c[:nq] = q                                          # exact self-matches
    qw = np.asarray(j_pack_codes(jnp.asarray(q), code_bits))
    cw = np.asarray(j_pack_codes(jnp.asarray(c), code_bits))
    return qw, cw


def _pallas(qw, cw, k, code_bits, sentinel):
    """The Pallas kernel in interpret mode; shapes padded to its tiles."""
    bw = BLK_K * code_bits // 32
    pad = lambda a, rows, m: np.pad(a, ((0, -a.shape[0] % rows),
                                        (0, -a.shape[1] % m)))
    out = packed_match_pallas(jnp.asarray(pad(qw, BLK_Q, bw)),
                              jnp.asarray(pad(cw, BLK_N, bw)), k=k,
                              code_bits=code_bits, sentinel=sentinel,
                              blk_q=BLK_Q, blk_n=BLK_N, blk_k=BLK_K,
                              interpret=True)
    nq, nc = qw.shape[0], cw.shape[0]
    if sentinel:
        return [np.asarray(o)[:nq, :nc] for o in out]
    return [np.asarray(out)[:nq, :nc]]


def _plain(qw, cw, k, code_bits, sentinel):
    out = packed_match_plain(from_numpy(qw, "cpu"), from_numpy(cw, "cpu"),
                             k=k, code_bits=code_bits, sentinel=sentinel)
    return [o.numpy() for o in out] if sentinel else [out.numpy()]


@pytest.mark.parametrize("code_bits,k,sentinel", [
    (1, 100, False), (2, 100, True), (4, 70, False), (8, 100, False),
    (8, 128, True), (9, 100, True), (9, 77, False), (32, 40, False),
])
def test_plain_matches_pallas_kernel_and_ref(code_bits, k, sentinel):
    nq, nc = 11, 139                     # neither tiles (8, 128)
    qw, cw = _wires(code_bits * 1000 + k, nq, nc, k, code_bits, sentinel)
    want = _pallas(qw, cw, k, code_bits, sentinel)
    ref = packed_match_ref(jnp.asarray(qw), jnp.asarray(cw), k=k,
                           code_bits=code_bits, sentinel=sentinel)
    ref = [np.asarray(r) for r in (ref if sentinel else [ref])]
    got = _plain(qw, cw, k, code_bits, sentinel)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.int32 and g.shape == (nq, nc)
        np.testing.assert_array_equal(w, r)
        np.testing.assert_array_equal(g, w)
    # the self-matches count every code that is not jointly EMPTY
    if sentinel:
        assert np.array_equal(np.diag(got[0]) + np.diag(got[1]),
                              np.full(nq, k))
    else:
        assert np.array_equal(np.diag(got[0]), np.full(nq, k))


@pytest.mark.parametrize("b,sentinel", [(8, False), (8, True), (4, False)])
def test_dispatcher_runs_plain_on_cpu(b, sentinel):
    """``packed_match(q, c, spec)`` on CPU tensors is the plain version
    and equals the JAX dispatcher's ref backend; nothing is launched."""
    spec, jspec = PackSpec(200, b, sentinel), JPackSpec(200, b, sentinel)
    qw, cw = _wires(b, 5, 300, 200, spec.code_bits, sentinel)
    before = kham.packed_match_cuda.launches
    got = kham.packed_match(from_numpy(qw, "cpu"), from_numpy(cw, "cpu"),
                            spec)
    want = j_packed_match(jnp.asarray(qw), jnp.asarray(cw), jspec,
                          backend="ref")
    for g, w in zip(got if sentinel else [got], want if sentinel else [want]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert kham.packed_match_cuda.launches == before


def test_plain_handles_empty_operands_and_checks_words():
    q = torch.zeros((0, 4), dtype=torch.int32)
    c = torch.zeros((5, 4), dtype=torch.int32)
    out = packed_match_plain(q, c, k=16, code_bits=8)
    assert out.shape == (0, 5) and out.dtype == torch.int32
    m, e = packed_match_plain(c, q, k=16, code_bits=8, sentinel=True)
    assert m.shape == e.shape == (5, 0)
    with pytest.raises(ValueError, match="words"):
        packed_match_plain(c, c, k=17, code_bits=8)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kham.packed_match_cuda(q, q, k=16, code_bits=8)
    assert kham.packed_match_cuda.launches == 0


@pytest.mark.parametrize("code_bits,k,sentinel", [
    (1, 70, False), (2, 45, True), (4, 33, False), (8, 100, False),
    (8, 77, True), (16, 9, True), (32, 5, False),
])
def test_swar_masks_of_the_kernel(code_bits, k, sentinel):
    """The CUDA kernel's SWAR rule, evaluated here in numpy with the masks
    the wrapper passes it: the high bit of every all-zero field of
    x = q ^ c is ~(((x & lo) + lo) | x) & hi, fields past k masked off in
    the last word -- its popcount is the plain version's match count."""
    hi, lo = kham._field_masks(code_bits)
    last = kham._last_word_mask(k, code_bits)
    qw, cw = _wires(k, 6, 9, k, code_bits, sentinel)
    q = qw.astype(np.uint64)[:, None, :]
    c = cw.astype(np.uint64)[None, :, :]
    m32 = np.uint64(0xFFFFFFFF)

    def zero_fields(x):
        return ~((((x & np.uint64(lo)) + np.uint64(lo)) & m32) | x) \
            & np.uint64(hi)

    valid = np.full(qw.shape[1], 0xFFFFFFFF, np.uint64)
    valid[-1] = last
    z = zero_fields(q ^ c) & valid
    popc = lambda a: np.unpackbits(
        a.astype("<u4").view(np.uint8), axis=-1).reshape(
            a.shape[:2] + (-1,)).sum(-1)
    want = _plain(qw, cw, k, code_bits, sentinel)
    if sentinel:
        qe = zero_fields(q ^ np.uint64(hi))
        np.testing.assert_array_equal(popc(z & qe), want[1])
        np.testing.assert_array_equal(popc(z & ~qe & m32), want[0])
    else:
        np.testing.assert_array_equal(popc(z), want[0])
