"""The integer arithmetic of two CUDA kernels, modelled step by step in
numpy (uint64 holding the kernels' 32- and 64-bit registers), on the CPU.

* ``minhash4u_kernel`` (csrc/minhash.cu, hash.cuh ``powsum4u``): the 4U
  polynomial as a sum of powers -- t^2 and t^3 mod p staged once per
  nonzero by BitMod products, then per (nonzero, j) one 64-bit sum
  a0 + a1 t + a2 t^2 + a3 t^3 and a single reduction (fold 1 in 64 bits,
  fold 2, one conditional subtract) -- must equal the reference's Horner
  evaluation ``repro.core.hashing.hash4u_apply`` EXACTLY wherever the
  coefficients are < p and t < 2^31.  Outside that domain the kernel
  takes Horner's rule itself (a per-thread flag for coefficients >= p, a
  per-tile flag for t >= 2^31); the dispatch model must equal the
  reference exactly for every input.
* ``minhash2u_kernel`` (csrc/minhash.cu): the running min of the raw
  32-bit a1 + a2 t, one shift >> (32 - s) per (row, j) after it, variant
  low on coefficients shifted left by 32 - s, a row with no lane left at
  0xFFFFFFFF -- must equal ``repro.kernels.minhash.minhash2u_pallas``
  (a shift or mask per evaluation) in interpret mode EXACTLY.
* ``swar_kernel`` (csrc/hamming.cu): zero-field flags of code_bits
  consecutive words shifted right by 0 .. code_bits - 1 and added into one
  word, one popcount per group, with the last word's fields past k made
  unmatchable while staging -- must give EXACTLY the counts of one
  popcount per word with the last word masked, and of the plain version.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import hash4u_apply
from repro.core.bbit import pack_codes as j_pack_codes
from repro.kernels.minhash import minhash2u_pallas
from repro_torch.core.u32 import from_numpy
from repro_torch.kernels import hamming as kham


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
M32 = np.uint64(0xFFFFFFFF)
U = np.uint64
RNG = np.random.default_rng(141)


# ---------------------------------------------------------------------------
# minhash4u: the power-sum form
# ---------------------------------------------------------------------------

def _bitmod_step(acc, t, coef):
    """hash.cuh bitmod_step: acc * t + coef mod 2^64, fold 1 on the (hi,
    lo) halves with uint32 wrap-around, fold 2, conditional subtract."""
    acc, t, coef = (np.asarray(x, np.uint64) for x in (acc, t, coef))
    v = acc * t + coef                                   # wraps mod 2^64
    hi, lo = v >> U(32), v & M32
    v1 = (((hi << U(1)) | (lo >> U(31))) + (lo & U(P))) & M32
    v2 = (v1 >> U(31)) + (v1 & U(P))
    return np.where(v2 >= U(P), v2 - U(P), v2)


def _hash4u_horner(t, a0, a1, a2, a3, s):
    """hash.cuh hash4u, the kernel's path outside the domain."""
    acc = np.broadcast_to(np.asarray(a3, np.uint64), np.broadcast(t, a3).shape)
    for coef in (a2, a1, a0):
        acc = _bitmod_step(acc, t, coef)
    return acc & U((1 << s) - 1) if s < 31 else acc % U(P)


def _stage(t):
    """The block's staging: (x1, x2, x3) = (t, t^2 mod p, t^3 mod p)."""
    t = np.asarray(t, np.uint64)
    t2 = _bitmod_step(t, t, 0)
    return t, t2, _bitmod_step(t2, t, 0)


def _powsum4u(x1, x2, x3, a0, a1, a2, a3, s):
    """hash.cuh powsum4u, then the kernel's s-bit mask."""
    a0, a1, a2, a3 = (np.asarray(a, np.uint64) for a in (a0, a1, a2, a3))
    v = a1 * x1 + a0
    v = v + a2 * x2
    v = v + a3 * x3                   # < 3 * 2^62 + 2^31: never wraps
    assert (v >= a3 * x3).all()
    v = (v & U(P)) + (v >> U(31))                        # fold 1, 64 bits
    assert (v < U(2**33 + 2)).all()
    r = ((v & U(P)) + (v >> U(31))) & M32                # fold 2
    r = np.minimum(r, (r - U(P)) & M32)                  # r == p -> 0
    assert (r < U(P)).all()
    smask = U((1 << s) - 1) if s < 31 else M32
    return r & smask


def _reference(t, a0, a1, a2, a3, s):
    out = hash4u_apply(jnp.asarray(np.asarray(t, np.uint32)),
                       *(jnp.asarray(np.asarray(a, np.uint32))
                         for a in (a0, a1, a2, a3)), s)
    return np.asarray(out).astype(np.uint64)


@pytest.mark.parametrize("s", [1, 24, 31])
def test_powsum_edge_grid_equals_horner_reference(s):
    """Every t in {0, 1, p - 1, p, 2^31 - 1} against every coefficient
    column over {0, 1, p - 1}^4: equal bit for bit."""
    vals = np.array([0, 1, P - 1], np.uint64)
    cols = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"),
                    0).reshape(4, -1)                     # (4, 81)
    t = np.array([0, 1, P - 1, P, 2**31 - 1], np.uint64)[:, None]
    x1, x2, x3 = _stage(t)
    got = _powsum4u(x1, x2, x3, *cols, s)
    want = _reference(np.broadcast_to(t, got.shape),
                      *(np.broadcast_to(c, got.shape) for c in cols), s)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [1, 24, 31])
def test_powsum_random_in_domain_equals_horner_reference(s):
    """10^5 seeded (t, a0..a3) with t < 2^31, coefficients < p."""
    n = 100_000
    t = RNG.integers(0, 2**31, n).astype(np.uint64)
    a = RNG.integers(0, P, (4, n)).astype(np.uint64)
    got = _powsum4u(*_stage(t), *a, s)
    np.testing.assert_array_equal(got, _reference(t, *a, s))


@pytest.mark.parametrize("s", [24, 31])
def test_minhash4u_dispatch_model_equals_reference(s):
    """The kernel's choice of form, per thread (any coefficient >= p ->
    Horner) and per tile (any t >= 2^31 as uint32 -> Horner), then the
    running min: equal to the reference's min for every input, the
    out-of-domain columns and indices of test_torch_hashing included."""
    edge = np.array([[0, P - 1, P, P + 1, 5, 0],
                     [P - 1, P, P + 1, 0, 7, 0],
                     [P, P + 1, 1, P - 1, 9, P],
                     [P + 1, 0, P - 1, P, 2**31, 0]], np.uint64)
    a = np.concatenate([edge, RNG.integers(0, P, (4, 10)).astype(np.uint64)],
                       axis=1)
    rows = [np.array([0, 1, 2**31 - 2, 2**31 - 1], np.uint64),
            RNG.integers(0, 2**31, 37).astype(np.uint64),
            np.array([5, 2**31, 2**32 - 1, 7], np.uint64)]
    for t in rows:
        wide = bool((t >> U(31)).any())                  # the tile's flag
        x1, x2, x3 = _stage(t[:, None])
        for j in range(a.shape[1]):
            col = a[:, j]
            horner = wide or bool((col >= U(P)).any())   # the thread's flag
            h = (_hash4u_horner(t, *col, s) if horner else
                 _powsum4u(x1[:, 0], x2[:, 0], x3[:, 0], *col, s))
            want = _reference(t, *(np.full(t.shape, c) for c in col), s)
            assert int(h.min()) == int(want.min()), (t, col)
            np.testing.assert_array_equal(h, want)


# ---------------------------------------------------------------------------
# minhash2u: the shift hoisted out of the running min
# ---------------------------------------------------------------------------

EMPTY = 0xFFFFFFFF


def _minhash2u_hoisted(idx, counts, a1, a2, s, b, variant):
    """minhash2u_kernel: per (row, j) the running min of the raw
    c0 + c1 t (mod 2^32) over the row's first clamp(counts) lanes, two
    values a min in the 16-byte steps, one at a time in the tail; then one
    shift >> x, x = 32 - s (0 at s = 32), unless the row had no lane; then
    the b-bit mask.  Variant low runs on c = a << x."""
    n, nnz = idx.shape
    x = 32 - s if s < 32 else 0
    pre = U(0 if variant == "high" else x)
    c0 = (a1.astype(np.uint64) << pre) & M32
    c1 = (a2.astype(np.uint64) << pre) & M32
    out = np.empty((n, a1.shape[0]), np.uint64)
    for i in range(n):
        cnt = min(max(int(counts[i]), 0), nnz)
        m = np.full(a1.shape[0], EMPTY, np.uint64)
        t = idx[i, :cnt].astype(np.uint64)
        v = (c0[None, :] + c1[None, :] * t[:, None]) & M32      # (cnt, k)
        q = cnt - cnt % 4
        for p0 in range(0, q, 2):                  # 16-byte steps, in pairs
            m = np.minimum(m, np.minimum(v[p0], v[p0 + 1]))
        for p0 in range(q, cnt):                   # the tile's tail
            m = np.minimum(m, v[p0])
        out[i] = (m >> U(x)) if cnt > 0 else m
    if 0 < b < 32:
        out &= U((1 << b) - 1)
    return out


def _wrap_index(a1, a2, target):
    return (target - int(a1)) * pow(int(a2), -1, 2**32) % 2**32


@pytest.mark.parametrize("variant", ["high", "low"])
@pytest.mark.parametrize("s", [1, 24, 32])
def test_minhash2u_hoisted_shift_equals_pallas(s, variant):
    """Rows of 0 to 13 lanes, counts < 0 and > nnz, a row whose one lane
    hashes to 0xFFFFFFFF under column 0 (the non-empty maximum) and lanes
    wrapping to 0 and 0xFFFFFFFF; k in {1, 33, 64}, b in {0, 8, 32}."""
    rng = np.random.default_rng(151 + s)
    nnz = 16
    for k in (1, 33, 64):
        a1 = rng.integers(0, 2**32, k, dtype=np.uint64)
        a2 = rng.integers(0, 2**32, k, dtype=np.uint64) | U(1)
        if k > 2:
            a1[1], a2[1] = 0, 1
        wrap = [_wrap_index(a1[j], a2[j], tg) for j in (0, k - 1)
                for tg in (EMPTY, 0)]
        idx = rng.integers(0, 2**32, (8, nnz), dtype=np.uint64)
        idx[0, 0] = wrap[0]
        idx[3, [2, 5, 9, 11]] = wrap
        counts = np.array([1, 0, 5, 13, -2, 40, 16, 7], np.int32)
        for b in (0, 8, 32):
            got = _minhash2u_hoisted(idx, counts, a1, a2, s, b, variant)
            want = minhash2u_pallas(
                jnp.asarray(idx.astype(np.uint32).view(np.int32)),
                jnp.asarray(counts[:, None]), jnp.asarray(a1.astype(np.uint32)),
                jnp.asarray(a2.astype(np.uint32)), s=s, b=b, blk_n=8,
                blk_t=nnz, blk_k=k, variant=variant, interpret=True)
            np.testing.assert_array_equal(got, np.asarray(want).astype(np.uint64))
            assert got[1].tolist() == [EMPTY & ((1 << b) - 1 if 0 < b < 32
                                                else EMPTY)] * k


# ---------------------------------------------------------------------------
# packed_match: one popcount per code_bits words
# ---------------------------------------------------------------------------

SW = 32   # words staged per step (hamming.cu)


def _zero_fields(x, hi, lo):
    return ~((((x & U(lo)) + U(lo)) & M32) | x) & U(hi)


def _popc(a):
    a = np.ascontiguousarray(a.astype(np.uint32))
    return np.unpackbits(a.view(np.uint8), axis=-1).reshape(
        a.shape + (32,)).sum(-1, dtype=np.int64)


def _wires(nq, nc, k, code_bits, sentinel):
    top = (1 << code_bits) - 1
    codes = []
    for n in (nq, nc):
        c = RNG.integers(0, min(top, 3) + 1, (n, k)).astype(np.uint64)
        c[RNG.random((n, k)) < 0.1] = top
        if sentinel:
            c[RNG.random((n, k)) < 0.3] = 1 << (code_bits - 1)
        codes.append(c)
    codes[1][:nq] = codes[0]                              # self-matches
    return [np.asarray(j_pack_codes(jnp.asarray(c.astype(np.uint32)),
                                    code_bits)) for c in codes]


def _fold_counts(qw, cw, k, code_bits, sentinel):
    """swar_kernel's counting: staging masks the tail, then per pair the
    flag words of each code_bits-word group are shifted by w % code_bits,
    added, and counted once."""
    hi, lo = kham._field_masks(code_bits)
    last = U(kham._last_word_mask(k, code_bits))
    W = qw.shape[1]
    wp = -(-W // SW) * SW
    q = np.zeros((qw.shape[0], wp), np.uint64)
    c = np.zeros((cw.shape[0], wp), np.uint64)
    q[:, :W], c[:, :W] = qw, cw
    q[:, W - 1] |= ~last & M32                          # fields past k
    c[:, W - 1] &= last
    q[:, W:] = M32                                      # pad words
    m = np.zeros((q.shape[0], c.shape[0]), np.int64)
    e = np.zeros_like(m)
    for g0 in range(0, wp, code_bits):
        acc = np.zeros(m.shape, np.uint64)
        acce = np.zeros(m.shape, np.uint64)
        for w in range(g0, g0 + code_bits):
            z = _zero_fields(q[:, None, w] ^ c[None, :, w], hi, lo)
            sh = U(w % code_bits)
            prev = acc
            acc = acc + (z >> sh)
            assert ((prev & (z >> sh)) == 0).all()      # disjoint bits
            if sentinel:
                qe = _zero_fields(q[:, w] ^ U(hi), hi, lo)
                acce = acce + ((z & qe[:, None]) >> sh)
        pe = _popc(acce)
        e += pe
        m += _popc(acc) - pe
    return (m, e) if sentinel else (m,)


def _word_counts(qw, cw, k, code_bits, sentinel):
    """The counting it replaces: one popcount per word, the last word
    masked by last_mask."""
    hi, lo = kham._field_masks(code_bits)
    valid = np.full(qw.shape[1], 0xFFFFFFFF, np.uint64)
    valid[-1] = kham._last_word_mask(k, code_bits)
    q = qw.astype(np.uint64)[:, None, :]
    c = cw.astype(np.uint64)[None, :, :]
    z = _zero_fields(q ^ c, hi, lo) & valid
    if not sentinel:
        return (_popc(z).sum(-1),)
    qe = _zero_fields(q ^ U(hi), hi, lo)
    return _popc(z & ~qe & M32).sum(-1), _popc(z & qe).sum(-1)


@pytest.mark.parametrize("code_bits,k,sentinel", [
    (1, 45, False), (2, 45, False), (2, 77, True), (4, 33, False),
    (4, 70, True), (8, 101, False), (8, 503, False), (8, 77, True),
    (16, 9, False), (16, 41, True), (32, 5, False), (32, 67, True),
])
def test_popc_fold_equals_one_popc_per_word(code_bits, k, sentinel):
    """k is not a multiple of 32 / code_bits below 32 bits (a partial
    last word), and W spans word steps unevenly; both countings and the
    plain version agree exactly."""
    assert code_bits == 32 or k % (32 // code_bits)
    qw, cw = _wires(7, 11, k, code_bits, sentinel)
    got = _fold_counts(qw, cw, k, code_bits, sentinel)
    want = _word_counts(qw, cw, k, code_bits, sentinel)
    plain = kham.packed_match_plain(from_numpy(qw, "cpu"),
                                    from_numpy(cw, "cpu"), k=k,
                                    code_bits=code_bits, sentinel=sentinel)
    plain = [p.numpy() for p in plain] if sentinel else [plain.numpy()]
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
