"""The row partition of the OPH CUDA kernel (``oph_kernel``,
csrc/oph.cu), modelled in numpy on the CPU.

The kernel reads a row as a scalar head up to its first 16-byte boundary,
whole 16-byte words in rounds of VPT a thread (4 at 256 threads for 2U,
8 at 128 threads for 4U), and a scalar tail of fewer than four lanes.
The model must visit every lane in [0, counts[i]) exactly once and no
other as a value, for every nnz % 4, count and base offset, and over
several rounds, at every launch shape a tuning table may name (2U block
sizes 64 to 1,024 by 64, 4U half as many threads); fed through it, the
bin minima must equal ``repro.kernels.oph.oph2u_pallas`` /
``oph4u_pallas`` in interpret mode.
The kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there, on an edge chunk of the same cases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import hash2u_apply, hash4u_apply
from repro.kernels.oph import oph2u_pallas, oph4u_pallas
from repro_torch.kernels.oph import OPH_THREAD_CHOICES, OPH_THREADS


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
U = np.uint64
EMPTY = 0xFFFFFFFF

# ---------------------------------------------------------------------------

# (threads, 16-byte loads per thread per round) of oph.cu's launches at
# each block size t a launch may take (OPH_THREADS by default): 2U t x
# OPH_VPT, 4U t / 2 threads x twice the loads
OPH_VPT = 4
LAUNCH = {t: {"2u": (t, OPH_VPT), "4u": (t // 2, 2 * OPH_VPT)}
          for t in OPH_THREAD_CHOICES}
SHAPES = sorted({shape for per in LAUNCH.values() for shape in per.values()})
assert LAUNCH[OPH_THREADS]["2u"] in SHAPES      # the default launch too


def _oph_lanes(cnt, base, threads, vpt):
    """The lanes oph_kernel reads as values for a row of clamp(counts)
    = cnt lanes starting at element address ``base`` (the row's first
    lane, in 4-byte units): threads 0-2 the head up to the first 16-byte
    boundary, threads 3-5 the tail past the last whole word, and the body
    in rounds of vpt words a thread, word q of a round at
    base + u * threads + tid.  Asserts each word load is 16-byte aligned
    and reads no lane at or past cnt."""
    head = min(cnt, (4 - base % 4) % 4)
    nvec = (cnt - head) // 4
    tail = head + 4 * nvec
    seen = []
    for tid in range(min(threads, 6)):       # threads 6 on read no scalar
        lane = tid if tid < 3 else tail + tid - 3
        if (tid < head) if tid < 3 else lane < cnt:
            seen.append(lane)
    r0, rounds = 0, 0
    while True:
        for u in range(vpt):
            # the threads whose word q of this round lies below nvec
            for tid in range(max(0, min(threads, nvec - r0 - u * threads))):
                q = r0 + u * threads + tid
                first = head + 4 * q
                assert (base + first) % 4 == 0 and first + 4 <= cnt
                seen += range(first, first + 4)
        rounds += 1
        r0 += vpt * threads
        if r0 >= nvec:
            break
    return seen, rounds


@pytest.mark.parametrize("threads,vpt", [(6, 4)] + SHAPES)
@pytest.mark.parametrize("nnz", [124, 125, 126, 127])
def test_oph_row_partition_visits_each_lane_once(nnz, threads, vpt):
    """Every count 0..nnz of rows at every 4-byte offset of a 16-byte word
    (row i of a batch at offset off starts at element off + i * nnz), at
    every launch shape (``SHAPES``, the default (256, 4) and (128, 8)
    among them); at 6 threads, the fewest the scalar lanes need, a round
    is 96 lanes, so longer rows take several rounds of loads."""
    multi = 0
    for off in (0, 1):
        for i in range(4):
            base = off + i * nnz
            for cnt in range(nnz + 1):
                seen, rounds = _oph_lanes(cnt, base, threads, vpt)
                assert sorted(seen) == list(range(cnt)), (base, cnt)
                multi += rounds > 1
    assert multi > 0 if threads == 6 else multi == 0


def _oph_model(idx_flat, off, n, nnz, counts, hash_fn, s, bin_bits, code_b,
               threads, vpt):
    """oph_kernel end to end: the lanes of _oph_lanes, hashed, split into
    (bin, offset), min per bin, then the sentinel codes."""
    k = 1 << bin_bits
    off_bits = s - bin_bits
    out = np.full((n, k), EMPTY, np.uint64)
    for i in range(n):
        cnt = min(max(int(counts[i]), 0), nnz)
        lanes, _ = _oph_lanes(cnt, off + i * nnz, threads, vpt)
        t = idx_flat[off + i * nnz + np.asarray(lanes, np.int64)]
        h = hash_fn(t.astype(np.uint64))
        bins = (h >> U(off_bits)) if bin_bits > 0 else np.zeros_like(h)
        np.minimum.at(out[i], bins.astype(np.int64), h & U((1 << off_bits) - 1))
    if code_b > 0:
        out = np.where(out == EMPTY, U(1 << code_b), out & U((1 << code_b) - 1))
    return out


@pytest.mark.parametrize("kind", ["2u-high", "2u-low", "4u"])
@pytest.mark.parametrize("nnz", [124, 125, 126, 127])
def test_oph_partition_bins_equal_pallas(nnz, kind):
    """The model's bin minima, the batch at an aligned base and one
    element past it, (bin_bits, code_b) in {(0, 0), (4, 8)}, at every
    launch shape of ``LAUNCH``: equal to the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(161 + nnz)
    s, n = 24, 8
    counts = np.array([0, 1, 3, nnz - 1, nnz, nnz + 5, -1, 70], np.int32)
    a1 = rng.integers(0, 2**32, 1, dtype=np.uint64)
    a2 = rng.integers(0, 2**32, 1, dtype=np.uint64) | U(1)
    a4 = rng.integers(0, P, (4, 1), dtype=np.uint64)
    j32 = lambda a: jnp.asarray(a.astype(np.uint32))
    if kind == "4u":
        hash_fn = lambda t: np.asarray(hash4u_apply(
            j32(t), *(j32(a4[i, 0]) for i in range(4)), s)).astype(np.uint64)
    else:
        variant = kind.split("-")[1]
        hash_fn = lambda t: np.asarray(hash2u_apply(
            j32(t), j32(a1[0]), j32(a2[0]), s, variant)).astype(np.uint64)
    flat = rng.integers(0, 2**32, n * nnz + 1, dtype=np.uint64)
    # the hash of every value of the batch, taken once: the model reads it
    # at each of the LAUNCH shapes
    values = np.unique(flat)
    hashed = hash_fn(values)
    cached = lambda t: hashed[np.searchsorted(values, t)]
    for off in (0, 1):
        idx = flat[off:off + n * nnz].reshape(n, nnz)
        jidx = jnp.asarray(idx.astype(np.uint32).view(np.int32))
        jcnt = jnp.asarray(counts[:, None])
        for bin_bits, code_b in ((0, 0), (4, 8)):
            kw = dict(s=s, bin_bits=bin_bits, blk_n=n, blk_t=nnz,
                      code_b=code_b, interpret=True)
            if kind == "4u":
                want = oph4u_pallas(jidx, jcnt, j32(a4), **kw)
            else:
                want = oph2u_pallas(jidx, jcnt, j32(a1), j32(a2),
                                    variant=variant, **kw)
            want = np.asarray(want)[:, :1 << bin_bits].astype(np.uint64)
            for per in LAUNCH.values():
                got = _oph_model(flat, off, n, nnz, counts, cached, s,
                                 bin_bits, code_b, *per[kind[:2]])
                np.testing.assert_array_equal(got, want)
