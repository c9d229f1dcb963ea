"""The traversals of the signature embedding-bag CUDA kernel
(``sigbag_staged`` and ``sigbag_direct`` in csrc/sigbag.cu), modelled in
numpy on the CPU.

Design (A) stages slot slices in shared memory: a block owns R rows, a
consumer thread owns two 16-byte pieces of RT rows, the slots come in
steps of A_SPS through a ring of stages guarded by mbarriers, and the
tokens eight slots at a time through two token stages.  Design (B) is a
direct gather: L lanes a row, V columns a lane, the row's tokens spread
over its lanes and swapped by shuffles.  The models follow the kernel's
index arithmetic; the tests check that every (row, column) is written
exactly once, that every slot is added in the order j = 0..k-1, that the
stage rings hand each consumer the slot and token chunk it expects under
any interleaving, and that the models' outputs equal
``repro.kernels.sigbag`` through the Pallas kernel in interpret mode and
``sigbag_plain``, bit for bit, in float32 and bfloat16.  The dispatch
rule ``staged_plan`` is the twin of the kernel's ``make_plan``
(``chip_smoke.py`` holds the two against each other and the kernel
against ``sigbag_plain`` on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sigbag as j_sigbag
from repro_torch.kernels import sigbag as ksig
from repro_torch.kernels.sigbag import (direct_layout, sigbag_plain,
                                        staged_plan, staged_rows)

SMS = 132                      # the H100 SXM's streaming multiprocessors
BAD_TOKENS = (-1, 2**31 - 1)   # with 2^b: tokens that add nothing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's models would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Inputs

def _inputs(seed, n, k, b, d, dtype):
    """Tokens in [0, 2^b) with -1, 2^b and 2^31 - 1 sprinkled in and one
    row all out of range; an N(0, 1) table with a row of -0.0, rounded to
    ``dtype`` in JAX and handed to torch through float32."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 2**b, (n, k)).astype(np.int64)
    odd = rng.random((n, k)) < 0.05
    tok[odd] = rng.choice(BAD_TOKENS + (2**b,), int(odd.sum()))
    tok[min(2, n - 1)] = -1
    tok = tok.astype(np.int32)
    table = rng.normal(size=(k, 2**b, d)).astype(np.float32)
    table[0, 0] = -0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j_table = jnp.asarray(table, jdt)
    t_table = torch.from_numpy(np.array(j_table, np.float32)).to(tdt)
    return tok, j_table, t_table


def _pallas(tok, j_table):
    out = j_sigbag(jnp.asarray(tok), j_table, backend="interpret")
    return np.asarray(out.astype(jnp.float32))


def _cast(acc32: np.ndarray, dtype) -> np.ndarray:
    """The kernel's one rounding of the float32 sums to the table's type."""
    return torch.from_numpy(acc32).to(dtype).float().numpy()


# ---------------------------------------------------------------------------
# Design (A): geometry (Staged<D, TPR>)

def _geometry(tpr, esize):
    v = 16 // esize
    ppt = ksig.A_PPT if tpr > 1 else 1
    tt = tpr // ppt
    rpw = 32 // tt
    step = ksig.A_WARPS * rpw
    rt = min(ksig.A_ACC // (ppt * v), ksig.A_ROWS_MAX // step)
    return dict(v=v, ppt=ppt, tt=tt, rpw=rpw, step=step, rt=rt, r=step * rt)


def _threads(g):
    """Per consumer thread: its block row of step 0 and its pieces, in the
    order it loads them (rows of odd sub take the upper half first)."""
    t = np.arange(ksig.A_WARPS * 32)
    warp, lane = t // 32, t % 32
    sub, q = lane // g["tt"], lane % g["tt"]
    rl0 = warp * g["rpw"] + sub
    if g["ppt"] == 2:
        odd = (sub & 1).astype(bool)
        pieces = np.stack([np.where(odd, q + g["tt"], q),
                           np.where(odd, q, q + g["tt"])], axis=1)
    else:
        pieces = q[:, None]
    return lane, rl0, pieces


def _tok_swz(r):
    return (np.asarray(r) >> 2) & 1


def _tok_off(jj, swz):
    """Byte offset of slot jj in a 32-byte token row (csrc ``tok_off``)."""
    return (((jj >> 2) ^ swz) << 4) | ((jj & 3) << 2)


TPRS = (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("tpr", TPRS)
def test_staged_partition_covers_each_piece_once(tpr, esize):
    """A block's consumer threads cover every (row, 16-byte piece) of its
    R rows exactly once, with the kernel's 128 float32 sums a thread, and
    R is ``staged_rows``'s count."""
    g = _geometry(tpr, esize)
    assert g["r"] == staged_rows(tpr, esize) <= ksig.A_ROWS_MAX
    assert g["rt"] * g["ppt"] * g["v"] <= ksig.A_ACC
    assert g["step"] % 8 == 0          # a thread's token swizzle is fixed
    _, rl0, pieces = _threads(g)
    seen = np.zeros((g["r"], tpr), np.int64)
    for i in range(g["rt"]):
        rows = rl0 + i * g["step"]
        assert (_tok_swz(rows) == _tok_swz(rl0)).all()
        for m in range(g["ppt"]):
            np.add.at(seen, (rows, pieces[:, m]), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("tpr", [8, 16, 32])
def test_staged_table_loads_free_of_bank_conflicts(tpr):
    """Rows of 128 bytes or more: in every 128-bit shared load the eight
    lanes of each quarter-warp read eight distinct 16-byte bank groups,
    whatever rows the tokens pick (a row starts on a 128-byte boundary)."""
    for esize in (4, 2):
        g = _geometry(tpr, esize)
        lane, _, pieces = _threads(g)
        for m in range(g["ppt"]):
            group = (pieces[:, m] % 8).reshape(-1, 8)   # one quarter a line
            assert all(len(set(qw)) == 8 for qw in group)


@pytest.mark.parametrize("tpr,esize", [(8, 4), (16, 4), (32, 4), (8, 2),
                                       (16, 2)])
def test_staged_token_loads_hit_distinct_banks(tpr, esize):
    """A warp-step's token load (A_SPS slots, 8 bytes at A_SPS = 2) reads
    one address per row; with the swizzle the (at most eight) rows of a
    warp-step land in distinct banks."""
    g = _geometry(tpr, esize)
    _, rl0, _ = _threads(g)
    words = ksig.A_SPS
    for jj in range(0, ksig.A_TCH, words):
        for w in range(ksig.A_WARPS):
            rows = np.unique(rl0[w * 32:(w + 1) * 32])
            assert len(rows) <= 8
            off = rows * 32 + _tok_off(jj, _tok_swz(rows))
            banks = [(o // 4 + x) % 32 for o in off for x in range(words)]
            assert len(set(banks)) == len(banks)


# ---------------------------------------------------------------------------
# Design (A): the stage rings, as mbarriers

class _MBar:
    """An mbarrier: ``count`` arrivals and the transaction bytes expected
    complete a phase; ``done(parity)`` is try_wait.parity."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, expect_tx=0):
        self.tx += expect_tx
        self.pending -= 1
        assert self.pending >= 0
        self._flip()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._flip()

    def _flip(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def done(self, parity):
        return (self.phase & 1) != parity


def _simulate_rings(k, stages, sps, seed, warps=ksig.A_WARPS):
    """The producers' and consumers' barrier protocol of sigbag_staged,
    run under a random interleaving with random copy latencies.  Returns
    each warp's (slot, chunk) reads in order; asserts no deadlock and that
    every read finds the slot slice and token chunk it expects."""
    rng = np.random.default_rng(seed)
    full = [_MBar(1) for _ in range(stages)]
    empty = [_MBar(warps) for _ in range(stages)]
    tfull = [_MBar(1) for _ in range(2)]
    tempty = [_MBar(warps) for _ in range(2)]
    stage_slot = [None] * stages
    tok_chunk = [None, None]
    landings = []                      # copies in flight: (fn)

    def table_producer():
        s, ph = 0, 1                   # the first round finds stages empty
        for j in range(k):
            yield lambda s=s, ph=ph: empty[s].done(ph)
            full[s].arrive(expect_tx=1)

            def land(s=s, j=j):
                stage_slot[s] = j
                full[s].complete_tx(1)
            landings.append(land)
            s += 1
            if s == stages:
                s, ph = 0, ph ^ 1

    def token_producer():
        for c, _ in enumerate(range(0, k, ksig.A_TCH)):
            tb = c & 1
            yield lambda tb=tb, c=c: tempty[tb].done(((c >> 1) & 1) ^ 1)

            def land(tb=tb, c=c):
                tok_chunk[tb] = c
                tfull[tb].arrive()
            landings.append(land)

    def consumer(reads):
        s, ph, j = 0, 0, 0
        steps = []
        if stages >= sps:
            while j + sps <= k:
                steps.append((j, sps))
                j += sps
        steps += [(jj, 1) for jj in range(j, k)]
        for j, p in steps:
            jj, c = j % ksig.A_TCH, j // ksig.A_TCH
            tb = c & 1
            st, par = [], []
            for _ in range(p):
                st.append(s)
                par.append(ph)
                s += 1
                if s == stages:
                    s, ph = 0, ph ^ 1
            yield lambda st=st, par=par, jj=jj, tb=tb, c=c: (
                (jj != 0 or tfull[tb].done((c >> 1) & 1))
                and all(full[x].done(y) for x, y in zip(st, par)))
            assert tok_chunk[tb] == c, (j, tok_chunk, c)
            for x in range(p):
                assert stage_slot[st[x]] == j + x, (j, x, stage_slot)
                reads.append((j + x, c))
            for x in st:
                empty[x].arrive()
            if jj + p == ksig.A_TCH or j + p == k:
                tempty[tb].arrive()

    reads = [[] for _ in range(warps)]
    actors = [table_producer(), token_producer()]
    actors += [consumer(r) for r in reads]
    waits = [next(a, None) for a in actors]
    while True:
        live = [i for i, w in enumerate(waits) if w is not None]
        if not live and not landings:
            break
        ready = [i for i in live if waits[i]()]
        options = len(ready) + len(landings)
        assert options, f"deadlock at k={k}, stages={stages}"
        pick = rng.integers(options)
        if pick < len(ready):
            i = ready[pick]
            waits[i] = next(actors[i], None)
        else:
            landings.pop(pick - len(ready))()
    return reads


@pytest.mark.parametrize("stages", [2, 3, 5, 8])
@pytest.mark.parametrize("k", [1, 2, 7, 8, 9, 33, 64, 65])
def test_stage_rings_hand_each_slot_in_order(k, stages):
    """Every consumer warp reads slots 0..k-1 once each, in order, each
    from a stage that holds that slot and a token buffer that holds its
    chunk, under random interleavings (A_SPS slots a step, single slots
    for k's tail)."""
    for seed in range(3):
        reads = _simulate_rings(k, stages, ksig.A_SPS, seed)
        want = [(j, j // ksig.A_TCH) for j in range(k)]
        assert all(r == want for r in reads)


def _staged_model(tok, table32, esize, dtype, *, tok_aligned=True):
    """sigbag_staged end to end: blocks of R rows; per chunk of A_TCH
    slots the token producer's copies into a 32-byte row layout (16-byte
    copies when k % 4 == 0 and the tokens are aligned, else 4-byte ones;
    rows and slots past the end never copied, so the stage keeps stale
    words there); per step the consumers' loads (clamped to the zero row)
    and float32 adds in slot order.  Returns (out, writes per element)."""
    n, k = tok.shape
    _, two_b, d = table32.shape
    tpr = d * esize // 16
    g = _geometry(tpr, esize)
    v, big_r = g["v"], g["r"]
    _, rl0, pieces = _threads(g)
    rows_i = rl0[None, :] + np.arange(g["rt"])[:, None] * g["step"]  # (RT, T)
    cols = [pieces[None, :, m, None] * v + np.arange(v)          # (1, T, v)
            for m in range(g["ppt"])]
    vec = k % 4 == 0 and tok_aligned
    out = np.zeros((n, d), np.float32)
    writes = np.zeros((n, d), np.int64)
    zero = np.zeros((1, d), np.float32)
    for r0 in range(0, n, big_r):
        rows = min(big_r, n - r0)
        tokmem = np.full(big_r * 8, 0x7FFF0000, np.int64)   # stale words
        acc = np.zeros(rows_i.shape + (g["ppt"], v), np.float32)
        j = 0
        steps = []
        while j + ksig.A_SPS <= k:
            steps.append((j, ksig.A_SPS))
            j += ksig.A_SPS
        steps += [(jj, 1) for jj in range(j, k)]
        for j, p in steps:
            jj = j % ksig.A_TCH
            if jj == 0:                               # the token producer
                left = min(ksig.A_TCH, k - j)
                r = np.arange(rows)
                swz = _tok_swz(r)
                if vec:
                    for piece in range(2):
                        if 4 * piece < left:
                            base = (r * 32 + _tok_off(4 * piece, swz)) // 4
                            for x in range(4):
                                tokmem[base + x] = tok[r0 + r, j + 4 * piece + x]
                else:
                    for x in range(left):
                        tokmem[(r * 32 + _tok_off(x, swz)) // 4] = tok[r0 + r, j + x]
            loads = []
            for x in range(p):
                word = (rows_i * 32 + _tok_off(jj + x, _tok_swz(rl0))[None, :]) // 4
                t = tokmem[word].astype(np.int64) & 0xFFFFFFFF
                u = np.minimum(t, two_b)               # else the zero row
                stage = np.concatenate([table32[j + x], zero])[u]
                loads.append(np.stack(
                    [np.take_along_axis(stage, np.broadcast_to(
                        cols[m], stage.shape[:2] + (v,)), 2)
                     for m in range(g["ppt"])], axis=2))
            for w in loads:
                acc = acc + w                          # float32, slot order
        live = rows_i < rows
        rr = np.broadcast_to((r0 + rows_i)[..., None], live.shape + (v,))
        for m in range(g["ppt"]):
            cc = np.broadcast_to(cols[m], live.shape + (v,))
            out[rr[live], cc[live]] = acc[..., m, :][live]
            np.add.at(writes, (rr[live], cc[live]), 1)
    return _cast(out, dtype), writes


# ---------------------------------------------------------------------------
# Design (B): the direct gather

def _direct_model(tok, table32, esize, dtype, *, table_ptr=0):
    """sigbag_direct end to end: warps of 32 / L rows, lane li of a row
    holding tokens j0 + li * NT .. and columns c0 + li * V .., the token of
    slot jj fetched from lane jj // NT's register jj % NT, loads past k or
    out of range read as 0, adds in slot order."""
    n, k = tok.shape
    _, two_b, d = table32.shape
    v, lanes = direct_layout(d, esize, table_ptr)
    nt = ksig.B_SLOTS // lanes
    rpw = 32 // lanes
    warps = -(-n // rpw)
    g_lane = np.arange(warps * 32)
    row = (g_lane // 32) * rpw + (g_lane % 32) // lanes
    li = g_lane % lanes
    live_row = row < n
    out = np.zeros((n, d), np.float32)
    writes = np.zeros((n, d), np.int64)
    safe_row = np.where(live_row, row, 0)
    for c0 in range(0, d, lanes * v):
        c = c0 + li * v
        live = live_row & (c < d)
        acc = np.zeros((len(g_lane), v), np.float32)
        for j0 in range(0, k, ksig.B_SLOTS):
            first = j0 + li * nt
            slot = first[:, None] + np.arange(nt)              # (lanes, NT)
            ok = live_row[:, None] & (slot < k)
            tk = np.where(ok, tok[safe_row[:, None], np.minimum(slot, k - 1)],
                          -1)
            base = g_lane - li                       # the row's first lane
            w = []
            for jj in range(ksig.B_SLOTS):
                t = tk[base + jj // nt, jj % nt].astype(np.int64)
                want = np.where(j0 + jj < k,
                                tok[safe_row, min(j0 + jj, k - 1)], -1)
                assert (t[live_row] == want[live_row]).all()
                good = live & (t >= 0) & (t < two_b)
                cols = np.minimum(c[:, None] + np.arange(v), d - 1)
                val = table32[min(j0 + jj, k - 1), np.clip(t, 0, two_b - 1)[:, None],
                              cols]
                w.append(np.where(good[:, None], val, np.float32(0)))
            for x in w:
                acc = acc + x                          # float32, slot order
        rr = np.broadcast_to(row[:, None], acc.shape)[live]
        cc = (c[:, None] + np.arange(v))[live]
        out[rr, cc] = acc[live]
        np.add.at(writes, (rr, cc), 1)
    return _cast(out, dtype), writes


# ---------------------------------------------------------------------------
# The models against the Pallas kernel and the plain version

# (n, k, b, d, dtype): rows not a multiple of a block (R = 1024 at d = 32),
# k not a multiple of the 8-slot token stage or the 2-slot step, 2^b in
# {16, 256, 1024}, d a whole number of 16-byte pieces (design A)
STAGED = [
    (130, 1, 8, 32, "float32"), (130, 33, 8, 32, "float32"),
    (1027, 64, 8, 32, "float32"), (130, 500, 8, 32, "float32"),
    (257, 36, 4, 8, "float32"), (130, 33, 8, 64, "float32"),
    (130, 33, 4, 128, "float32"), (130, 64, 10, 32, "float32"),
    (130, 64, 4, 32, "bfloat16"), (130, 33, 10, 32, "bfloat16"),
    (257, 65, 8, 8, "bfloat16"), (1027, 33, 8, 32, "bfloat16"),
    (130, 33, 8, 64, "bfloat16"),
]
# any d (design B): d = 1 (the paper's linear model), odd d, wide d
DIRECT = [
    (130, 33, 8, 1, "float32"), (130, 500, 8, 1, "bfloat16"),
    (130, 65, 10, 31, "float32"), (130, 33, 8, 33, "bfloat16"),
    (257, 64, 4, 8, "float32"), (130, 128, 8, 128, "float32"),
    (3, 1, 4, 1, "float32"), (130, 64, 8, 32, "bfloat16"),
    (512, 64, 8, 32, "float32"),
]


@pytest.mark.parametrize("n,k,b,d,dtype", STAGED)
def test_staged_model_equals_pallas_and_plain(n, k, b, d, dtype):
    tok, j_table, t_table = _inputs(n * k + d + b, n, k, b, d, dtype)
    table32 = t_table.float().numpy()
    got, writes = _staged_model(tok, table32, t_table.element_size(),
                                t_table.dtype)
    assert (writes == 1).all()
    plain = sigbag_plain(torch.from_numpy(tok), t_table).float().numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _pallas(tok, j_table))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_model_scalar_token_copies(dtype):
    """Tokens not 16-byte aligned (a batch one element into its buffer):
    the producer copies 4 bytes a slot into the same layout."""
    tok, j_table, t_table = _inputs(41, 130, 64, 8, 32, dtype)
    got, writes = _staged_model(tok, t_table.float().numpy(),
                                t_table.element_size(), t_table.dtype,
                                tok_aligned=False)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _pallas(tok, j_table))


@pytest.mark.parametrize("n,k,b,d,dtype", DIRECT)
def test_direct_model_equals_pallas_and_plain(n, k, b, d, dtype):
    tok, j_table, t_table = _inputs(n * k + d + b + 1, n, k, b, d, dtype)
    got, writes = _direct_model(tok, t_table.float().numpy(),
                                t_table.element_size(), t_table.dtype)
    assert (writes == 1).all()
    plain = sigbag_plain(torch.from_numpy(tok), t_table).float().numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _pallas(tok, j_table))


def test_direct_model_one_column_a_lane_on_a_misaligned_table():
    """A bfloat16 table at an odd element address loads one column a lane."""
    tok, j_table, t_table = _inputs(43, 130, 33, 8, 32, "bfloat16")
    assert direct_layout(32, 2, table_ptr=2) == (1, 32)
    got, writes = _direct_model(tok, t_table.float().numpy(), 2,
                                t_table.dtype, table_ptr=2)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, _pallas(tok, j_table))


# ---------------------------------------------------------------------------
# The dispatch rule

# (n, 2^b, d, esize, table address, staged, rows a block, stages)
RULE = [
    (262_144, 256, 32, 4, 0, True, 1024, 5),     # serve_bulk, float32
    (262_144, 256, 32, 2, 0, True, 1024, 8),     # the same, bfloat16
    (512, 256, 32, 4, 0, False, 0, 0),           # serve_p99: a request
    (131 * 1024, 256, 32, 4, 0, False, 0, 0),    # one block short a SM
    (131 * 1024 + 1, 256, 32, 4, 0, True, 1024, 5),
    (262_144, 1024, 32, 4, 0, False, 0, 0),      # a slice takes 128 KB
    (262_144, 1024, 32, 2, 0, True, 1024, 2),
    (262_144, 256, 1, 4, 0, False, 0, 0),        # d = 1: under a piece
    (262_144, 256, 33, 4, 0, False, 0, 0),       # no whole pieces
    (262_144, 256, 32, 4, 8, False, 0, 0),       # table not 16-aligned
    (262_144, 256, 64, 4, 0, True, 512, 3),
    (262_144, 16, 8, 4, 0, True, 1024, 8),
    (262_144, 256, 128, 4, 0, False, 0, 0),
    (262_144, 16, 128, 4, 0, True, 256, 8),
]


@pytest.mark.parametrize("n,two_b,d,esize,ptr,staged,rows,stages", RULE)
def test_dispatch_rule(n, two_b, d, esize, ptr, staged, rows, stages):
    plan = staged_plan(n, two_b, d, esize, SMS, ptr)
    assert plan.staged == staged
    assert (plan.rows, plan.stages) == (rows, stages)
    if staged:
        smem = (ksig.A_BARRIER_BYTES + 2 * rows * ksig.A_TCH * 4
                + stages * plan.stage_bytes)
        assert smem <= ksig.A_SMEM_MAX
        assert plan.stage_bytes >= two_b * d * esize + d * esize
        assert -(-n // rows) >= SMS


def test_dispatch_rule_fits_every_staged_shape():
    """Over a grid of shapes: a staged plan always fits its shared memory
    with at least two stages, and gives every SM a block."""
    for esize in (4, 2):
        for d in (4, 8, 16, 32, 64, 128, 256):
            for b in (2, 4, 6, 8, 10, 12):
                for n in (1, 4_096, 100_000, 262_144):
                    plan = staged_plan(n, 2**b, d, esize, SMS)
                    if not plan.staged:
                        continue
                    smem = (ksig.A_BARRIER_BYTES + 2 * plan.rows * 32
                            + plan.stages * plan.stage_bytes)
                    assert smem <= ksig.A_SMEM_MAX
                    assert 2 <= plan.stages <= ksig.A_MAX_STAGES
                    assert -(-n // plan.rows) >= SMS
                    assert plan.rows == staged_rows(plan.tpr, esize)
