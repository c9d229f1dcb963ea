"""Driver of the preprocessing mixes: passes over a device-resident data
set through ``SignatureEngine.packed_signatures``, the packed words of
every chunk copied back to host memory.

Set-up makes the configuration's rows on the device from the seed, as
``SparseBatch`` chunks of ``chunk_rows``, and sends one chunk through
the whole path with a family that the window never uses.  The window
runs passes until ``--seconds`` have gone: each pass draws a fresh family
(the traffic's ``family``, 2U or 4U) from the seed and the pass number,
and sends the chunks in order; each chunk's words go to a pinned host
slot of a ring of ``SLOTS``, which the host waits for before it refills
the slot.  The window ends when the last copy has landed.

Checked: a sample, drawn from the seed, of the rows whose words reached
the host (``keep_per_chunk`` rows of every chunk, then ``check_rows`` of
those), against the reference's codes of the same rows, made again from
the generator, under the same coefficients.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from bench import generator as gen
from bench import reference as ref
from bench.harness import Ctx, Outcome

WARM_DRAW = 1 << 40       # the warm-up's coefficients; passes count from 0
SLOTS = 4                 # pinned host slots: chunks in flight at most

# The CPU tests' size of a cell of this driver (bench/tests/conftest.py
# `tiny`): what replaces keys of its configuration and of its traffic.
TINY = ({"n_rows": 300, "k": 64, "row_nnz": {"knots": [20, 45, 60]}},
        {"chunk_rows": 100, "check_rows": 64, "trace_seconds": 0.2})
# The program call the window drives, "module:attribute", where the CPU
# tests plant their faults; a string, so that no import of the program
# happens before the run's set-up.
PROGRAM_CALL = "repro_torch.kernels.engine:SignatureEngine.packed_signatures"


def family_of(cfg: dict, traffic: dict, coef: dict, device):
    """The program's hash family for one draw of coefficients."""
    from repro_torch.core.hashing import Hash2U, Hash4U
    if traffic["family"] == "2u":
        return Hash2U.from_numpy(coef["a1"], coef["a2"], cfg["s"],
                                 device=device)
    return Hash4U.from_numpy(coef["a"], cfg["s"], device)


def ref_coef(traffic: dict, coef: dict):
    return ((coef["a1"], coef["a2"]) if traffic["family"] == "2u"
            else coef["a"])


class CopyRing:
    """``depth`` host slots for the packed words of a chunk: pinned, with
    an event per copy, on the card; plain tensors on the CPU."""

    def __init__(self, depth: int, shape, device: torch.device):
        cuda = device.type == "cuda"
        self.cuda = cuda
        self.slots = [torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(depth)]
        self.events = [None] * depth

    def put(self, i: int, words: torch.Tensor) -> None:
        self.slots[i].copy_(words, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events[i] = ev

    def wait(self, i: int) -> np.ndarray:
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        return self.slots[i].numpy()


class Program:
    """The timed path: a fresh engine per pass, one call per chunk."""

    def __init__(self, cfg, traffic, device):
        from repro_torch.kernels.engine import SignatureEngine
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.engine_cls = SignatureEngine

    def start_pass(self, coef: dict) -> None:
        fam = family_of(self.cfg, self.traffic, coef, self.device)
        self.engine = self.engine_cls(fam, b=self.cfg["b"], packed=True)

    def __call__(self, chunk) -> torch.Tensor:
        return self.engine.packed_signatures(chunk["batch"]).data


class Control:
    """The control: the reference in the program's place, its codes one
    bit narrower than the configuration's b, in b-bit slots."""

    def __init__(self, cfg, traffic, device):
        self.cfg, self.traffic = cfg, traffic

    def start_pass(self, coef: dict) -> None:
        self.coef = ref_coef(self.traffic, coef)

    def __call__(self, chunk) -> torch.Tensor:
        cfg = self.cfg
        ids, lengths = chunk["batch"].indices.to(torch.int64), chunk["lengths"]
        codes = ref.minhash_codes(ids, lengths, self.traffic["family"],
                                  self.coef, cfg["s"], cfg["b"] - 1)
        words = ref.pack(codes, cfg["b"])
        return (words - ((words >> 31) << 32)).to(torch.int32)


def make_chunks(ctx: Ctx, data: gen.SetStream) -> list:
    from repro_torch.data.sparse import SparseBatch
    step = ctx.traffic["chunk_rows"]
    chunks = []
    for start in range(0, data.n, step):
        stop = min(start + step, data.n)
        idx, mask, lengths = data.batch(start, stop, ctx.device)
        chunks.append({"batch": SparseBatch(idx, mask), "lengths": lengths,
                       "start": start, "rows": stop - start,
                       "nonzeros": int(lengths.sum())})
    return chunks


def run(ctx: Ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    k, b, family = cfg["k"], cfg["b"], tr["family"]
    with ctx.span("setup.data"):        # the device's context comes first
        data = gen.SetStream(ctx.seed, 0, cfg["n_rows"], cfg["D"],
                             cfg["row_nnz"]["knots"])
        chunks = make_chunks(ctx, data)
    with ctx.span("setup.program"):
        ring = CopyRing(SLOTS, (tr["chunk_rows"], k * b // 32), ctx.device)
        prog = (Control if ctx.control else Program)(cfg, tr, ctx.device)
    # warm-up: the whole path once, with a draw the window never makes
    with ctx.span("setup.warm"):
        prog.start_pass(gen.coefficients(ctx.seed, WARM_DRAW, family, k))
        ring.put(0, prog(chunks[0]))
        ring.wait(0)
    ctx.open_window()

    pending = collections.deque()      # (slot, pass, chunk index)
    kept = []                          # (pass, chunk, rows, words)
    done_rows = sent_rows = 0
    lanes = np.arange(tr["keep_per_chunk"], dtype=np.int64) * 0x9E3779B9

    def retire():
        nonlocal done_rows
        slot, p, ci = pending.popleft()
        with ctx.span("d2h.wait"):
            host = ring.wait(slot)
        c = chunks[ci]
        draws = gen.mix32((lanes + gen.stream_key(ctx.seed, 4, p, ci))
                          & gen.M32)
        rows = np.unique((draws * c["rows"]) >> 32)
        kept.append((p, ci, rows, host[rows].copy()))
        done_rows += c["rows"]

    p, slot, traced = 0, 0, []
    while not ctx.window_over():
        with ctx.span("family"):
            prog.start_pass(gen.coefficients(ctx.seed, p, family, k))
        for ci, c in enumerate(chunks):
            if ctx.window_over():
                break
            ctx.tick()
            if len(pending) == SLOTS:
                retire()
            if ctx.profiling:
                traced.append(ci)
            with ctx.span("engine.call"):
                out = prog(c)
            with ctx.span("d2h.copy"):
                ring.put(slot, out)
            pending.append((slot, p, ci))
            sent_rows += c["rows"]
            slot = (slot + 1) % SLOTS
        p += 1
    while pending:
        retire()
    window_s = ctx.close_window()
    prog = out = None           # the program's state goes before the check

    checks = check(ctx, data, chunks, kept)
    work = {"k": k, "b": b, "four_u": family == "4u",
            "rows": [chunks[ci]["rows"] for ci in traced],
            "nonzeros": [chunks[ci]["nonzeros"] for ci in traced]}
    return Outcome(attempted=sent_rows, failed=sent_rows - done_rows,
                   values={"preprocess_rows_per_s": done_rows / window_s},
                   checks=checks, work=work)


def check(ctx: Ctx, data: gen.SetStream, chunks: list, kept: list) -> dict:
    """Rows of the sample whose words differ from the reference's."""
    cfg, tr = ctx.config, ctx.traffic
    pool = [(p, ci, int(r), w) for p, ci, rows, ws in kept
            for r, w in zip(rows, ws)]
    rng = np.random.default_rng([gen.stream_key(ctx.seed, 5)])
    pick = rng.choice(len(pool), min(tr["check_rows"], len(pool)),
                      replace=False) if pool else []
    by_pass = collections.defaultdict(list)
    for i in sorted(pick):
        by_pass[pool[i][0]].append(pool[i])
    wrong = 0
    for p, items in by_pass.items():
        coef = gen.coefficients(ctx.seed, p, tr["family"], cfg["k"])
        rows = torch.tensor([chunks[ci]["start"] + r for _, ci, r, _ in items],
                            dtype=torch.int64, device=ctx.device)
        codes = ref.minhash_codes(data.ids(rows), data.lengths(rows),
                                  tr["family"], ref_coef(tr, coef), cfg["s"],
                                  cfg["b"])
        want = ref.pack(codes, cfg["b"])
        got = torch.from_numpy(np.stack([w for _, _, _, w in items]))
        wrong += ref.rows_differing(got, want.cpu())
    return {"rows_wrong": {"value": wrong, "limit": 0},
            "rows_checked": {"value": len(pick), "at_least": 1}}
