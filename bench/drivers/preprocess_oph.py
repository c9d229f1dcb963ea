"""Driver of the OPH preprocessing mix: passes over a device-resident data
set through ``SignatureEngine.packed_signatures`` on an ``OPH`` family,
the packed words of every chunk copied back to host memory.

The loop is the preprocessing driver's (``bench/drivers/preprocess.py``,
whose ``CopyRing`` and ``make_chunks`` it takes): set-up makes the rows
on the device from the seed and sends one chunk through the whole path
with a draw the window never makes; each pass of the window draws one
fresh 2U function (``gen.coefficients(seed, pass, "2u", 1)``), builds a
fresh ``OPH`` of k bins over it and a fresh engine, and sends the chunks
in order into a ring of ``SLOTS`` pinned host slots.

Checked: ``check_rows`` of the rows whose words reached the host (drawn
from the seed among ``keep_per_chunk`` of every chunk), made again from
the generator, against ``bench/reference_oph.py`` under the same
function, all in one call (one function a row).  The share of empty
bins before densification in those rows is printed on standard error.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from bench import generator as gen
from bench import reference as ref
from bench import reference_oph as ref_oph
from bench.drivers.preprocess import SLOTS, WARM_DRAW, CopyRing, make_chunks
from bench.harness import Ctx, Outcome

# The CPU tests' size of a cell of this driver: 20-60 nonzeros in 64 bins
# leave most bins empty, so the rotation fills most of them.
TINY = ({"n_rows": 300, "k": 64, "row_nnz": {"knots": [20, 45, 60]}},
        {"chunk_rows": 100, "check_rows": 64, "trace_seconds": 0.2})
PROGRAM_CALL = "repro_torch.kernels.engine:SignatureEngine.packed_signatures"


def draw(ctx: Ctx, p: int) -> dict:
    """The one 2U function of pass ``p``."""
    return gen.coefficients(ctx.seed, p, ctx.traffic["family"], 1)


class Program:
    """The timed path: a fresh OPH family and engine per pass, one call
    per chunk."""

    def __init__(self, cfg, device):
        from repro_torch.core.hashing import Hash2U
        from repro_torch.core.oph import OPH
        from repro_torch.kernels.engine import SignatureEngine
        self.cfg, self.device = cfg, device
        self.hash2u, self.oph, self.engine_cls = Hash2U, OPH, SignatureEngine

    def start_pass(self, coef: dict) -> None:
        cfg = self.cfg
        base = self.hash2u.from_numpy(coef["a1"], coef["a2"], cfg["s"],
                                      device=self.device)
        fam = self.oph(base, k=cfg["k"], densify=cfg["densify"])
        self.engine = self.engine_cls(fam, b=cfg["b"], packed=True)

    def __call__(self, chunk) -> torch.Tensor:
        return self.engine.packed_signatures(chunk["batch"]).data


class Control:
    """The control: the reference in the program's place, its codes one
    bit narrower than the configuration's b, in b-bit slots."""

    def __init__(self, cfg, device):
        self.cfg = cfg

    def start_pass(self, coef: dict) -> None:
        self.coef = coef

    def __call__(self, chunk) -> torch.Tensor:
        cfg, c = self.cfg, self.coef
        ids = chunk["batch"].indices.to(torch.int64)
        codes = ref_oph.oph_codes(ids, chunk["lengths"], c["a1"], c["a2"],
                                  cfg["s"], cfg["k"], cfg["b"] - 1)
        words = ref.pack(codes, cfg["b"])
        return (words - ((words >> 31) << 32)).to(torch.int32)


def run(ctx: Ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    k, b = cfg["k"], cfg["b"]
    with ctx.span("setup.data"):        # the device's context comes first
        data = gen.SetStream(ctx.seed, 0, cfg["n_rows"], cfg["D"],
                             cfg["row_nnz"]["knots"])
        chunks = make_chunks(ctx, data)
    with ctx.span("setup.program"):
        ring = CopyRing(SLOTS, (tr["chunk_rows"], k * b // 32), ctx.device)
        prog = (Control if ctx.control else Program)(cfg, ctx.device)
    # warm-up: the whole path once, with a draw the window never makes
    with ctx.span("setup.warm"):
        prog.start_pass(draw(ctx, WARM_DRAW))
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
            prog.start_pass(draw(ctx, p))
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
    work = {"k": k, "b": b, "four_u": False,
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
    pick = sorted(rng.choice(len(pool), min(tr["check_rows"], len(pool)),
                             replace=False)) if pool else []
    if not pick:
        return {"rows_wrong": {"value": 0, "limit": 0},
                "rows_checked": {"value": 0, "at_least": 1}}
    items = [pool[i] for i in pick]
    coef = {p: draw(ctx, p) for p in sorted({p for p, _, _, _ in items})}
    a1, a2 = (torch.tensor([int(coef[p][key][0]) for p, _, _, _ in items],
                           dtype=torch.int64, device=ctx.device)
              for key in ("a1", "a2"))
    rows = torch.tensor([chunks[ci]["start"] + r for _, ci, r, _ in items],
                        dtype=torch.int64, device=ctx.device)
    ids, lengths = data.ids(rows), data.lengths(rows)
    s, k, b = cfg["s"], cfg["k"], cfg["b"]
    bins = ref_oph.oph_bins(ids, lengths, a1, a2, s, k)
    empty = int((bins == ref_oph.EMPTY).sum())
    print(f"empty bins before densification in the checked rows: {empty} "
          f"of {bins.numel()} ({100.0 * empty / bins.numel():.4f}%)",
          file=sys.stderr)
    codes = ref_oph.densify_rotation(bins, (1 << s) // k) & ((1 << b) - 1)
    want = ref.pack(codes, b)
    got = torch.from_numpy(np.stack([w for _, _, _, w in items]))
    wrong = ref.rows_differing(got, want.cpu())
    return {"rows_wrong": {"value": wrong, "limit": 0},
            "rows_checked": {"value": len(pick), "at_least": 1}}
