#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (Hopper, sm_90a):

    python3 chip_smoke.py

It builds the four signature kernels from ``src/repro_torch/csrc`` into
``build/kernels/``, holds each against its plain PyTorch version at the
width of the paper's webspam (trigram) dataset, then drives the paper's
main path -- §3 GPU preprocessing -> packed ``.sig`` cache -> §6 online
SGD -- and the §3 batch entry point ``preprocess_shards``, and checks
what comes out.  Scratch data goes to ``build/smoke/`` and is removed at
the end.  It exits non-zero, with no result line, when there is no CUDA
device, when it is not run from a checkout, or when any check fails.

Output: one line per phase and kernel, the card's name and power limit,
a ``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"

# Published H100 SXM rates (NVIDIA data sheet; full 700 W power limit):
# HBM3 at 3.35 TB/s, and 67 TFLOP/s float32 outside the tensor cores,
# i.e. 33.5e12 lane-instructions/s (128 lanes per SM, an FMA counted
# once) -- the dispatch rate that also bounds 32-bit integer instructions.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# The least 32-bit lane-instructions each function needs, in sm_90 SASS
# forms.  2U hash: one IMAD (a1 + a2*t, mod 2^32); variant high's shift
# keeps the order of values, min(v >> x) == (min v) >> x, so minhash needs
# it once per (row, j) and OPH, which splits every value, once per
# nonzero.  4U hash: three Horner steps of 6 -- IMAD.WIDE.U32 (acc*t +
# coef, mod 2^64), each fold as LOP3 (x & p) + LEA.HI (adding the funnel
# shift), the conditional subtract as one VIADDMNMX.U32, min(v, v - p) --
# then the s-bit mask.  Minhash's running min takes half a VIMNMX3 per
# (nonzero, j) (a three-input min folds in two values); its epilogue
# takes the b-bit mask and, packed, one IMAD per code.  OPH takes bin,
# offset, the bin's shared address and the atomicMin per nonzero, and
# three per bin to write sentinel codes.
OPS_2U, OPS_SHIFT, OPS_4U = 1, 1, 3 * 6 + 1
OPS_MIN, OPS_SCATTER, OPS_CODE = 0.5, 4, 3

SEED = 0
K_OPH, K_MIN, K_PAPER, S, B = 512, 512, 500, 24, 8
CHUNK = 10_000
ACC_MARGIN = 0.30      # test accuracy must exceed chance (0.5) by this
REPS = 7               # timed launches per kernel, after one warm-up

KERNEL_INFO = {
    "oph2u": ("src/repro_torch/csrc/oph.cu", "src/repro/kernels/oph.py:141"),
    "oph4u": ("src/repro_torch/csrc/oph.cu", "src/repro/kernels/oph.py:178"),
    "minhash2u": ("src/repro_torch/csrc/minhash.cu",
                  "src/repro/kernels/minhash.py:177"),
    "minhash4u": ("src/repro_torch/csrc/minhash.cu",
                  "src/repro/kernels/minhash.py:213"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, torch) -> float:
    """Device milliseconds of one call of ``fn``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, torch) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, torch) for _ in range(REPS))


def max_abs_err(got, want) -> int:
    """Largest |difference| of two int32 uint32-pattern tensors."""
    from repro_torch.core.u32 import widen
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((widen(got) - widen(want)).abs().max()) if got.numel() else 0


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oph_ops(nonzeros: int, n: int, k: int, four_u: bool, code_b: int) -> float:
    per_nz = OPS_4U if four_u else OPS_2U + OPS_SHIFT
    return nonzeros * (per_nz + OPS_SCATTER) + n * k * (OPS_CODE if code_b else 0)


def minhash_ops(nonzeros: int, n: int, k: int, four_u: bool, b: int,
                pack: bool) -> float:
    """2U in variant high, the only one this script runs."""
    per_eval = (OPS_4U if four_u else OPS_2U) + OPS_MIN
    per_out = (0 if four_u else OPS_SHIFT) + (b > 0) + pack
    return nonzeros * k * per_eval + n * k * per_out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a repository checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return run(torch)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)


def run(torch) -> int:
    from repro_torch.core.u32 import to_numpy
    from repro_torch.data.pipeline import SignatureStream, write_shards
    from repro_torch.data.preprocess import preprocess_shards
    from repro_torch.data.sigshard import read_sig_shard
    from repro_torch.data.sparse import from_lists
    from repro_torch.data.synthetic import DatasetSpec, generate_sets
    from repro_torch.kernels import batch_signatures, build
    from repro_torch.kernels import minhash as kmin
    from repro_torch.kernels import oph as koph
    from repro_torch.kernels.engine import oph_epilogue
    from repro_torch.kernels.pack import PackSpec, pack_device
    from repro_torch.train.online import (OnlineTrainer, SignatureCache,
                                          make_family)

    dev = torch.device("cuda")
    wrappers = {"oph2u": koph.oph2u_cuda, "oph4u": koph.oph4u_cuda,
                "minhash2u": kmin.minhash2u_cuda,
                "minhash4u": kmin.minhash4u_cuda}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {name: w.launches for name, w in wrappers.items()}

    # -- phase 1: device and build --------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}  torch {torch.__version__} cuda {torch.version.cuda}"
        f"  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    per_source = build.build_all()
    log(f"[build] nvcc sm_90a, parallel: {time.perf_counter() - t0:.2f} s "
        f"wall ({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")

    # -- data: webspam (trigram) width, rows cut to fit the time limit ----
    spec = DatasetSpec("webspam_trigram_width", n=50_000, D=2**24,
                       avg_nnz=3_728, n_prototypes=6, overlap=0.7, seed=7)
    t0 = time.perf_counter()
    (train_sets, y_train), (test_sets, y_test) = generate_sets(spec)
    nnz_mean = sum(map(len, train_sets)) / len(train_sets)
    log(f"[data] {spec.name}: {len(train_sets)} train + {len(test_sets)} test"
        f" rows, D=2^{spec.D.bit_length() - 1}, mean nnz {nnz_mean:.1f}, generated in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    fams = {
        "oph2u": make_family("oph", K_OPH, S, densify="rotation",
                             generator=gen, device=dev),
        "oph4u": make_family("oph-4u", K_OPH, S, densify="rotation",
                             generator=gen, device=dev),
        ("minhash2u", K_MIN): make_family("2u", K_MIN, S, generator=gen,
                                          device=dev),
        ("minhash4u", K_MIN): make_family("4u", K_MIN, S, generator=gen,
                                          device=dev),
        ("minhash2u", K_PAPER): make_family("2u", K_PAPER, S, generator=gen,
                                            device=dev),
        ("minhash4u", K_PAPER): make_family("4u", K_PAPER, S, generator=gen,
                                            device=dev),
    }

    # -- phase 2: every kernel against its plain version, one full chunk --
    chunk = from_lists(train_sets[:CHUNK], y_train[:CHUNK], device=dev)
    idx, cnt = chunk.indices, chunk.nnz_per_row()
    n, nnz = idx.shape
    total_nnz = int(cnt.sum())
    log(f"[chunk] n={n} nnz(padded)={nnz} nonzeros={total_nnz}")
    in_bytes = 4 * total_nnz + 4 * n      # indices read once, counts
    plain_out = {}
    rows = {}

    def check(label, name, kernel_fn, plain_fn, io_bytes, ops, main):
        """``io_bytes``: the coefficients read and the outputs written."""
        got = kernel_fn()
        want = plain_fn()           # also the plain version's warm-up
        plain_ms = cuda_ms(plain_fn, torch)
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(max_abs_err(g, w) for g, w in pairs)
        if err:
            raise AssertionError(f"{label}: kernel != plain version "
                                 f"(max |err| {err})")
        ms = median_ms(kernel_fn, torch)
        b_ms, b_by = bound(in_bytes + io_bytes, ops)
        log(f"[kernel] {label}: {ms:.4f} ms median of {REPS} (CUDA events), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.1f} ms (1 call), "
            f"bit-exact on all {n} rows, launches {wrappers[name].launches}")
        if main:
            rows[name] = dict(name=name, route="cuda",
                              source=KERNEL_INFO[name][0],
                              replaces=KERNEL_INFO[name][1], launches=0,
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=None)
        return want

    bin_bits = K_OPH.bit_length() - 1
    base2, base4 = fams["oph2u"].base, fams["oph4u"].base
    for code_b in (0, B):
        out_bytes = 4 * n * K_OPH
        plain_out[("oph2u", code_b)] = check(
            f"oph2u k={K_OPH} s={S} code_b={code_b}", "oph2u",
            lambda: koph.oph2u_cuda(idx, cnt, base2.a1, base2.a2, s=S,
                                    bin_bits=bin_bits, code_b=code_b),
            lambda: koph.oph2u_plain(idx, cnt, base2.a1, base2.a2, s=S,
                                     bin_bits=bin_bits, code_b=code_b),
            4 * 2 + out_bytes, oph_ops(total_nnz, n, K_OPH, False, code_b),
            main=code_b == 0)
        plain_out[("oph4u", code_b)] = check(
            f"oph4u k={K_OPH} s={S} code_b={code_b}", "oph4u",
            lambda: koph.oph4u_cuda(idx, cnt, base4.a, s=S, bin_bits=bin_bits,
                                    code_b=code_b),
            lambda: koph.oph4u_plain(idx, cnt, base4.a, s=S,
                                     bin_bits=bin_bits, code_b=code_b),
            4 * 4 + out_bytes, oph_ops(total_nnz, n, K_OPH, True, code_b),
            main=code_b == 0)
    for k in (K_MIN, K_PAPER):
        for name in ("minhash2u", "minhash4u"):
            four_u = name == "minhash4u"
            fam = fams[(name, k)]
            coef = (fam.a1, fam.a2) if name == "minhash2u" else (fam.a,)
            cuda_fn = getattr(kmin, f"{name}_cuda")
            plain_fn = getattr(kmin, f"{name}_plain")
            packs = (False, True) if k % kmin.MINHASH_BLK_K == 0 else (False,)
            for pack in packs:
                io_bytes = (4 * k * (4 if four_u else 2) + 4 * n * k
                            + (n * k * B // 8 if pack else 0))
                plain_out[(name, k, pack)] = check(
                    f"{name} k={k} s={S} b={B} pack={pack}", name,
                    lambda: cuda_fn(idx, cnt, *coef, s=S, b=B, pack=pack),
                    lambda: plain_fn(idx, cnt, *coef, s=S, b=B, pack=pack),
                    io_bytes, minhash_ops(total_nnz, n, k, four_u, B, pack),
                    main=k == K_PAPER)
    log(f"kernels checked: {', '.join(sorted(rows))}")

    # -- phase 3: the main path, online learning -------------------------
    raw_dir = SMOKE_DIR / "raw"
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_shards(train_sets, y_train, str(raw_dir), 4)
    raw_bytes = sum(os.path.getsize(p) for p in paths)
    log(f"[shards] 4 binary shards, {raw_bytes} bytes, written in "
        f"{time.perf_counter() - t0:.1f} s")
    test = from_lists(test_sets, y_test, device=dev)

    class Recorder:
        """Pass-through source that keeps each epoch's packed words."""

        def __init__(self, source):
            self.source, self.epochs = source, []

        @property
        def cumulative_stats(self):
            return self.source.cumulative_stats

        def __iter__(self):
            self.epochs.append([])
            for sig, labels in self.source:
                self.epochs[-1].append(sig.data.clone())
                yield sig, labels

        def close(self):
            self.source.close()

    family = fams["oph2u"]
    reset_counts()
    t_main = time.perf_counter()
    stream = SignatureStream(paths, family, b=B, chunk_size=CHUNK, packed=True)
    cache = SignatureCache(stream, cache_dir=str(SMOKE_DIR / "cache"))
    source = Recorder(cache)
    sig_test = batch_signatures(test, family, b=B, packed=True)
    with OnlineTrainer(k=K_OPH, b=B, kind="svm", average=True, lam=1e-4,
                       eta0=0.5, batch_size=16, avg_start=100.0,
                       device=dev) as trainer:
        _, stats, evals = trainer.fit(
            source, 3, eval_fn=lambda tr: tr.evaluate(sig_test, test.labels))
        sig_paths = list(cache.paths)
        replay_words = [read_sig_shard(p)[0] for p in sig_paths]
        cache_stats = cache.stats
    main_s = time.perf_counter() - t_main
    path_counts = counts()
    for es, acc in zip(stats, evals):
        log(f"[epoch {es.epoch} {es.source}] load {es.load_s * 1e3:.1f} ms  "
            f"kernel {es.kernel_s * 1e3:.1f} ms  train {es.train_s * 1e3:.1f}"
            f" ms  read {es.bytes_read} B  examples {es.examples}  "
            f"test acc {acc:.4f}")
    log(f"[cache] raw {cache_stats.bytes_original} B -> .sig "
        f"{cache_stats.bytes_cached} B: reduction "
        f"{cache_stats.reduction():.2f}x ({cache_stats.shards} shards)")
    log(f"[main path] {main_s:.1f} s, launches {path_counts}")
    if path_counts["oph2u"] < 1:
        raise AssertionError("the online path never launched oph2u")
    if not evals[-1] > 0.5 + ACC_MARGIN:
        raise AssertionError(f"test accuracy {evals[-1]:.4f} is not above "
                             f"chance + {ACC_MARGIN}")
    epoch0 = [to_numpy(w) for w in source.epochs[0]]
    for e in (1, 2):
        if stats[e].source != "cache":
            raise AssertionError(f"epoch {e} did not replay the cache")
        replay = [to_numpy(w) for w in source.epochs[e]]
        if len(replay) != len(epoch0) or any(
                (a != r).any() for a, r in zip(epoch0, replay)):
            raise AssertionError(f"epoch {e} replay != epoch 0 words")
    if len(replay_words) != len(epoch0) or any(
            (a != r).any() for a, r in zip(epoch0, replay_words)):
        raise AssertionError(".sig shards do not decode to epoch 0's words")
    log(f"[main path] replayed .sig shards == epoch 0 words "
        f"({len(epoch0)} chunks); final ASGD test acc {evals[-1]:.4f}")

    # -- phase 4: the §3 batch entry point -------------------------------
    reset_counts()
    batch_cases = [
        ("2u", fams[("minhash2u", K_PAPER)],
         pack_device(plain_out[("minhash2u", K_PAPER, False)],
                     PackSpec(K_PAPER, B))),
        ("4u", fams[("minhash4u", K_PAPER)],
         pack_device(plain_out[("minhash4u", K_PAPER, False)],
                     PackSpec(K_PAPER, B))),
        ("oph-4u", fams["oph4u"],
         oph_epilogue(plain_out[("oph4u", 0)], k=K_OPH, s=S,
                      bin_bits=bin_bits, densify="rotation", b=B,
                      packed=True)),
    ]
    for scheme, fam, want_words in batch_cases:
        out_dir = SMOKE_DIR / f"sig_{scheme}"
        st = preprocess_shards(paths, str(out_dir), fam, b=B,
                               chunk_size=CHUNK)
        words, labels, meta = read_sig_shard(str(out_dir / "sig_00000.sig"))
        if not ((words == to_numpy(want_words)).all()
                and (labels == y_train[:CHUNK]).all()):
            raise AssertionError(f"preprocess_shards {scheme}: first .sig "
                                 "shard != plain path")
        log(f"[preprocess {scheme} k={fam.k} b={B}] {st.examples} rows: "
            f"{st.examples / (st.load_s + st.kernel_s + st.store_s):.0f} "
            f"rows/s end to end; load {st.load_s * 1e3:.1f} ms, kernel "
            f"{st.kernel_s * 1e3:.1f} ms, store {st.store_s * 1e3:.1f} ms; "
            f"kernel/load {st.kernel_s / st.load_s:.4f}; reduction "
            f"{st.reduction():.2f}x; first shard == plain path")
    batch_counts = counts()
    log(f"[preprocess] launches {batch_counts}")
    for name in ("oph4u", "minhash2u", "minhash4u"):
        if batch_counts[name] < 1:
            raise AssertionError(f"preprocess_shards never launched {name}")

    for name, row in rows.items():
        row["launches"] = path_counts[name] + batch_counts[name]
    log(json.dumps({"kernels": [rows[k] for k in KERNEL_INFO]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
