"""Serving launcher (port of ``repro.launch.serve``): recsys scoring and
similarity search.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch wide-deep
        [--smoke | --no-smoke] [--requests N] [--device cuda|cpu]

Builds the arch's ``serve_p99`` cell (``--no-smoke``: the published
widths), draws its weights from a seeded generator on the device, and
scores ``--requests`` fresh batches of random inputs through
``serve_scores``, after one untimed request that builds the kernels.
Each batch is drawn before its timer starts, as in the reference.  Prints
requests, batch and the p50 / p99 (the slowest) request ms on a host
clock that waits for the device, as the reference does.

    PYTHONPATH=src python -m repro_torch.launch.serve --index
        [--mode exact|lsh] [--docs N] [--queries N] [--requests N]
        [--topk K] [--k K] [--b B] [--scheme S] [--densify D]
        [--threshold T] [--shards S] [--device cuda|cpu]

Makes a synthetic corpus, hashes it to packed ``.sig`` shards
(``preprocess_shards``), builds the banded ``.idx`` (or ``--shards S``
of them behind a ``ShardedIndex``), then serves ``--requests`` batches of
``--queries`` corpus rows through ``submit`` / ``flush`` and prints the
p50 / max batch latency, q/s and self-hit@1.

Both run on the card unless ``--device cpu``, where the kernels' plain
versions run.
"""

from __future__ import annotations

import argparse
import glob
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def serve_index(args) -> None:
    """The retrieval workload: build a .idx, serve batched queries."""
    from repro_torch.data.pipeline import make_sharded_dataset
    from repro_torch.data.preprocess import preprocess_shards
    from repro_torch.data.synthetic import DatasetSpec
    from repro_torch.index import (IndexSearcher, build_index, build_sharded,
                                   choose_band_config, load_index,
                                   load_sharded)
    from repro_torch.train.online import make_family

    dev = resolve_device(args.device)
    k, b, s = args.k, args.b, 16
    spec = DatasetSpec("serve_index", n=args.docs, D=1 << s,
                       avg_nnz=64, n_prototypes=8, overlap=0.8, seed=0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_index_") as tmp:
        raw = make_sharded_dataset(spec, os.path.join(tmp, "raw"),
                                   n_shards=4)
        fam = make_family(args.scheme, k, s, densify=args.densify,
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
        t0 = time.perf_counter()
        preprocess_shards(raw, os.path.join(tmp, "sig"), fam, b=b,
                          chunk_size=max(64, args.docs // 4),
                          loader_kwargs={"lane_multiple": 8})
        t_hash = time.perf_counter() - t0
        sig_paths = sorted(glob.glob(os.path.join(tmp, "sig", "*.sig")))
        cfg = choose_band_config(
            k, b, code_bits=(b + 1 if args.densify == "sentinel" else b),
            threshold=args.threshold)
        t0 = time.perf_counter()
        if args.shards > 1:
            shard_dir = os.path.join(tmp, "shards")
            built = build_sharded(sig_paths, shard_dir, cfg,
                                  n_shards=args.shards, device=dev)
            t_build = time.perf_counter() - t0
            n_total = sum(m.n for _, m in built)
            payload = sum(m.payload_bytes for _, m in built)
            searcher = load_sharded(shard_dir, device=dev)
            words_of = _sharded_row_reader(searcher)
            what = f"{args.shards} shards"
        else:
            path = os.path.join(tmp, "corpus.idx")
            meta = build_index(sig_paths, path, cfg, device=dev)
            t_build = time.perf_counter() - t0
            n_total, payload = meta.n, meta.payload_bytes
            index = load_index(path, device=dev)
            searcher = IndexSearcher(index, device=dev)
            words_of = lambda i: np.asarray(index.words_host[i])
            what = "1 index"
        print(f"indexed {n_total} docs into {what} (k={k} b={b} "
              f"bands={cfg.n_bands}x{cfg.rows_per_band}): "
              f"hash {t_hash:.2f}s, build {t_build:.2f}s, "
              f"payload {payload:,} B")
        rng = np.random.default_rng(1)
        lat = []
        hits0 = None
        for _ in range(args.requests):
            picks = rng.integers(0, n_total, args.queries)
            for i in picks:
                searcher.submit(words_of(int(i)))
            t0 = time.perf_counter()
            out = searcher.flush(args.topk, mode=args.mode)
            lat.append((time.perf_counter() - t0) * 1e3)
            if hits0 is None:
                hits0 = np.mean([float(res.indices[0, 0] == q)
                                 for res, q in zip(out.values(), picks)])
        lat = sorted(lat)
        qps = args.queries * args.requests / (sum(lat) / 1e3)
        print(f"{args.requests} batches x {args.queries} queries "
              f"({args.mode}): p50={lat[len(lat) // 2]:.1f}ms "
              f"max={lat[-1]:.1f}ms {qps:.0f} q/s "
              f"self-hit@1={hits0:.2f}")


def serve_recsys(args) -> None:
    """The recsys workload: score synthetic requests with ``--arch``."""
    from repro_torch.launch.steps import build_cell, init_inputs

    dev = resolve_device(args.device)
    prog = build_cell(args.arch, "serve_p99", smoke=args.smoke, device=dev)
    model = prog.init_params(torch.Generator(device=dev).manual_seed(0))

    def inputs(r: int) -> dict:
        return init_inputs(prog, torch.Generator(device=dev).manual_seed(r))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prog.step(model, inputs(args.requests))  # warm-up: builds the kernels
    lat = []
    for r in range(args.requests):
        batch = inputs(r)                   # drawn outside the timed step
        sync()
        t0 = time.perf_counter()
        scores = prog.step(model, batch)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat)
    print(f"{args.requests} requests, batch {scores.shape[0]}: "
          f"p50={lat[len(lat) // 2]:.1f}ms p99={lat[-1]:.1f}ms")


def _sharded_row_reader(sharded):
    """Global doc id -> packed query row, off the shards' mmaps."""
    offsets = list(sharded.offsets) + [sharded.n]

    def words_of(i: int) -> np.ndarray:
        shard = int(np.searchsorted(offsets, i, side="right")) - 1
        local = i - int(offsets[shard])
        return np.asarray(sharded.searchers[shard].index.words_host[local])
    return words_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="serve a recsys arch's serve_p99 cell (wide-deep)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the arch for a fast smoke run "
                         "(--no-smoke serves the full-size config)")
    ap.add_argument("--index", action="store_true",
                    help="serve the similarity-search index workload")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--mode", choices=("exact", "lsh"), default="lsh")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=16,
                    help="queries admitted per batch")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--scheme", default="oph")
    ap.add_argument("--densify", default="rotation")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--shards", type=int, default=1,
                    help="serve through a ShardedIndex router over S "
                         ".idx shards")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the plain versions)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.index:
        serve_index(args)
        return
    if not args.arch:
        ap.error("--arch is required unless --index is given")
    from repro_torch.configs import get_arch
    try:
        get_arch(args.arch)
    except KeyError as e:
        ap.error(e.args[0])
    serve_recsys(args)


if __name__ == "__main__":
    main()
