"""Serving launcher (port of ``repro.launch.serve``): LM decoding, recsys
scoring and similarity search.

    PYTHONPATH=src python -m repro_torch.launch.serve
        --arch deepseek-7b|yi-34b|mistral-large-123b|llama4-scout-17b-a16e|
               deepseek-v3-671b
        [--smoke | --no-smoke] [--tokens N] [--device cuda|cpu]

Builds the LM arch's ``decode_32k`` cell (``--no-smoke``: the published
config and cell), draws its weights from a seeded generator on the device,
and decodes ``--tokens`` greedy steps from pos = 1 over a zero cache,
as the reference does.  Prints the tokens, batch, wall seconds (host clock
to a synchronize, the first step included) and tokens/s, and the first
sequence's first 8 tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve
        --arch wide-deep|autoint|din|mind
        [--smoke | --no-smoke] [--requests N] [--device cuda|cpu]

Builds the recsys arch's ``serve_p99`` cell (``--no-smoke``: the published
widths), draws its weights from a seeded generator on the device, and
scores ``--requests`` fresh batches of random inputs through
``serve_scores``, after one untimed request that builds the kernels.
Each batch is drawn before its timer starts, as in the reference.  Prints
requests, batch and the p50 / p99 (the slowest) request ms on a host
clock that waits for the device, as the reference does.

    PYTHONPATH=src python -m repro_torch.launch.serve --index
        [--mode exact|lsh] [--docs N] [--queries N] [--requests N]
        [--topk K] [--k K] [--b B] [--scheme S] [--densify D]
        [--threshold T] [--shards S] [--device-window BYTES]
        [--serve --rate QPS --zipf-alpha A --max-delay-ms MS --workers N
         --admission none|reject|shed-oldest|degrade-to-lsh --max-queue Q
         --on-shard-failure fail|partial --deadline-budget-ms MS
         --metrics-port P --trace-out PATH] [--device cuda|cpu]

Makes a synthetic corpus, hashes it to packed ``.sig`` shards
(``preprocess_shards``), builds the banded ``.idx`` (or ``--shards S``
of them behind a ``ShardedIndex``), then serves ``--requests`` batches of
``--queries`` corpus rows through ``submit`` / ``flush`` and prints the
p50 / max batch latency, q/s and self-hit@1.
``--device-window`` caps the device-resident packed corpus bytes
(``max_device_bytes``): beyond it the exact path streams mmap windows.
``--serve`` puts the continuous-batching ``SearchServer`` in front of the
searcher instead and replays ``--requests x --queries`` Zipf-popular
corpus rows at a Poisson ``--rate`` offered load (``--queries`` is then
the server's ``max_batch``), printing the server's latency, queue-wait and
flush percentiles, achieved q/s, worker occupancy and admission
accounting; ``--metrics-port`` serves live Prometheus metrics and
``--trace-out`` writes the request span trees as trace-event JSON.

Both run on the card unless ``--device cpu``, where the kernels' plain
versions run.  ``--arch gatedgcn`` is refused: the GNN family has no
serving cell (the reference dies on it with a ``KeyError``).
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
            searcher = load_sharded(
                shard_dir, device=dev, max_device_bytes=args.device_window,
                on_shard_failure=args.on_shard_failure or "fail")
            words_of = _sharded_row_reader(searcher)
            what = f"{args.shards} shards"
            streamed = any(s.streamed for s in searcher.searchers)
        else:
            path = os.path.join(tmp, "corpus.idx")
            meta = build_index(sig_paths, path, cfg, device=dev)
            t_build = time.perf_counter() - t0
            n_total, payload = meta.n, meta.payload_bytes
            index = load_index(path, device=dev)
            searcher = IndexSearcher(index, device=dev,
                                     max_device_bytes=args.device_window)
            words_of = lambda i: np.asarray(index.words_host[i])
            what = "1 index"
            streamed = searcher.streamed
        print(f"indexed {n_total} docs into {what} (k={k} b={b} "
              f"bands={cfg.n_bands}x{cfg.rows_per_band}): "
              f"hash {t_hash:.2f}s, build {t_build:.2f}s, "
              f"payload {payload:,} B"
              + (f", streamed (window {args.device_window:,} B)"
                 if streamed else ""))
        if args.serve:
            _serve_traffic(searcher, words_of, n_total, args)
            return
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


def _serve_traffic(searcher, words_of, n_total: int, args) -> None:
    """Open-loop serving: SearchServer under Zipf/Poisson traffic."""
    from repro_torch.launch.server import (RequestShed, SearchServer,
                                           ZipfianTraffic)
    from repro_torch.obs.trace import get_tracer

    exporter = None
    if args.metrics_port is not None:
        from repro_torch.obs.export import start_http_exporter
        exporter = start_http_exporter(port=args.metrics_port)
        print(f"metrics: {exporter.url}/metrics "
              f"(JSON {exporter.url}/metrics.json, "
              f"trace {exporter.url}/trace)")
    tracer = get_tracer()
    if args.trace_out:
        tracer.reset(enabled=True)

    traffic = ZipfianTraffic(n_total, alpha=args.zipf_alpha, seed=1)
    m = args.requests * args.queries
    ids = traffic.ids(m)
    arrivals = traffic.arrival_offsets(m, args.rate)
    budget = (args.deadline_budget_ms / 1e3
              if args.deadline_budget_ms is not None else None)
    server = SearchServer(searcher, max_batch=args.queries,
                          max_delay_s=args.max_delay_ms / 1e3,
                          topk=args.topk, mode=args.mode,
                          num_workers=args.workers,
                          admission=args.admission,
                          max_queue=args.max_queue,
                          deadline_budget_s=budget,
                          on_shard_failure=args.on_shard_failure)
    try:
        with server:
            t_start = time.monotonic()
            handles = []
            for doc, at in zip(ids, arrivals):
                lag = at - (time.monotonic() - t_start)
                if lag > 0:
                    time.sleep(lag)
                handles.append(server.submit(words_of(int(doc)),
                                             deadline_s=budget))
            for h in handles:
                try:
                    h.result(timeout=120.0)
                except RequestShed:
                    pass                # accounted in stats.shed
            elapsed = time.monotonic() - t_start
    finally:
        if args.trace_out:
            n_ev = tracer.export(args.trace_out)
            print(f"trace: wrote {n_ev} events to {args.trace_out} "
                  "(open in https://ui.perfetto.dev)")
        if exporter is not None:
            exporter.close()
    snap = server.stats.snapshot()
    print(f"served {snap['requests']} requests in {snap['batches']} "
          f"micro-batches over {snap['workers']} worker(s) "
          f"(mean {snap['mean_batch']:.1f}/batch, "
          f"offered {args.rate:.0f} q/s, achieved "
          f"{snap['requests'] / elapsed:.0f} q/s)")
    print(f"latency p50={snap['latency_p50_ms']:.1f}ms "
          f"p99={snap['latency_p99_ms']:.1f}ms  queue-wait "
          f"p50={snap['queue_wait_p50_ms']:.1f}ms  flush "
          f"p50={snap['flush_p50_ms']:.1f}ms  triggers: "
          f"full={snap['flush_full']} aged={snap['flush_aged']} "
          f"deadline={snap['flush_deadline']} drain={snap['flush_drain']}")
    occ = " ".join(f"{o:.2f}" for o in snap["worker_occupancy"])
    print(f"admission={args.admission}: shed={snap['shed']} "
          f"(rate {snap['shed_rate']:.3f}) degraded={snap['degraded']} "
          f"deadline-miss rate {snap['deadline_miss_rate']:.3f}  "
          f"worker occupancy [{occ}]")
    if args.on_shard_failure == "partial" or snap["partial"]:
        print(f"fault tolerance: partial={snap['partial']} "
              f"(rate {snap['partial_rate']:.3f}) "
              f"mean coverage {snap['mean_coverage']:.3f} "
              f"worker restarts {snap['worker_restarts']}")


def serve_lm(args) -> None:
    """The LM workload: greedy decode ``--tokens`` steps with ``--arch``."""
    from repro_torch.launch.steps import build_cell, init_inputs

    dev = resolve_device(args.device)
    prog = build_cell(args.arch, "decode_32k", smoke=args.smoke, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = prog.init_params(gen)
    inputs = init_inputs(prog, gen)
    cache, tokens = inputs["cache"], inputs["tokens"]
    t0 = time.perf_counter()
    out_tokens = [tokens]
    for pos in range(1, args.tokens + 1):
        tokens, cache = prog.step(model, {"cache": cache, "tokens": tokens,
                                          "pos": pos})
        out_tokens.append(tokens)
    first = [int(t[0]) for t in out_tokens[:8]]     # waits for the device
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x batch {tokens.shape[0]} "
          f"in {dt:.2f}s ({args.tokens * tokens.shape[0] / dt:.1f} "
          f"tok/s); first sequence: {first}")


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
                    help="decode an LM arch's decode_32k cell, or serve a "
                         "recsys arch's serve_p99 cell (wide-deep, "
                         "autoint, din, mind)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the arch for a fast smoke run "
                         "(--no-smoke serves the full-size config)")
    ap.add_argument("--index", action="store_true",
                    help="serve the similarity-search index workload")
    ap.add_argument("--tokens", type=int, default=16,
                    help="greedy decode steps (an LM --arch)")
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
    ap.add_argument("--device-window", type=int, default=None,
                    help="max device-resident packed-corpus bytes; larger "
                         "corpora stream mmap windows (--index)")
    ap.add_argument("--serve", action="store_true",
                    help="drive the continuous-batching SearchServer "
                         "under open-loop Zipf/Poisson traffic (--index)")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="offered load in queries/s (--serve)")
    ap.add_argument("--zipf-alpha", type=float, default=1.1,
                    help="query-popularity Zipf exponent (--serve)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="micro-batching window: max time the oldest "
                         "queued request waits before a flush (--serve)")
    ap.add_argument("--workers", type=int, default=None,
                    help="dispatch workers draining the admission queue, "
                         "each on its own CUDA stream (--serve; default 1)")
    ap.add_argument("--admission", default="none",
                    choices=("none", "reject", "shed-oldest",
                             "degrade-to-lsh"),
                    help="overload policy when the queue is full or the "
                         "projected wait blows the deadline budget "
                         "(--serve)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission-queue depth; beyond it the "
                         "--admission policy fires (--serve)")
    ap.add_argument("--on-shard-failure", default=None,
                    choices=("fail", "partial"),
                    help="shard-failure policy of the sharded router: "
                         "'partial' serves surviving shards with coverage "
                         "accounting (--serve --shards)")
    ap.add_argument("--deadline-budget-ms", type=float, default=None,
                    help="per-request latency budget the admission "
                         "policy defends (--serve)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live Prometheus metrics on this port "
                         "(/metrics, /metrics.json, /trace; 0 = "
                         "ephemeral; --serve)")
    ap.add_argument("--trace-out", default=None,
                    help="enable request tracing and write the "
                         "Perfetto-loadable trace-event JSON here on "
                         "exit (--serve)")
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
        family = get_arch(args.arch).family
    except KeyError as e:
        ap.error(e.args[0])
    if family == "gnn":
        ap.error(f"--arch {args.arch}: the GNN family has no serving cell "
                 "(its cells train: python -m repro_torch.launch.train)")
    if family == "lm":
        serve_lm(args)
    else:
        serve_recsys(args)


if __name__ == "__main__":
    main()
