"""Continuous-batching search server over the similarity-search index
(port of ``repro.launch.server``).

A thread-safe admission queue in front of any ``search``-speaking
searcher (``IndexSearcher`` or the sharded ``ShardedIndex`` router),
drained by a POOL of dispatch workers with deadline-aware
micro-batching:

  client threads                     dispatch workers (num_workers)
  --------------                     ---------------------------------
  submit(q) ──> admission queue ──>  each worker waits until: batch full
  (returns a PendingResult;             OR oldest request aged max_delay
   overload: shed / degrade             OR a deadline is about to miss
   per the admission policy)         pop <= max_batch requests
                                     [searcher.refresh(): pick up live
                                      appends via the versioned manifest]
                                     per-worker handle: submit x batch;
                                     flush -> ONE batched search
                                     resolve PendingResults + stats

Each worker owns a private batched-admission handle over the SHARED
searcher and, on the card, a CUDA stream of its own: the default stream
is shared by every thread, so workers would serialize on it.  A worker
enters ``torch.cuda.stream(own)`` for its whole loop; the kernel wrappers
launch on the current stream, and a flush's harvest synchronizes that
stream only, so while worker A waits on its harvest, worker B's launches
are already queued.  The host work between launches (top-k merge,
``pad_result``, LSH candidate generation) holds the interpreter lock, so
workers overlap device time, not host time: ``ServerStats`` reports each
worker's busy share beside the achieved q/s.  Because a flush drains the
queue through the batched admission protocol (one scan / one candidate
union per flush), micro-batched results are **bit-identical** to calling
``search()`` directly on the same queries, whatever the worker count:
every query row of the exact scan and the LSH rerank is independent of
its co-batched rows.

Admission control (``admission=`` + ``max_queue`` / a deadline budget)
keeps the server inside its latency budget under overload:

  * ``"reject"``      -- an arriving request is shed immediately when
    the queue is full or its EWMA-projected wait exceeds the budget,
  * ``"shed-oldest"`` -- the arriving request is admitted and the
    OLDEST queued requests are shed until the projection fits,
  * ``"degrade-to-lsh"`` -- nothing is shed: over-budget requests are
    marked and their batches serve ``mode="lsh"`` instead of the exact
    scan.  Batches never mix degraded and exact requests.

A shed request's ``result()`` raises ``RequestShed``; every handle
surfaces what happened via ``PendingResult.outcome`` (``"served"`` /
``"shed"`` / ``"degraded"`` / ``"partial"`` / ``"error"``).  With
``on_shard_failure="partial"`` a shard failure past its client's
retry/breaker budget degrades the affected flushes to the surviving
shards (``"partial"``, with ``coverage`` / ``failed_shards``).  Dispatch
workers are crash-proof: an exception that escapes a flush fails only
the requests that worker held, bumps ``worker_restarts`` and the loop
keeps draining with a fresh handle -- a crashed worker never silently
serves another path.

Live index updates: with ``refresh=True`` one worker per flush wave
re-reads the versioned manifest (a non-blocking try-lock keeps redundant
refreshes off the hot path) and swaps in grown/spilled shards between
batches, so every flush serves one consistent corpus snapshot.

``ZipfianTraffic`` is the synthetic load model (Zipf-popular query ids,
Poisson arrivals) behind ``repro_torch.launch.serve --index --serve``;
its draws equal the reference's for a seed.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.index.query import BatchedAdmission
from repro_torch.obs.metrics import Sample, get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.roofline.search import exact_scan_cost, roofline_gap
from repro_torch.sharding.rules import data_axis_devices


def _percentile(samples, q: float) -> float:
    if not samples:
        return float("nan")
    return float(np.percentile(np.asarray(samples, np.float64), q))


class RequestShed(RuntimeError):
    """The admission policy dropped this request under overload."""


class PendingResult:
    """Handle for one admitted request; resolved by a dispatch worker.

    ``outcome`` is ``"pending"`` until resolution, then ``"served"``,
    ``"shed"`` (the admission policy dropped it -- ``result()`` raises
    ``RequestShed``), ``"degraded"`` (served, but through the cheaper
    LSH path under the ``degrade-to-lsh`` overload policy),
    ``"partial"`` (served from the surviving shards only under
    ``on_shard_failure="partial"`` -- the result row carries
    ``coverage`` / ``failed_shards``), or ``"error"`` (the flush, or
    the worker around it, raised -- ``result()`` re-raises).
    """

    __slots__ = ("t_submit", "deadline", "query", "query_size",
                 "_event", "_result", "_error", "queue_wait_s", "latency_s",
                 "outcome", "degrade", "t_admit", "trace")

    def __init__(self, query, query_size, deadline: Optional[float]):
        self.query = query
        self.query_size = query_size
        self.t_submit = time.perf_counter()
        self.deadline = deadline          # absolute perf-counter time, or None
        self.queue_wait_s: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.outcome = "pending"
        self.degrade = False              # admission marked: serve via LSH
        self.t_admit = self.t_submit      # end of admission (set if traced)
        self.trace = None                 # per-request root Span, or None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; returns the per-request ``SearchResult``
        (one row) or re-raises the batch's failure (``RequestShed`` when
        the admission policy dropped this request)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result, error: Optional[BaseException],
                 outcome: str = "served") -> None:
        self._result = result
        self._error = error
        self.outcome = outcome
        self.latency_s = time.perf_counter() - self.t_submit
        self._event.set()


@dataclasses.dataclass
class ServerStats:
    """Serving counters; bounded reservoirs feed the percentile snapshot.

    ``queue_wait_s`` is admission -> batch pop, ``flush_s`` is one
    batch's dispatch+harvest wall clock, ``latency_s`` is admission ->
    result resolution (what a client observes).  ``worker_flushes`` /
    ``worker_busy_s`` split the flush histogram per dispatch worker;
    occupancy (busy / wall time) lands in ``snapshot()``.

    Every mutation happens under ``lock`` (the dispatch workers and the
    admission path share these fields), and ``snapshot()`` copies the
    reservoirs under the same lock before computing percentiles -- a
    concurrent submit storm can never hand ``np.percentile`` a deque
    that mutates mid-read.
    """

    requests: int = 0
    batches: int = 0
    errors: int = 0
    deadline_misses: int = 0
    shed: int = 0                 # requests dropped by the admission policy
    degraded: int = 0             # requests served via degrade-to-lsh
    partial: int = 0              # requests served with coverage < 1
    worker_restarts: int = 0      # dispatch loops revived after a crash
    refreshes: int = 0            # manifest refreshes that changed state
    flush_full: int = 0           # trigger: queue reached max_batch
    flush_aged: int = 0           # trigger: oldest request aged max_delay
    flush_deadline: int = 0       # trigger: a deadline was about to miss
    flush_drain: int = 0          # trigger: server stopping
    workers: int = 1
    window: int = 65536
    t_start: Optional[float] = None    # set by SearchServer.start()
    queue_wait_s: Deque[float] = dataclasses.field(default=None)  # type: ignore[assignment]
    flush_s: Deque[float] = dataclasses.field(default=None)       # type: ignore[assignment]
    latency_s: Deque[float] = dataclasses.field(default=None)     # type: ignore[assignment]
    batch_sizes: Deque[int] = dataclasses.field(default=None)     # type: ignore[assignment]
    coverage: Deque[float] = dataclasses.field(default=None)      # type: ignore[assignment]
    worker_flushes: List[int] = dataclasses.field(default=None)   # type: ignore[assignment]
    worker_busy_s: List[float] = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        for name in ("queue_wait_s", "flush_s", "latency_s", "batch_sizes",
                     "coverage"):
            if getattr(self, name) is None:
                setattr(self, name, collections.deque(maxlen=self.window))
        if self.worker_flushes is None:
            self.worker_flushes = [0] * self.workers
        if self.worker_busy_s is None:
            self.worker_busy_s = [0.0] * self.workers
        self.lock = threading.Lock()

    def snapshot(self) -> Dict[str, object]:
        """One consistent dict of counters + p50/p99s (ms) + per-worker
        occupancy, copied under the lock (no torn reads)."""
        with self.lock:
            out = {"requests": self.requests, "batches": self.batches,
                   "errors": self.errors,
                   "deadline_misses": self.deadline_misses,
                   "shed": self.shed, "degraded": self.degraded,
                   "partial": self.partial,
                   "worker_restarts": self.worker_restarts,
                   "refreshes": self.refreshes,
                   "flush_full": self.flush_full,
                   "flush_aged": self.flush_aged,
                   "flush_deadline": self.flush_deadline,
                   "flush_drain": self.flush_drain,
                   "workers": self.workers}
            batch_sizes = list(self.batch_sizes)
            coverage = list(self.coverage)
            samples = {"queue_wait": list(self.queue_wait_s),
                       "flush": list(self.flush_s),
                       "latency": list(self.latency_s)}
            flushes = list(self.worker_flushes)
            busy = list(self.worker_busy_s)
            t_start = self.t_start
        out["mean_batch"] = (float(np.mean(batch_sizes)) if batch_sizes
                             else float("nan"))
        admitted = out["requests"] + out["shed"]
        out["shed_rate"] = out["shed"] / max(admitted, 1)
        out["degraded_rate"] = out["degraded"] / max(out["requests"], 1)
        out["partial_rate"] = out["partial"] / max(out["requests"], 1)
        out["mean_coverage"] = (float(np.mean(coverage)) if coverage
                                else float("nan"))
        out["deadline_miss_rate"] = (out["deadline_misses"]
                                     / max(out["requests"], 1))
        for name, vals in samples.items():
            out[f"{name}_p50_ms"] = _percentile(vals, 50) * 1e3
            out[f"{name}_p99_ms"] = _percentile(vals, 99) * 1e3
        out["worker_flushes"] = flushes
        elapsed = (time.perf_counter() - t_start) if t_start else None
        out["worker_occupancy"] = [
            (b / elapsed if elapsed and elapsed > 0 else float("nan"))
            for b in busy]
        return out


def _summary_samples(name: str, help: str, vals: List[float],
                     labels: Tuple = ()):
    """Reservoir -> Prometheus summary samples (windowed, like the
    ``ServerStats`` percentile snapshot: count/sum cover the retained
    window, not all time)."""
    vals = sorted(vals)
    for q in (0.5, 0.99):
        v = (vals[min(len(vals) - 1, int(q * len(vals)))] if vals
             else float("nan"))
        yield Sample(name, "summary", help,
                     labels + (("quantile", f"{q:g}"),), float(v))
    yield Sample(name, "summary", help, labels, float(sum(vals)),
                 suffix="_sum")
    yield Sample(name, "summary", help, labels, float(len(vals)),
                 suffix="_count")


def _server_samples(server: "SearchServer"):
    """Registry collector over one live ``SearchServer`` (weakref'd by
    ``MetricsRegistry.register_object``): ``ServerStats`` counters, the
    live queue depth, per-worker flushes/busy-time/occupancy, and the
    latency reservoirs as windowed summaries.  Several live servers
    sharing a registry sum their counters (one process-wide total)."""
    st = server.stats
    with st.lock:
        counters = {
            "serve_requests_total": (st.requests, "requests served"),
            "serve_shed_total": (st.shed,
                                 "requests dropped by admission control"),
            "serve_degraded_total": (st.degraded,
                                     "requests served via degrade-to-lsh"),
            "serve_partial_total": (st.partial,
                                    "requests served from surviving shards "
                                    "only (coverage < 1)"),
            "serve_worker_restarts_total": (st.worker_restarts,
                                            "dispatch loops revived after "
                                            "an unexpected crash"),
            "serve_errors_total": (st.errors, "failed flushes/submits"),
            "serve_deadline_misses_total": (st.deadline_misses,
                                            "results landed past deadline"),
            "serve_refreshes_total": (st.refreshes,
                                      "manifest refreshes that moved state"),
            "serve_batches_total": (st.batches, "micro-batches flushed"),
        }
        triggers = {"full": st.flush_full, "aged": st.flush_aged,
                    "deadline": st.flush_deadline, "drain": st.flush_drain}
        flushes = list(st.worker_flushes)
        busy = list(st.worker_busy_s)
        t_start = st.t_start
        reservoirs = {
            "serve_queue_wait_seconds": ("admission -> batch pop",
                                         list(st.queue_wait_s)),
            "serve_flush_seconds": ("one batch dispatch+harvest",
                                    list(st.flush_s)),
            "serve_latency_seconds": ("admission -> resolution",
                                      list(st.latency_s)),
            "serve_batch_size": ("requests per flushed batch",
                                 [float(v) for v in st.batch_sizes]),
            "serve_coverage": ("fraction of corpus docs searched per "
                               "flush (1.0 = full coverage)",
                               list(st.coverage)),
        }
    for name, (v, help) in counters.items():
        yield Sample(name, "counter", help, (), float(v))
    for trig, v in triggers.items():
        yield Sample("serve_flushes_total", "counter",
                     "flushes by trigger", (("trigger", trig),), float(v))
    yield Sample("serve_queue_depth", "gauge",
                 "requests waiting in the admission queue", (),
                 float(len(server._queue)))
    yield Sample("serve_workers", "gauge", "dispatch workers", (),
                 float(st.workers))
    elapsed = (time.perf_counter() - t_start) if t_start else None
    for i in range(len(flushes)):
        lbl = (("worker", str(i)),)
        yield Sample("serve_worker_flushes_total", "counter",
                     "flushes per dispatch worker", lbl, float(flushes[i]))
        yield Sample("serve_worker_busy_seconds_total", "counter",
                     "flush wall-clock per dispatch worker", lbl,
                     float(busy[i]))
        occ = busy[i] / elapsed if elapsed and elapsed > 0 else float("nan")
        yield Sample("serve_worker_occupancy", "gauge",
                     "busy time / wall time per dispatch worker", lbl, occ)
    for name, (help, vals) in reservoirs.items():
        yield from _summary_samples(name, help, vals)


class _WorkerHandle(BatchedAdmission):
    """One dispatch worker's private batched-admission state over the
    SHARED searcher.

    ``submit`` validates/queues rows against the shared wire spec;
    ``flush`` runs the worker's batch as ONE ``searcher.search`` call --
    the underlying searcher snapshots its state per search, so
    concurrent flushes from different workers are safe and bit-identical
    to direct calls, while each worker's pending queue stays private
    (the shared searcher's own submit/flush state is never raced).
    """

    def __init__(self, searcher, on_shard_failure: Optional[str] = None):
        self._searcher = searcher
        self._on_shard_failure = on_shard_failure
        self._admission_init()

    @property
    def spec(self):
        return self._searcher.spec

    @property
    def device(self):
        return self._searcher.device

    def search(self, queries, topk: int = 10, *, mode: str = "exact",
               query_sizes=None):
        kwargs = {}
        if self._on_shard_failure is not None:
            # only a sharded router understands the policy; a plain
            # IndexSearcher server leaves it unset
            kwargs["on_shard_failure"] = self._on_shard_failure
        return self._searcher.search(queries, topk, mode=mode,
                                     query_sizes=query_sizes, **kwargs)


ADMISSION_POLICIES = ("none", "reject", "shed-oldest", "degrade-to-lsh")


class SearchServer:
    """Deadline-aware micro-batching front end over a searcher.

    ``searcher`` is anything with a ``search`` batch API, a wire
    ``spec`` and a ``device`` (``IndexSearcher`` or ``ShardedIndex``);
    ``num_workers`` dispatch workers drain the shared admission queue,
    each through its own private admission handle and, on the card, its
    own CUDA stream, so flushes overlap (default: one per position of the
    searcher's mesh, else 1).  A flush fires when the queue holds
    ``max_batch`` requests, when the oldest request has waited
    ``max_delay_s``, or when a request's deadline
    minus the estimated flush latency (EWMA of recent flushes) is about
    to pass.  ``refresh=True`` (default) calls ``searcher.refresh()``
    -- when it has one -- before each flush wave (one worker at a time,
    via a try-lock), so a served ``ShardedIndex`` picks up concurrent
    appends batch by batch.

    Overload: ``admission`` picks the policy (see the module docstring),
    triggered when the queue holds ``max_queue`` requests or when the
    EWMA-projected queue wait exceeds the request's deadline budget
    (its ``deadline_s``, else ``deadline_budget_s``).
    """

    def __init__(self, searcher, *, max_batch: int = 64,
                 max_delay_s: float = 0.005, topk: int = 10,
                 mode: str = "exact", refresh: bool = True,
                 deadline_safety: float = 1.5,
                 num_workers: Optional[int] = None,
                 admission: str = "none",
                 max_queue: Optional[int] = None,
                 deadline_budget_s: Optional[float] = None,
                 on_shard_failure: Optional[str] = None,
                 registry=None, tracer=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if mode not in ("exact", "lsh"):
            raise ValueError(f"mode must be 'exact' or 'lsh', got {mode!r}")
        if on_shard_failure not in (None, "fail", "partial"):
            raise ValueError(f"on_shard_failure must be None, 'fail' or "
                             f"'partial', got {on_shard_failure!r}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        if admission == "degrade-to-lsh" and mode != "exact":
            raise ValueError("admission='degrade-to-lsh' needs mode='exact' "
                             "(there is nothing cheaper to degrade to)")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if num_workers is None:
            num_workers = self._default_workers(searcher)
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.searcher = searcher
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.topk = topk
        self.mode = mode
        self.refresh = refresh and hasattr(searcher, "refresh")
        self.deadline_safety = deadline_safety
        self.num_workers = num_workers
        self.admission = admission
        self.max_queue = max_queue
        self.deadline_budget_s = deadline_budget_s
        self.on_shard_failure = on_shard_failure
        self.stats = ServerStats(workers=num_workers)
        # observability: this server's counters/reservoirs export through
        # the (default: process-wide) registry -- a weakref collector, so
        # registration never outlives the server -- and per-request span
        # trees go to the tracer (disabled by default: off the hot path).
        # Tests needing totals in isolation pass private instances.
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry.register_object(self, _server_samples)
        # live roofline gauges, updated per exact flush: the autotuning
        # signal (predicted-vs-measured flush bytes/time) at serve time
        g = self.registry.gauge
        self._g_roofline = {
            "bytes": g("serve_roofline_predicted_bytes",
                       "exact_scan_cost HBM bytes for the last flush"),
            "predicted_s": g("serve_roofline_predicted_seconds",
                             "memory-bound time prediction, last flush"),
            "measured_s": g("serve_roofline_measured_seconds",
                            "measured wall clock of the last exact flush"),
            "gap": g("serve_roofline_gap",
                     "measured / predicted flush time (1.0 = at roofline)"),
            "gbps": g("serve_roofline_achieved_gbps",
                      "effective streaming bandwidth of the last flush"),
        }
        self._queue: Deque[PendingResult] = collections.deque()
        self._cond = threading.Condition()
        self._refresh_lock = threading.Lock()
        self._stopping = False
        self._threads: List[threading.Thread] = []
        self._handles: List[_WorkerHandle] = []
        self._est_flush_s = max(max_delay_s, 1e-3)   # EWMA, pre-warm guess

    @staticmethod
    def _default_workers(searcher) -> int:
        """One worker per position on the searcher's mesh ``"data"`` axis
        (overlapping flushes keep every position busy), else 1."""
        mesh = getattr(searcher, "mesh", None)
        if mesh is None:
            return 1
        return max(1, len(data_axis_devices(mesh)))

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SearchServer":
        if self._threads:
            raise RuntimeError("server already started")
        self._stopping = False
        self.stats.t_start = time.perf_counter()
        self._handles = [_WorkerHandle(self.searcher, self.on_shard_failure)
                         for _ in range(self.num_workers)]
        self._threads = [
            threading.Thread(target=self._dispatch_loop, args=(i,),
                             daemon=True, name=f"search-dispatch-{i}")
            for i in range(self.num_workers)]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Drain the queue (remaining requests are flushed) and join."""
        if not self._threads:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        self._handles = []

    def __enter__(self) -> "SearchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission (any thread) -----------------------------------------
    def submit(self, query, *, query_size: Optional[int] = None,
               deadline_s: Optional[float] = None) -> PendingResult:
        """Admit one query row; returns immediately with a handle.

        ``deadline_s`` is relative (seconds from now): the dispatchers
        try to flush early enough that the result lands before it, and
        the admission policy (when one is set) uses it as the overload
        budget.  Under overload the returned handle may already be
        resolved as shed (``result()`` raises ``RequestShed``) or marked
        for LSH degradation -- check ``PendingResult.outcome``.
        """
        if not self._threads:
            raise RuntimeError("server not started (use `with server:` "
                               "or call start())")
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        req = PendingResult(query, query_size, deadline)
        with self._cond:
            if self._stopping:
                raise RuntimeError("server is stopping")
            budget = (deadline_s if deadline_s is not None
                      else self.deadline_budget_s)
            if self.admission == "none":
                self._queue.append(req)
            else:
                self._admit(req, budget)
            self._cond.notify_all()
        tracer = self.tracer
        if tracer.enabled:
            # root async span: [t_submit, resolution]; "admission" is its
            # first child, so the per-request children partition the
            # request's recorded end-to-end latency exactly
            root = tracer.start_span("request", t0=req.t_submit,
                                     kind="async",
                                     args={"deadline_s": deadline_s})
            root.trace_id = root.span_id
            req.trace = root
            req.t_admit = time.perf_counter()
            tracer.add_span("admission", req.t_submit, req.t_admit,
                            parent=root, kind="async",
                            args={"policy": self.admission,
                                  "degrade": req.degrade})
            if req.outcome == "shed":      # rejected on arrival
                tracer.end_span(root, t1=req.t_admit,
                                args={"outcome": "shed"})
                req.trace = None
        return req

    def _projected_wait_s(self, depth: int) -> float:
        """EWMA-projected queue wait for a request behind ``depth``
        others: full batches ahead of it, divided over the workers."""
        batches = (depth + self.max_batch) // self.max_batch
        return batches * self._est_flush_s / self.num_workers

    def _overloaded(self, depth: int, budget: Optional[float]) -> bool:
        if self.max_queue is not None and depth >= self.max_queue:
            return True
        return (budget is not None
                and self._projected_wait_s(depth) > budget)

    def _shed(self, req: PendingResult, why: str) -> None:
        with self.stats.lock:
            self.stats.shed += 1
        req._resolve(None, RequestShed(why), outcome="shed")
        if req.trace is not None:          # shed-oldest: already traced
            self.tracer.end_span(req.trace,
                                 t1=req.t_submit + req.latency_s,
                                 args={"outcome": "shed"})
            req.trace = None

    def _admit(self, req: PendingResult, budget: Optional[float]) -> None:
        """Apply the admission policy (caller holds ``_cond``)."""
        depth = len(self._queue)
        if not self._overloaded(depth, budget):
            self._queue.append(req)
            return
        if self.admission == "reject":
            self._shed(req, f"admission rejected: queue depth {depth}, "
                            f"projected wait "
                            f"{self._projected_wait_s(depth) * 1e3:.1f}ms "
                            f"over budget")
            return
        if self.admission == "shed-oldest":
            self._queue.append(req)
            while len(self._queue) > 1 and self._overloaded(
                    len(self._queue) - 1, budget):
                self._shed(self._queue.popleft(),
                           "admission overload: shed oldest queued request")
            return
        # degrade-to-lsh: admit, but the batch serves the cheap path
        req.degrade = True
        self._queue.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def generation(self) -> Optional[int]:
        """Manifest generation the served searcher is on (None when the
        searcher has no notion of one, e.g. a single ``IndexSearcher``)
        -- lets operators confirm a live append/spill was picked up."""
        return getattr(self.searcher, "generation", None)

    # -- dispatch (the worker pool) --------------------------------------
    def _next_due(self, now: float) -> float:
        """Earliest time the current queue must flush."""
        oldest = self._queue[0]
        due = oldest.t_submit + self.max_delay_s
        margin = self._est_flush_s * self.deadline_safety
        for r in self._queue:
            if r.deadline is not None:
                due = min(due, r.deadline - margin)
        return due

    def _take_batch(self):
        """Wait for a flush trigger, pop one batch (caller holds
        ``_cond``).  Returns ``(None, "")`` when stopping and drained.
        Batches never mix degraded and non-degraded requests (the
        degrade-to-lsh policy switches the whole batch's mode)."""
        while True:
            if not self._queue:
                if self._stopping:
                    return None, ""
                self._cond.wait()
                continue
            if self._stopping:
                trigger = "drain"
                break
            now = time.perf_counter()
            if len(self._queue) >= self.max_batch:
                trigger = "full"
                break
            due = self._next_due(now)
            if now >= due:
                oldest_due = self._queue[0].t_submit + self.max_delay_s
                trigger = "aged" if due >= oldest_due else "deadline"
                break
            self._cond.wait(timeout=due - now)
        flag = self._queue[0].degrade
        batch: List[PendingResult] = []
        while (self._queue and len(batch) < self.max_batch
               and self._queue[0].degrade == flag):
            batch.append(self._queue.popleft())
        if self._queue:
            self._cond.notify_all()       # leftover work for other workers
        return batch, trigger

    def _dispatch_loop(self, wi: int) -> None:
        dev = self.searcher.device
        if dev.type != "cuda":
            return self._drain(wi)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            return self._drain(wi)

    def _drain(self, wi: int) -> None:
        handle = self._handles[wi]
        while True:
            batch = None
            try:
                with self._cond:
                    batch, trigger = self._take_batch()
                if batch is None:
                    return
                if batch:
                    self._flush_batch(batch, trigger, wi, handle)
            except Exception as e:
                # _flush_batch already contains the expected failure
                # domains (bad query -> per request, flush error -> per
                # batch); anything that still escapes must not silently
                # kill the worker with requests queued behind it.  Fail
                # whatever this worker was holding, swap in a fresh
                # handle (the crashed one may hold torn admission
                # state), and keep draining.
                stats = self.stats
                with stats.lock:
                    stats.worker_restarts += 1
                    stats.errors += 1
                for r in (batch or ()):
                    if r.done():
                        continue
                    r._resolve(None, e, outcome="error")
                    if r.trace is not None:
                        self.tracer.end_span(r.trace,
                                             t1=r.t_submit + r.latency_s,
                                             args={"outcome": "error"})
                        r.trace = None
                handle = _WorkerHandle(self.searcher, self.on_shard_failure)
                self._handles[wi] = handle

    def _flush_batch(self, batch: List[PendingResult], trigger: str,
                     wi: int, handle: _WorkerHandle) -> None:
        t0 = time.perf_counter()
        stats = self.stats
        tracer = self.tracer
        degraded = bool(batch[0].degrade and self.mode == "exact")
        mode = "lsh" if degraded else self.mode
        outcome = "degraded" if degraded else "served"
        with stats.lock:
            setattr(stats, f"flush_{trigger}",
                    getattr(stats, f"flush_{trigger}") + 1)
        if tracer.enabled:
            tracer.take_phases()         # drop a prior flush's stale notes
        wf = tracer.start_span("worker_flush", t0=t0,
                               args={"worker": wi, "trigger": trigger,
                                     "mode": mode, "batch": len(batch)})
        if self.refresh and self._refresh_lock.acquire(blocking=False):
            # one worker refreshes per flush wave; the rest serve the
            # snapshot they'd have gotten anyway (keep serving on a
            # failed refresh, too)
            try:
                try:
                    with tracer.span("refresh", parent=wf):
                        if self.searcher.refresh():
                            with stats.lock:
                                stats.refreshes += 1
                except Exception:
                    with stats.lock:
                        stats.errors += 1
            finally:
                self._refresh_lock.release()
        tickets: Dict[int, PendingResult] = {}
        for r in batch:
            r.queue_wait_s = t0 - r.t_submit
            with stats.lock:
                stats.queue_wait_s.append(r.queue_wait_s)
            if r.trace is not None:
                tracer.add_span("queue", r.t_admit, t0, parent=r.trace,
                                kind="async", args={"worker": wi})
            try:
                tickets[handle.submit(
                    r.query, query_size=r.query_size)] = r
            except Exception as e:       # a malformed query fails only itself
                with stats.lock:
                    stats.errors += 1
                r._resolve(None, e)
                if r.trace is not None:
                    tracer.end_span(r.trace,
                                    t1=r.t_submit + r.latency_s,
                                    args={"outcome": "error"})
                    r.trace = None
        error: Optional[BaseException] = None
        out: Dict[int, object] = {}
        if tickets:
            try:
                with tracer.device_annotation(f"flush:w{wi}"):
                    out = handle.flush(self.topk, mode=mode)
            except Exception as e:
                error = e
                with stats.lock:
                    stats.errors += 1
        # batch-level phases the searcher noted on THIS thread (shard
        # dispatch, top-k merge, ...): replayed below as children of every
        # co-batched request's span tree
        phases = tracer.take_phases() if tracer.enabled else []
        dt = time.perf_counter() - t0
        tracer.end_span(wf, t1=t0 + dt)
        now = time.perf_counter()
        # on_shard_failure="partial": the searcher annotated every row of
        # this flush with the same coverage; < 1 means shards dropped out
        cov = 1.0
        if tickets and error is None:
            first = next(iter(out.values()), None)
            cov = float(getattr(first, "coverage", 1.0))
        with stats.lock:
            self._est_flush_s = 0.7 * self._est_flush_s + 0.3 * dt
            stats.batches += 1
            stats.flush_s.append(dt)
            stats.batch_sizes.append(len(batch))
            stats.worker_flushes[wi] += 1
            stats.worker_busy_s[wi] += dt
            if degraded:
                stats.degraded += len(tickets)
            if tickets and error is None:
                stats.coverage.append(cov)
                if cov < 1.0:
                    stats.partial += len(tickets)
        if cov < 1.0:
            outcome = "partial"
        if (tickets and not degraded and mode == "exact" and error is None
                and cov == 1.0):   # a partial flush scanned fewer bytes
            self._update_roofline(len(tickets), dt)
        for ticket, r in tickets.items():
            r._resolve(out.get(ticket), error, outcome=outcome)
            with stats.lock:
                stats.requests += 1
                stats.latency_s.append(r.latency_s)
                if r.deadline is not None and now > r.deadline:
                    stats.deadline_misses += 1
            if r.trace is not None:
                t_res = r.t_submit + r.latency_s
                fl = tracer.start_span("flush", parent=r.trace, t0=t0,
                                       kind="async",
                                       args={"worker": wi,
                                             "trigger": trigger,
                                             "mode": mode})
                for name, p0, p1 in phases:
                    tracer.add_span(name, p0, p1, parent=fl, kind="async")
                tracer.end_span(fl, t1=t_res)
                tracer.end_span(r.trace, t1=t_res,
                                args={"outcome": r.outcome})
                r.trace = None

    def _update_roofline(self, n_queries: int, flush_s: float) -> None:
        """Refresh the live roofline gauges from one measured exact flush
        (``repro_torch.roofline.search``, at the H100's HBM bandwidth):
        predicted bytes for this corpus + batch, the memory-bound time
        prediction, and the gap."""
        try:
            n = getattr(self.searcher, "n", None)
            if n is None:
                n = self.searcher.index.n
            cost = exact_scan_cost(int(n), int(self.searcher.spec.words),
                                   n_queries, topk=self.topk)
            gap = roofline_gap(cost["bytes"], flush_s)
        except (AttributeError, ValueError):
            return                       # searcher without n/words, dt=0
        g = self._g_roofline
        g["bytes"].set(cost["bytes"])
        g["predicted_s"].set(gap["predicted_s"])
        g["measured_s"].set(flush_s)
        g["gap"].set(gap["gap"])
        g["gbps"].set(gap["achieved_gbps"])


# ---------------------------------------------------------------------------
# Synthetic traffic: Zipf-popular queries, Poisson arrivals
# ---------------------------------------------------------------------------

class ZipfianTraffic:
    """Synthetic serving load over an ``n_docs`` corpus.

    Query popularity follows a Zipf law with exponent ``alpha`` over a
    random permutation of the doc ids (so popular docs are scattered,
    not clustered at low ids); arrivals are a Poisson process at
    ``rate_qps``.  Deterministic per seed -- and independent of the
    serving side entirely (worker counts, admission policies), so load
    replays compare servers on identical traffic.
    """

    def __init__(self, n_docs: int, *, alpha: float = 1.1, seed: int = 0):
        if n_docs < 1:
            raise ValueError(f"n_docs must be >= 1, got {n_docs}")
        self.n_docs = n_docs
        self.alpha = alpha
        self._rng = np.random.default_rng(seed)
        weights = 1.0 / np.arange(1, n_docs + 1, dtype=np.float64) ** alpha
        self._probs = weights / weights.sum()
        self._perm = self._rng.permutation(n_docs)

    def ids(self, m: int) -> np.ndarray:
        """``m`` query doc ids, Zipf-popular."""
        ranks = self._rng.choice(self.n_docs, size=m, p=self._probs)
        return self._perm[ranks]

    def arrival_offsets(self, m: int, rate_qps: float) -> np.ndarray:
        """``m`` monotone arrival times (seconds from start) at the
        offered load ``rate_qps``."""
        if rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        gaps = self._rng.exponential(1.0 / rate_qps, size=m)
        return np.cumsum(gaps)
