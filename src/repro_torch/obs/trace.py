"""Lightweight span tracing for the serving request path and the
signature engine (the port's copy of ``repro.obs.trace``; the same
spans, tree and trace-event JSON).

Answers "where did this request's 40 ms go": every admitted request
grows a span tree -- admission -> queue wait -> worker flush -> the
shard dispatch -> harvest -> ``merge_topk`` -> resolution -- and the
whole buffer exports as Chrome trace-event JSON, loadable directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Design constraints, in order:

  1. **Off the hot path when disabled.**  The tracer ships disabled;
     every entry point checks ``enabled`` first and returns a shared
     no-op span, so an untraced server pays one attribute read per
     would-be span.
  2. **Tear-free under concurrent workers.**  Span ids come from one
     atomic counter; parent linkage is explicit (``parent=``) or via a
     *thread-local* span stack (``span()`` context manager), so two
     dispatch workers flushing concurrently can never adopt each
     other's children.  Completed spans append to the bounded buffer
     under one lock.
  3. **Cross-thread request trees.**  A request's root span opens on
     the client thread and closes on whichever worker resolved it;
     retroactive children (queue wait is only known at batch pop) are
     recorded with explicit ``t0``/``t1`` via ``add_span``.

**One clock.**  Every time is ``time.perf_counter()`` seconds (``CLOCK``),
the clock a benchmark or a profiling script reads around its own calls,
so a span here lines up with theirs without a conversion; it is
monotonic, and callers that pass ``t0`` / ``t1`` take them from it too.
On Linux ``time.monotonic`` reads the same ``CLOCK_MONOTONIC``, but not
on every platform.  The export states the clock and the epoch its
microseconds count from (``otherData``).

**Program spans.**  ``recording()`` is true while the tracer is enabled
and also while a ``torch.profiler`` runs on this thread; a caller that
asks it once per call then opens ``program_span`` spans, which record
whatever ``enabled`` says.  ``SignatureEngine`` records this way, so a
profiled run gets its spans with no switch turned.  They go to this
buffer only: they enter the profiler as ranges only under
``device_annotations=True`` (a range that encloses kernels also shows on
the device's timeline, as an activity that launched nothing).

Export: spans marked ``kind="async"`` (the per-request tree) become
``ph: "b"``/``"e"`` async event pairs keyed on the request's trace id
-- Perfetto renders each request as its own nested async track --
while worker-side spans become ``ph: "X"`` complete events on their
thread's track.  Every event carries ``span_id`` / ``parent_id`` /
``trace_id`` in ``args``, so the tree is machine-checkable
independent of the rendering.

``device_annotation()`` optionally brackets a region with
``torch.profiler.record_function`` -- and, where CUDA is present, an
NVTX range (``torch.cuda.nvtx``) -- so server flushes line up with the
kernels inside a captured ``torch.profiler`` trace; it is a no-op unless
``device_annotations=True``, and on CPU-only torch it records the
profiler range alone.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

CLOCK = "perf_counter"
_now = time.perf_counter
_profiler_enabled = torch._C._autograd._profiler_enabled


class Span:
    """One interval: ``[t0, t1]`` perf-counter seconds + tree linkage."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "t0", "t1",
                 "tid", "args", "kind")

    def __init__(self, name: str, span_id: int, parent_id: int,
                 trace_id: int, t0: float, tid: int,
                 args: Optional[dict], kind: str):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.tid = tid
        self.args = args
        self.kind = kind          # "thread" (ph X) | "async" (ph b/e)


class _NullSpan(Span):
    """Shared no-op span handed out while tracing is disabled."""

    def __init__(self):
        super().__init__("", 0, 0, 0, 0.0, 0, None, "thread")


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded buffer of completed spans + the span-construction API."""

    def __init__(self, *, enabled: bool = False, max_events: int = 65536,
                 device_annotations: bool = False):
        self.enabled = enabled
        self.device_annotations = device_annotations
        self.max_events = max_events
        self._lock = threading.Lock()
        self._done: List[tuple] = []      # completed spans, in order
        self._n_events = 0                # the trace events they make
        self.dropped = 0              # spans lost to the buffer bound
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._epoch = _now()

    # -- span construction ----------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """Innermost context-manager span on THIS thread (or None)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   trace_id: Optional[int] = None,
                   args: Optional[dict] = None, t0: Optional[float] = None,
                   kind: str = "thread") -> Span:
        """Open a span NOT tied to this thread's stack (close it with
        ``end_span``; may happen on another thread)."""
        if not self.enabled:
            return _NULL_SPAN
        return self._open(name, parent, trace_id, args, t0, kind)

    def _open(self, name, parent, trace_id, args, t0, kind) -> Span:
        if parent is None:
            parent = self.current()
        pid = parent.span_id if parent is not None else 0
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else 0
        return Span(name, next(self._ids), pid, trace_id,
                    _now() if t0 is None else t0,
                    threading.get_ident(), args, kind)

    def end_span(self, span: Span, *, t1: Optional[float] = None,
                 args: Optional[dict] = None) -> None:
        if span is _NULL_SPAN or not isinstance(span, Span):
            return
        span.t1 = _now() if t1 is None else t1
        if args:
            span.args = {**(span.args or {}), **args}
        self._emit(span)

    @contextlib.contextmanager
    def span(self, name: str, *, args: Optional[dict] = None,
             parent: Optional[Span] = None,
             kind: str = "thread") -> Iterator[Span]:
        """Context-managed span, nested via this thread's span stack."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        sp = self.start_span(name, parent=parent, args=args, kind=kind)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            self.end_span(sp)

    def recording(self) -> bool:
        """Whether program spans record now: while the tracer is enabled
        or a ``torch.profiler`` runs on this thread (~0.1 us to ask)."""
        return self.enabled or _profiler_enabled()

    def program_span(self, name: str, *,
                     args: Optional[dict] = None) -> "_ProgramSpan":
        """A ``span()`` that records whatever ``enabled`` says, for a
        caller that asked ``recording()`` once for its whole call; a
        profiler range too under ``device_annotations``."""
        return _ProgramSpan(self, name, args)

    def add_span(self, name: str, t0: float, t1: float, *,
                 parent: Optional[Span] = None,
                 trace_id: Optional[int] = None,
                 args: Optional[dict] = None,
                 kind: str = "thread") -> None:
        """Record an already-elapsed interval (e.g. a request's queue
        wait, only known when its batch pops)."""
        if not self.enabled:
            return
        sp = self.start_span(name, parent=parent, trace_id=trace_id,
                             args=args, t0=t0, kind=kind)
        self.end_span(sp, t1=t1)

    @contextlib.contextmanager
    def phase(self, name: str, *, args: Optional[dict] = None
              ) -> Iterator[Span]:
        """A ``span()`` that ALSO notes its interval on this thread's
        phase list -- the channel through which batch-level phases
        (shard dispatch, top-k merge) deep inside the searcher reach the
        server, which replays them as children of every co-batched
        request's span tree.  Bounded per thread; ``take_phases``
        drains."""
        with self.span(name, args=args) as sp:
            yield sp
        if sp is not _NULL_SPAN and sp.t1 is not None:
            phases = getattr(self._tls, "phases", None)
            if phases is None:
                phases = self._tls.phases = []
            if len(phases) < 64:        # a flush records a handful; cap
                phases.append((name, sp.t0, sp.t1))

    def take_phases(self) -> List[Tuple[str, float, float]]:
        """Drain this thread's noted phase intervals (see ``phase``)."""
        phases = getattr(self._tls, "phases", None)
        self._tls.phases = []
        return phases or []

    @contextlib.contextmanager
    def device_annotation(self, name: str):
        """``torch.profiler.record_function`` bracket, plus an NVTX range
        when CUDA is present (opt-in no-op)."""
        if not (self.enabled and self.device_annotations):
            yield
            return
        with torch.profiler.record_function(name):
            if not torch.cuda.is_available():
                yield
                return
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()

    # -- the Chrome trace-event buffer ------------------------------------
    # A completed span is kept as one tuple, and turned into trace events
    # only when the buffer is read: recording costs a tuple and a lock.
    def _emit(self, span: Span) -> None:
        n = 2 if span.kind == "async" else 1
        rec = (span.name, span.span_id, span.parent_id, span.trace_id,
               span.t0, span.t1 if span.t1 is not None else span.t0,
               span.tid, span.args, span.kind)
        with self._lock:
            if self._n_events + n > self.max_events:
                self.dropped += 1
                return
            self._n_events += n
            self._done.append(rec)

    @staticmethod
    def _render(rec: tuple, pid: int, epoch: float) -> List[dict]:
        name, span_id, parent_id, trace_id, t0, t1, tid, sargs, kind = rec
        us = lambda t: round((t - epoch) * 1e6, 3)
        dur = max(0.0, t1 - t0)              # monotonic per span, clamped
        args = {"span_id": span_id, "parent_id": parent_id,
                "trace_id": trace_id, **(sargs or {})}
        base = {"name": name, "pid": pid, "tid": tid, "args": args}
        if kind == "async":
            return [
                {**base, "ph": "b", "cat": "request", "id": trace_id,
                 "ts": us(t0)},
                {**base, "ph": "e", "cat": "request", "id": trace_id,
                 "ts": us(t0 + dur)},
            ]
        return [{**base, "ph": "X", "cat": "serve", "ts": us(t0),
                 "dur": round(dur * 1e6, 3)}]

    def _read(self):
        with self._lock:
            done, epoch = list(self._done), self._epoch
        pid = os.getpid()
        return [ev for rec in done for ev in self._render(rec, pid, epoch)], \
            epoch

    def to_json(self) -> dict:
        """The buffered events as a Chrome trace-event document; its
        ``otherData`` names the clock and the epoch (seconds on it) that
        every ``ts`` counts microseconds from."""
        events, epoch = self._read()
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": CLOCK, "epoch_s": epoch}}

    def export(self, path: str) -> int:
        """Write the buffer as trace-event JSON; returns event count."""
        doc = self.to_json()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def events(self) -> List[dict]:
        return self._read()[0]

    def reset(self, *, enabled: Optional[bool] = None) -> None:
        with self._lock:
            self._done = []
            self._n_events = 0
            self.dropped = 0
            self._epoch = _now()
        if enabled is not None:
            self.enabled = enabled


class _ProgramSpan:
    """``Tracer.program_span``'s context manager (a class: a generator
    context manager costs more than the span it times)."""

    __slots__ = ("tracer", "name", "args", "span", "range")

    def __init__(self, tracer: Tracer, name: str, args: Optional[dict]):
        self.tracer, self.name, self.args = tracer, name, args
        self.range = None

    def __enter__(self) -> Span:
        tr = self.tracer
        self.span = tr._open(self.name, None, None, self.args, None,
                             "thread")
        tr._stack().append(self.span)
        if tr.device_annotations:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self.span

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer.end_span(self.span)


def request_tree(events: List[dict]) -> Dict[int, List[dict]]:
    """Group events by ``args.trace_id`` (0 = untraced/batch-level) --
    the per-request span-tree view the tests and the validator check."""
    out: Dict[int, List[dict]] = {}
    for ev in events:
        tid = int((ev.get("args") or {}).get("trace_id", 0))
        out.setdefault(tid, []).append(ev)
    return out


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide default tracer (disabled until something --
    ``--trace-out``, a test, an exporter -- enables it)."""
    return _default_tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _default_tracer
    prev, _default_tracer = _default_tracer, tracer
    return prev
