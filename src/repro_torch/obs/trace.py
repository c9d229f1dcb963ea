"""Lightweight span tracing for the serving request path (the port's
copy of ``repro.obs.trace``; the same spans, tree and trace-event JSON).

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
     other's children.  Per-span clocks are monotonic
     (``time.monotonic``), and completed spans append to the bounded
     buffer under one lock.
  3. **Cross-thread request trees.**  A request's root span opens on
     the client thread and closes on whichever worker resolved it;
     retroactive children (queue wait is only known at batch pop) are
     recorded with explicit ``t0``/``t1`` via ``add_span``.

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


class Span:
    """One interval: ``[t0, t1]`` monotonic seconds + tree linkage."""

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
        self._events: List[dict] = []
        self.dropped = 0              # spans lost to the buffer bound
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._epoch = time.monotonic()

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
        if parent is None:
            parent = self.current()
        pid = parent.span_id if parent is not None else 0
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else 0
        return Span(name, next(self._ids), pid, trace_id,
                    time.monotonic() if t0 is None else t0,
                    threading.get_ident(), args, kind)

    def end_span(self, span: Span, *, t1: Optional[float] = None,
                 args: Optional[dict] = None) -> None:
        if span is _NULL_SPAN or not isinstance(span, Span):
            return
        span.t1 = time.monotonic() if t1 is None else t1
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
        import torch
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
    def _us(self, t: float) -> float:
        return round((t - self._epoch) * 1e6, 3)

    def _emit(self, span: Span) -> None:
        t1 = span.t1 if span.t1 is not None else span.t0
        dur = max(0.0, t1 - span.t0)         # monotonic per span, clamped
        args = {"span_id": span.span_id, "parent_id": span.parent_id,
                "trace_id": span.trace_id, **(span.args or {})}
        base = {"name": span.name, "pid": os.getpid(), "tid": span.tid,
                "args": args}
        if span.kind == "async":
            events = [
                {**base, "ph": "b", "cat": "request",
                 "id": span.trace_id, "ts": self._us(span.t0)},
                {**base, "ph": "e", "cat": "request",
                 "id": span.trace_id, "ts": self._us(span.t0 + dur)},
            ]
        else:
            events = [{**base, "ph": "X", "cat": "serve",
                       "ts": self._us(span.t0),
                       "dur": round(dur * 1e6, 3)}]
        with self._lock:
            room = self.max_events - len(self._events)
            if room < len(events):
                self.dropped += 1
                return
            self._events.extend(events)

    def to_json(self) -> dict:
        """The buffered events as a Chrome trace-event document."""
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the buffer as trace-event JSON; returns event count."""
        doc = self.to_json()
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def reset(self, *, enabled: Optional[bool] = None) -> None:
        with self._lock:
            self._events = []
            self.dropped = 0
            self._epoch = time.monotonic()
        if enabled is not None:
            self.enabled = enabled


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
