"""Resilient shard dispatch: deadlines, retries, hedging, breakers (port
of ``repro.index.resilience``; plain Python, and the same seed and
schedule give the same failure draws as the reference).

``ResilientShardClient`` wraps any ``ShardClient`` (local, socket, or
chaos-injected) and makes its ``dispatch`` survive a faulty transport:

  * **deadline** -- each attempt runs in its own thread and the
    harvest waits at most ``policy.deadline_s`` past the attempt's
    launch; a blown deadline abandons the attempt (threads cannot be
    killed, so cancellation is best-effort -- per-dispatch sockets
    make the abandoned side harmless) and counts as a failure.  With
    no deadline and no hedge (the default policy) dispatch takes a
    threadless synchronous path instead, so the healthy fast path is
    a near-zero-cost pass-through,
  * **retry** -- up to ``policy.max_retries`` relaunches on retryable
    errors (``OSError`` by default, which covers timeouts and every
    ``TransportError``), separated by exponential backoff with
    decorrelated jitter, each under a ``retry`` trace span,
  * **hedge** -- optionally a second dispatch fires when the first is
    slower than the client's EWMA latency estimate plus ``k`` absolute
    deviations (a cheap p99 proxy); first result wins, the loser is
    abandoned, and ``shard_hedges_total{outcome}`` records who won,
  * **breaker** -- consecutive attempt failures open a circuit that
    short-circuits dispatches with ``CircuitOpenError`` *without
    touching the transport*; after ``breaker_reset_s`` one probe
    dispatch half-opens it, and a success closes it.  State lives in
    the ``shard_breaker_state`` gauge (0 closed / 1 half-open /
    2 open) and every transition emits a ``breaker`` trace span.

``ChaosShardClient`` is the deterministic fault injector the chaos
tests drive: a seeded schedule
draws, per ``dispatch`` call in call order, one of
``latency`` (slow-but-correct), ``oserror`` (dispatch raises),
``hang`` (slower than any reasonable deadline, then returns), or
``drop`` (connection dies mid-response), and logs the draw in
``fault_log`` so two runs of the same seed are byte-for-byte
comparable.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.index.query import SearchResult
from repro_torch.index.router import LocalShardClient, ShardClient
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer

__all__ = ["CircuitOpenError", "ShardDispatchTimeout", "ResiliencePolicy",
           "ResilientShardClient", "ChaosSchedule", "ChaosShardClient",
           "resilient_client_factory"]

_BREAKER_GAUGE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitOpenError(RuntimeError):
    """Dispatch short-circuited: the shard's breaker is open."""


class ShardDispatchTimeout(TimeoutError):
    """An attempt outlived ``policy.deadline_s`` and was abandoned."""


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs for one shard client's fault handling.

    ``deadline_s`` is **per attempt** (a dispatch with retries may take
    up to ``(max_retries + 1) * deadline_s`` plus backoff).  ``None``
    disables the deadline (and hedging's timeout arm).
    """
    deadline_s: Optional[float] = None
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 1.0
    hedge: bool = False
    hedge_k: float = 4.0              # delay = EWMA mean + k * EWMA |dev|
    hedge_min_s: float = 0.001
    hedge_max_s: float = 0.25
    breaker_failures: int = 5         # consecutive failures that open it
    breaker_reset_s: float = 1.0      # open -> half-open probe delay
    retryable: Tuple[type, ...] = (OSError,)


class _Breaker:
    """closed -> open -> half-open state machine, one per shard."""

    def __init__(self, policy: ResiliencePolicy, clock,
                 on_transition: Callable[[str, str], None]):
        self.policy = policy
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self.state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    def _move(self, new: str) -> None:
        old, self.state = self.state, new
        if old != new:
            self._on_transition(old, new)

    def admit(self) -> None:
        """Gate one dispatch; raises ``CircuitOpenError`` when open."""
        with self._lock:
            if self.state == "closed":
                return
            if self.state == "open":
                if (self._clock() - self._opened_at
                        < self.policy.breaker_reset_s):
                    raise CircuitOpenError(
                        "circuit open; next probe in "
                        f"{self.policy.breaker_reset_s:.3f}s")
                self._move("half_open")      # this dispatch is the probe
                self._probing = True
                return
            # half-open: exactly one probe in flight
            if self._probing:
                raise CircuitOpenError("circuit half-open; probe in flight")
            self._probing = True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self.state != "closed":
                self._move("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == "half_open":
                self._probing = False
                self._opened_at = self._clock()
                self._move("open")
            elif (self.state == "closed"
                    and self._failures >= self.policy.breaker_failures):
                self._opened_at = self._clock()
                self._move("open")


class ResilientShardClient(ShardClient):
    """Deadline + retry + hedge + breaker around an inner client.

    ``clock`` / ``sleep`` / ``rng`` are injectable for deterministic
    tests.  Metrics land in ``registry`` (default: the process
    registry) under the ``shard`` label; breaker transitions and
    retry/hedge activity emit spans on ``tracer`` when enabled.
    """

    def __init__(self, inner: ShardClient,
                 policy: ResiliencePolicy = ResiliencePolicy(), *,
                 shard: str = "0", registry=None, tracer=None,
                 clock=time.monotonic, sleep=time.sleep,
                 rng: Optional[random.Random] = None):
        self.inner = inner
        self.policy = policy
        self.shard = str(shard)
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._tracer = tracer
        self._lock = threading.Lock()
        self._ewma_m: Optional[float] = None   # mean latency
        self._ewma_d = 0.0                     # mean |deviation|
        reg = registry if registry is not None else get_registry()
        lbl = {"shard": self.shard}
        self._m_retries = reg.counter(
            "shard_dispatch_retries_total",
            "dispatch attempts relaunched after a retryable failure",
            labels=("shard",)).labels(**lbl)
        self._m_failures = reg.counter(
            "shard_dispatch_failures_total",
            "shard dispatch attempts that failed (incl. timeouts)",
            labels=("shard",)).labels(**lbl)
        self._m_timeouts = reg.counter(
            "shard_dispatch_timeouts_total",
            "attempts abandoned past the per-attempt deadline",
            labels=("shard",)).labels(**lbl)
        self._m_hedges = reg.counter(
            "shard_hedges_total",
            "hedged dispatches by outcome (win = hedge finished first)",
            labels=("shard", "outcome"))
        self._g_breaker = reg.gauge(
            "shard_breaker_state",
            "circuit state: 0 closed, 1 half-open, 2 open",
            labels=("shard",)).labels(**lbl)
        self._g_breaker.set(0.0)
        self.breaker = _Breaker(policy, clock, self._on_breaker)

    # -- observability ---------------------------------------------------
    def _tr(self):
        return self._tracer if self._tracer is not None else get_tracer()

    def _on_breaker(self, old: str, new: str) -> None:
        self._g_breaker.set(float(_BREAKER_GAUGE[new]))
        t = time.perf_counter()
        self._tr().add_span("breaker", t, t,
                            args={"shard": self.shard, "from": old,
                                  "to": new})

    def _observe_latency(self, dt: float) -> None:
        with self._lock:
            if self._ewma_m is None:
                self._ewma_m, self._ewma_d = dt, dt / 2.0
            else:
                self._ewma_m += 0.2 * (dt - self._ewma_m)
                self._ewma_d += 0.2 * (abs(dt - self._ewma_m)
                                       - self._ewma_d)

    def _hedge_delay(self) -> float:
        with self._lock:
            if self._ewma_m is None:
                return self.policy.hedge_max_s
            est = self._ewma_m + self.policy.hedge_k * self._ewma_d
        return min(self.policy.hedge_max_s,
                   max(self.policy.hedge_min_s, est))

    # -- ShardClient -----------------------------------------------------
    @property
    def n(self) -> int:
        return self.inner.n

    def _launch(self, call_q: "queue.Queue", kind: str, qwords, topk,
                mode, query_sizes, qkeys) -> None:
        def run():
            t0 = self._clock()
            try:
                res = self.inner.dispatch(qwords, topk, mode=mode,
                                          query_sizes=query_sizes,
                                          qkeys=qkeys)()
                call_q.put((kind, res, None, self._clock() - t0))
            except BaseException as e:
                call_q.put((kind, None, e, self._clock() - t0))
        threading.Thread(target=run, daemon=True,
                         name=f"shard{self.shard}-{kind}").start()

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        self.breaker.admit()                 # CircuitOpenError when open
        args = (qwords, topk, mode, query_sizes, qkeys)
        if self.policy.deadline_s is None and not self.policy.hedge:
            # no timers to race: skip the attempt threads entirely so
            # the healthy path stays a near-zero-cost pass-through
            return self._dispatch_sync(args)
        call_q: "queue.Queue" = queue.Queue()
        self._launch(call_q, "primary", qwords, topk, mode, query_sizes,
                     qkeys)
        return lambda: self._harvest(call_q, args)

    def _dispatch_sync(self, args) -> Callable[[], SearchResult]:
        """Threadless dispatch+retry (no deadline, no hedge).  The inner
        dispatch still fires eagerly so cross-shard overlap survives;
        failures defer to the harvest, where the retry loop lives."""
        qwords, topk, mode, query_sizes, qkeys = args
        t0 = self._clock()
        pending: Optional[Callable[[], SearchResult]] = None
        err: Optional[BaseException] = None
        try:
            pending = self.inner.dispatch(qwords, topk, mode=mode,
                                          query_sizes=query_sizes,
                                          qkeys=qkeys)
        except BaseException as e:
            err = e

        def harvest() -> SearchResult:
            nonlocal t0, pending, err
            tracer = self._tr()
            retries = 0
            while True:
                if err is None:
                    try:
                        res = pending()
                        self.breaker.record_success()
                        self._observe_latency(self._clock() - t0)
                        return res
                    except BaseException as e:
                        err = e
                self._attempt_failed(err)
                if (not isinstance(err, self.policy.retryable)
                        or retries >= self.policy.max_retries):
                    raise err
                retries += 1
                self._m_retries.inc()
                with tracer.span("retry",
                                 args={"shard": self.shard,
                                       "attempt": retries,
                                       "error": type(err).__name__}):
                    self._backoff_sleep()
                t0 = self._clock()
                err = None
                try:
                    pending = self.inner.dispatch(
                        qwords, topk, mode=mode, query_sizes=query_sizes,
                        qkeys=qkeys)
                except BaseException as e:
                    err = e
        return harvest

    def _attempt_failed(self, err: BaseException) -> None:
        self._m_failures.inc()
        self.breaker.record_failure()

    def _backoff_sleep(self) -> None:
        # decorrelated jitter: sleep ~ U(base, 3 * prev), capped
        prev = getattr(self, "_last_backoff_s", self.policy.backoff_base_s)
        backoff = min(self.policy.backoff_cap_s,
                      self._rng.uniform(self.policy.backoff_base_s,
                                        prev * 3.0))
        self._last_backoff_s = backoff
        self._sleep(backoff)

    def _harvest(self, call_q: "queue.Queue", args) -> SearchResult:
        qwords, topk, mode, query_sizes, qkeys = args
        policy = self.policy
        tracer = self._tr()
        retries = 0
        inflight = 1
        hedged = False
        t_last_launch = self._clock()
        t_hedge = None
        last_err: Optional[BaseException] = None
        while True:
            # When does the wait expire?  Hedge arm first (if armed),
            # then the per-attempt deadline of the newest attempt.
            hedge_arm = (policy.hedge and not hedged and retries == 0
                         and inflight == 1)
            now = self._clock()
            deadline_left = (None if policy.deadline_s is None
                             else t_last_launch + policy.deadline_s - now)
            if hedge_arm:
                wait = self._hedge_delay()
                if deadline_left is not None:
                    wait = min(wait, deadline_left)
            else:
                wait = deadline_left
            if wait is not None and wait < 0.0:
                wait = 0.0
            try:
                kind, res, err, dt = call_q.get(timeout=wait)
            except queue.Empty:
                if hedge_arm and (deadline_left is None
                                  or self._clock() - t_last_launch
                                  < policy.deadline_s):
                    hedged = True
                    t_hedge = self._clock()
                    inflight += 1
                    t_last_launch = t_hedge
                    self._launch(call_q, "hedge", *args)
                    continue
                # per-attempt deadline blown: abandon what's in flight
                self._m_timeouts.inc()
                last_err = ShardDispatchTimeout(
                    f"shard {self.shard} dispatch exceeded "
                    f"{policy.deadline_s:.3f}s "
                    f"({inflight} attempt(s) abandoned)")
                self._attempt_failed(last_err)
                inflight = 0
            else:
                inflight -= 1
                if err is None:
                    self.breaker.record_success()
                    self._observe_latency(dt)
                    if hedged:
                        outcome = "win" if kind == "hedge" else "loss"
                        self._m_hedges.labels(shard=self.shard,
                                              outcome=outcome).inc()
                        tracer.add_span(
                            "hedge", t_hedge, self._clock(),
                            args={"shard": self.shard,
                                  "outcome": outcome})
                    return res
                self._attempt_failed(err)
                last_err = err
                if not isinstance(err, policy.retryable):
                    raise err
                if inflight > 0:
                    continue                 # the hedge twin may still win
            # no attempt left in flight: retry or give up
            if retries >= policy.max_retries:
                raise last_err
            retries += 1
            self._m_retries.inc()
            with tracer.span("retry",
                             args={"shard": self.shard,
                                   "attempt": retries,
                                   "error": type(last_err).__name__}):
                self._backoff_sleep()
            inflight = 1
            t_last_launch = self._clock()
            self._launch(call_q, f"retry{retries}", *args)


# -- deterministic fault injection --------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Seeded per-dispatch fault plan.

    Each ``dispatch`` draws once, in call order, under a lock: with
    probability ``fault_rate`` one of ``faults`` fires, else the call
    passes through.  Same seed + same call sequence => identical
    draws, independent of wall-clock timing.
    """
    seed: int = 0
    fault_rate: float = 0.25
    faults: Tuple[str, ...] = ("latency", "oserror", "hang", "drop")
    latency_s: float = 0.01           # injected slow-but-fine delay
    hang_s: float = 0.5               # "hang": slower than any deadline


class ChaosShardClient(ShardClient):
    """Fault-injecting ``ShardClient`` wrapper (see ``ChaosSchedule``).

    ``fault_log`` records ``(call_index, kind_or_None)`` per dispatch;
    the seeded-determinism test pins it across runs.
    """

    def __init__(self, inner: ShardClient, schedule: ChaosSchedule, *,
                 sleep=time.sleep):
        self.inner = inner
        self.schedule = schedule
        self._sleep = sleep
        self._rng = np.random.default_rng(schedule.seed)
        self._lock = threading.Lock()
        self._calls = 0
        self.fault_log: list = []

    @property
    def n(self) -> int:
        return self.inner.n

    def _draw(self) -> Optional[str]:
        with self._lock:
            i = self._calls
            self._calls += 1
            kind = None
            if float(self._rng.random()) < self.schedule.fault_rate:
                kind = self.schedule.faults[
                    int(self._rng.integers(len(self.schedule.faults)))]
            self.fault_log.append((i, kind))
            return kind

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        kind = self._draw()
        if kind == "oserror":
            raise OSError("chaos: injected I/O fault")
        inner_harvest = self.inner.dispatch(qwords, topk, mode=mode,
                                            query_sizes=query_sizes,
                                            qkeys=qkeys)
        if kind is None:
            return inner_harvest

        def harvest() -> SearchResult:
            if kind == "drop":
                inner_harvest()
                raise ConnectionResetError(
                    "chaos: connection dropped mid-response")
            # latency / hang: slow but eventually correct -- a hang is
            # just latency longer than any sane deadline.
            self._sleep(self.schedule.latency_s if kind == "latency"
                        else self.schedule.hang_s)
            return inner_harvest()
        return harvest


def resilient_client_factory(policy: ResiliencePolicy = ResiliencePolicy(),
                             *, inner_factory=None, chaos=None,
                             registry=None, tracer=None,
                             clock=time.monotonic, sleep=time.sleep,
                             seed: Optional[int] = None):
    """``client_factory=`` helper stacking resilience (and optionally
    chaos) over per-shard inner clients.

    Shard ids are assigned in construction order (the router builds
    clients in shard order).  ``chaos`` is a ``ChaosSchedule``, or a
    callable ``shard_index -> ChaosSchedule | None`` for per-shard
    schedules.  The factory keeps ``.clients`` / ``.chaos_clients``
    for inspection.
    """
    def factory(searcher) -> ResilientShardClient:
        i = len(factory.clients)
        inner = (inner_factory or LocalShardClient)(searcher)
        if chaos is not None:
            sched = chaos(i) if callable(chaos) else chaos
            if sched is not None:
                inner = ChaosShardClient(inner, sched, sleep=sleep)
                factory.chaos_clients.append(inner)
        rng = random.Random(seed + i) if seed is not None else None
        client = ResilientShardClient(inner, policy, shard=str(i),
                                      registry=registry, tracer=tracer,
                                      clock=clock, sleep=sleep, rng=rng)
        factory.clients.append(client)
        return client

    factory.clients = []
    factory.chaos_clients = []
    return factory
