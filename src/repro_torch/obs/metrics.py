"""Process-wide metrics registry for the serving stack (the port's own
copy of ``repro.obs.metrics``: plain Python, and the same metric names,
labels and Prometheus text, so one dashboard reads both packages).

A thread-safe ``MetricsRegistry`` of named counters, gauges and
bounded-reservoir histograms (with Prometheus label support), plus a
*collector* seam so stat holders keep their in-object storage (and their
locks) while still exporting through ONE snapshot API.

Two registration styles, by ownership:

  * **registry-owned metrics** -- ``registry.counter(name)`` /
    ``.gauge`` / ``.histogram`` return live metric objects the caller
    mutates (``inc`` / ``set`` / ``observe``).  Creation is idempotent:
    asking for an existing name returns the same family (a type or
    label-name mismatch raises).
  * **collectors** -- ``registry.register_object(holder, fn)`` keeps a
    ``weakref`` to an existing stat holder (``ServerStats``,
    ``ShardedIndex``, ``LoaderStats``, ``SignatureCache``) and calls
    ``fn(holder)`` at snapshot time to yield ``Sample``s read from the
    holder's own fields under the holder's own lock.  Dead holders are
    pruned automatically -- registering never extends a lifetime.

``snapshot()`` merges both sources into one dict (samples with the same
name + labels sum -- right for counters, and documented behaviour for
gauges when several holders share a name); ``prometheus_text()`` renders
the Prometheus text exposition served by ``repro_torch.obs.export``.

The default process registry is reached with ``get_registry()``;
``reset()`` zeroes every registry-owned metric and prunes dead
collectors (the test-isolation hook -- live holders keep reporting).
Tests that need totals unpolluted by other components pass a private
``MetricsRegistry`` instead.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import re
import threading
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

_TYPES = ("counter", "gauge", "summary")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One exported measurement.

    ``suffix`` distinguishes summary components (``""`` for the
    quantile samples, ``"_sum"`` / ``"_count"`` for the aggregates) --
    the exposition name is ``name + suffix``.
    """

    name: str
    mtype: str                        # "counter" | "gauge" | "summary"
    help: str
    labels: Tuple[Tuple[str, str], ...]     # sorted (key, value) pairs
    value: float
    suffix: str = ""


def _label_items(labels: Optional[Dict[str, object]]
                 ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"illegal label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic float counter (one labeled child)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable instantaneous value (one labeled child)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir histogram (one labeled child).

    Keeps exact ``count`` / ``sum`` plus a bounded deque of recent
    observations for the quantile snapshot -- the same reservoir
    discipline ``ServerStats`` already uses, so a long-running server
    never grows without bound.
    """

    __slots__ = ("_lock", "count", "total", "_reservoir")

    def __init__(self, lock: threading.Lock, reservoir: int):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self._reservoir: collections.deque = collections.deque(
            maxlen=reservoir)

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            self._reservoir.append(float(v))

    def quantiles(self, qs=(0.5, 0.99)) -> Dict[float, float]:
        with self._lock:
            vals = sorted(self._reservoir)
        if not vals:
            return {q: float("nan") for q in qs}
        return {q: vals[min(len(vals) - 1, int(q * len(vals)))] for q in qs}


class _Family:
    """One named metric family: type, help, label names, children."""

    def __init__(self, name: str, mtype: str, help: str,
                 labelnames: Tuple[str, ...], lock: threading.Lock,
                 reservoir: int):
        self.name = name
        self.mtype = mtype
        self.help = help
        self.labelnames = labelnames
        self._lock = lock
        self._reservoir = reservoir
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.mtype == "counter":
            return Counter(self._lock)
        if self.mtype == "gauge":
            return Gauge(self._lock)
        return Histogram(self._lock, self._reservoir)

    def labels(self, **labelvalues):
        """The child bound to one label-value set (created on demand)."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    # unlabeled families proxy straight to their single child
    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             f"use .labels(...)")
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def samples(self) -> Iterable[Sample]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            labels = tuple(zip(self.labelnames, key))
            if isinstance(child, Histogram):
                qs = child.quantiles()
                for q, v in qs.items():
                    yield Sample(self.name, "summary", self.help,
                                 labels + (("quantile", f"{q:g}"),), v)
                yield Sample(self.name, "summary", self.help, labels,
                             float(child.total), suffix="_sum")
                yield Sample(self.name, "summary", self.help, labels,
                             float(child.count), suffix="_count")
            else:
                yield Sample(self.name, self.mtype, self.help, labels,
                             child.value)


class MetricsRegistry:
    """Thread-safe registry of metric families + stat-holder collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Tuple[weakref.ref, Callable]] = []

    # -- registry-owned metrics ------------------------------------------
    def _family(self, name: str, mtype: str, help: str,
                labels: Tuple[str, ...], reservoir: int = 4096) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"illegal metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"illegal label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.mtype != mtype or tuple(sorted(fam.labelnames)) != \
                        tuple(sorted(labels)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.mtype}{fam.labelnames}, not "
                        f"{mtype}{labels}")
                return fam
            fam = _Family(name, mtype, help or name, labels,
                          threading.Lock(), reservoir)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> _Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> _Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (),
                  reservoir: int = 4096) -> _Family:
        return self._family(name, "summary", help, labels, reservoir)

    # -- collectors over existing stat holders ---------------------------
    def register_object(self, holder: object,
                        fn: Callable[[object], Iterable[Sample]]) -> None:
        """Snapshot-time collector over ``holder`` (kept by weakref:
        registration never extends the holder's lifetime, and a dead
        holder's samples simply stop appearing)."""
        with self._lock:
            self._collectors.append((weakref.ref(holder), fn))

    def _collect(self) -> List[Sample]:
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        out: List[Sample] = []
        for fam in families:
            out.extend(fam.samples())
        dead = []
        for ref, fn in collectors:
            holder = ref()
            if holder is None:
                dead.append((ref, fn))
                continue
            out.extend(fn(holder))
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]
        return out

    # -- the one snapshot API --------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """Merged view of every metric: ``{name: {type, help, samples}}``.

        Samples with identical (name, suffix, labels) -- e.g. the same
        counter exported by two live servers -- are summed.
        """
        merged: Dict[str, dict] = {}
        order: Dict[Tuple, int] = {}
        for s in self._collect():
            fam = merged.setdefault(
                s.name, {"type": s.mtype, "help": s.help, "samples": []})
            key = (s.name, s.suffix, s.labels)
            i = order.get(key)
            if i is None:
                order[key] = len(fam["samples"])
                fam["samples"].append({"suffix": s.suffix,
                                       "labels": dict(s.labels),
                                       "value": s.value})
            else:
                fam["samples"][i]["value"] += s.value
        return merged

    def values(self) -> Dict[str, float]:
        """Flat ``{"name{k=v,...}": value}`` convenience view."""
        out: Dict[str, float] = {}
        for name, fam in self.snapshot().items():
            for s in fam["samples"]:
                lbl = ",".join(f'{k}="{v}"'
                               for k, v in sorted(s["labels"].items()))
                key = name + s["suffix"] + (f"{{{lbl}}}" if lbl else "")
                out[key] = s["value"]
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of ``snapshot()``."""
        lines: List[str] = []
        for name, fam in sorted(self.snapshot().items()):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["samples"]:
                lbl = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(s["labels"].items()))
                label_part = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}{s['suffix']}{label_part} "
                             f"{_fmt_value(s['value'])}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every registry-owned metric; prune dead collectors.

        Live stat holders keep reporting (their collectors survive) --
        tests needing totals in full isolation use a private registry.
        """
        with self._lock:
            for fam in self._families.values():
                fam._children.clear()
            self._collectors = [(ref, fn) for ref, fn in self._collectors
                                if ref() is not None]


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace('"', r'\"')
             .replace("\n", r"\n"))


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what the serving stack's stat
    holders register into, and what ``repro_torch.obs.export`` serves)."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (returns the previous one)."""
    global _default_registry
    with _default_lock:
        prev, _default_registry = _default_registry, registry
    return prev
