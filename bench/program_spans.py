"""The program's own spans on the profiler's timeline.

``SignatureEngine`` records ``sig.engine`` and its children ``sig.plan``,
``sig.counts``, ``sig.kernel`` and ``sig.epilogue`` into the process-wide
tracer of ``repro_torch.obs`` while a profiler runs.  They are not
profiler ranges (a range that encloses kernels would show on the device's
timeline as an activity that launched nothing), so they are read here
from the tracer's buffer, in ``time.perf_counter`` seconds, and mapped
onto the profiler's microseconds through the benchmark's own spans: each
profiled ``engine.call`` is timed on both clocks, and the offset is the
median, over those pairs taken in order, of the difference of their
midpoints.

Each device activity launched under an ``engine.call`` range goes to the
``sig.*`` child open when its runtime call started.  ``split`` returns
None, and every reader with it, where the attribution cannot be trusted:
an activity of the trace has no launch (``view.unlinked``), the tracer
dropped spans, the two clocks' spans or the engine's calls do not pair
one to one, a mapped ``sig.engine`` lies outside its ``engine.call`` by
more than ``TOLERANCE_US``, or an activity launched under an
``engine.call`` lies in no child (with ``TOLERANCE_US`` of room at each
edge).  A program that records no such spans, or a trace with no device
activity under the engine's calls, reads None too.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Dict, List, Optional

CALL = "engine.call"
ENGINE = "sig.engine"
CHILDREN = ("sig.plan", "sig.counts", "sig.kernel", "sig.epilogue")
# room for the error of the mapping at the edges of a span (us).  On an
# H100's host, against the profiler's own clock (four profiled windows), a
# range opens a median 8-41 us before its host span and closes 24-60 us
# after it, so the midpoints' offset maps spans 8-9 us late; a launch
# starts 22 us or more after its span opens and 10 us or more before it
# closes, and none changed span between that mapping and the exact one
TOLERANCE_US = 10.0


@dataclasses.dataclass
class Split:
    """Device time (us) launched under each ``sig.*`` child, summed over
    the ``calls`` traced engine calls; ``call_us``: under ``engine.call``
    in all; ``offset_us``: profiler us less perf-counter us."""

    calls: int
    device_us: Dict[str, float]
    call_us: float
    offset_us: float

    def per_call(self, child: str) -> float:
        return self.device_us.get(child, 0.0) / self.calls


def tracer_spans() -> Optional[List[tuple]]:
    """The tracer's ``sig.*`` spans as (name, span id, parent id, t0 us,
    t1 us) on the perf-counter clock; None where the tracer dropped
    spans, names another clock, or holds none."""
    from repro_torch.obs.trace import get_tracer
    tracer = get_tracer()
    if tracer.dropped:
        return None
    doc = tracer.to_json()
    clock = doc.get("otherData") or {}
    if clock.get("clock") != "perf_counter":
        return None
    epoch_us = clock["epoch_s"] * 1e6
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith("sig."):
            t0 = epoch_us + e["ts"]
            out.append((e["name"], e["args"]["span_id"],
                        e["args"]["parent_id"], t0, t0 + e["dur"]))
    return out if any(s[0] == ENGINE for s in out) else None


def clock_offset(view) -> Optional[float]:
    """Profiler us less perf-counter us: the median over the profiled
    ``engine.call`` spans, paired in order with their ranges, of the
    difference of their midpoints; None where the counts differ."""
    host = [s for s in view.host_spans if s.name == CALL and s.profiled]
    ranges = view.ranges.get(CALL, [])
    if not host or len(host) != len(ranges):
        return None
    return statistics.median((r0 + r1) / 2 - (h.t0 + h.t1) / 2 * 1e6
                             for h, (r0, r1) in zip(host, ranges))


def _nearest(children: List[tuple], t: float) -> Optional[str]:
    """The child (name, start, end) open at ``t``, else the nearest one
    within ``TOLERANCE_US`` of ``t``."""
    best, gap = None, TOLERANCE_US
    for name, s, e in children:
        d = max(s - t, t - e, 0.0)
        if d <= gap:
            best, gap = name, d
    return best


def split(view) -> Optional[Split]:
    """The engine's device time split by its spans (see the module's
    docstring), cached on ``view``."""
    if "_program_split" not in view.__dict__:
        view.__dict__["_program_split"] = _split(view)
    return view.__dict__["_program_split"]


def _split(view) -> Optional[Split]:
    if view.unlinked:
        return None
    spans = tracer_spans()
    offset = clock_offset(view) if spans else None
    if offset is None:
        return None
    ranges = view.ranges[CALL]
    lo, hi = ranges[0][0] - TOLERANCE_US, ranges[-1][1] + TOLERANCE_US
    engines = sorted((s[3] + offset, s[4] + offset, s[1]) for s in spans
                     if s[0] == ENGINE and s[4] + offset >= lo
                     and s[3] + offset <= hi)
    if len(engines) != len(ranges):
        return None
    kids: Dict[int, List[tuple]] = {sid: [] for _, _, sid in engines}
    for name, _, parent, t0, t1 in spans:
        if parent in kids and name in CHILDREN:
            kids[parent].append((name, t0 + offset, t1 + offset))
    for (s, e, _), (r0, r1) in zip(engines, ranges):
        if s < r0 - TOLERANCE_US or e > r1 + TOLERANCE_US:
            return None
    starts = [r0 for r0, _ in ranges]
    device_us = {name: 0.0 for name in CHILDREN}
    call_us = 0.0
    for t, _, dur in view.launched:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > ranges[i][1]:
            continue
        child = _nearest(kids[engines[i][2]], t)
        if child is None:
            return None
        device_us[child] += dur
        call_us += dur
    if call_us <= 0:
        return None
    return Split(len(ranges), device_us, call_us, offset)
