"""The general part of the benchmark: find a cell by name, run its driver,
time and trace the window, read the per-layer metrics, and print the
result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by its name:

  * ``bench/configs/<config>.json``   -- the sizes of one deployment;
  * ``bench/traffic/<traffic>.json``  -- the parameters of one mix and the
    driver that runs it (``bench/drivers/<driver>.py``);
  * ``bench/metrics/<metric>.py``     -- a reader, ``read(view)``, that
    takes one per-layer metric from a ``TraceView`` or returns None.

A driver's ``run(ctx)`` makes its inputs, warms up, drives the program
through the window (``ctx.window_over`` / ``ctx.tick`` / ``ctx.span``),
calls ``ctx.close_window()`` and then checks what the window produced
against the plain reference; it returns a ``Outcome``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# The benchmark's description
# ---------------------------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self):
        return importlib.import_module(
            f"bench.drivers.{self.traffic['driver']}")


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    config = read_json(BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The run's context: window, spans, profiler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostSpan:
    name: str
    t0: float
    t1: float
    profiled: bool


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: counts, end-to-end values, the numbers
    compared with their limits, and the work done inside the traced part
    of the window (for the readers)."""

    attempted: int
    failed: int
    values: Dict[str, float]
    checks: Dict[str, dict]
    work: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(passes(c) for c in self.checks.values()) and \
            bool(self.checks)


def passes(check: dict) -> bool:
    v = check["value"]
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return False
    if "limit" in check and v > check["limit"]:
        return False
    if "at_least" in check and v < check["at_least"]:
        return False
    return True


class Ctx:
    """One run: the seed, the window's length, the device, the spans.

    ``trace`` runs the profiler over the first ``trace_seconds`` of the
    window (the traffic's parameter, at most the window); the spans are
    recorded by the host clock all through the window either way, and
    also as profiler ranges while it runs.  ``control`` tells the driver
    to put the reference, in the control's precision, in the program's
    place."""

    def __init__(self, cell: Cell, *, seed: int, seconds: float,
                 trace: bool, device: torch.device, t_start: float,
                 control: bool = False):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device, self.control = device, control
        self.t_start = t_start
        self.t_ctx = time.perf_counter()    # interpreter and imports before
        self.trace_seconds = min(self.seconds,
                                 float(self.traffic.get("trace_seconds",
                                                        self.seconds)))
        self.spans: List[HostSpan] = []
        self.setup_s: Optional[float] = None
        self.t0 = None
        self.memory_peak = 0
        self._prof = None
        self._prof_t0 = None
        self._prof_done = False
        self._window_range = None
        self.prof_wall_s = 0.0

    # -- synchronisation ----------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- window ---------------------------------------------------------------
    def open_window(self) -> None:
        """End of set-up: everything is built and warm.  A traced run
        starts the profiler here, before the window's clock (its start
        takes seconds the first time)."""
        self.sync()
        if self.trace:
            self._start_profiler()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start

    def window_over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def tick(self) -> None:
        """Between two units of work: stop the profiler once it has run
        ``trace_seconds``."""
        if self.profiling and \
                time.perf_counter() - self._prof_t0 >= self.trace_seconds:
            self._stop_profiler()

    def close_window(self) -> float:
        """After the last unit of work has been waited for: stop the
        profiler and read the memory peak.  Returns the window's
        seconds."""
        self.sync()
        t_end = time.perf_counter()
        if self.profiling:
            self._stop_profiler()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))
        return t_end - self.t0

    @property
    def profiling(self) -> bool:
        return self._prof is not None and not self._prof_done

    def _start_profiler(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._window_range = torch.profiler.record_function("bench.window")
        self._window_range.__enter__()
        self._prof_t0 = time.perf_counter()

    def _stop_profiler(self) -> None:
        self.sync()
        self.prof_wall_s = time.perf_counter() - self._prof_t0
        self._window_range.__exit__(None, None, None)
        self._prof.stop()
        self._prof_done = True

    # -- spans ----------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block by the host clock; while the profiler runs, also
        as a profiler range of the same name."""
        profiled = self.profiling
        rf = torch.profiler.record_function(name) if profiled else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(HostSpan(name, t0, t1, profiled))

    # -- the traced window ----------------------------------------------------
    def trace_view(self, work: dict) -> Optional["TraceView"]:
        if self._prof is None:
            return None
        return TraceView.from_profiler(self._prof.events(), self.spans, work,
                                       self.prof_wall_s)


# ---------------------------------------------------------------------------
# The trace, reduced
# ---------------------------------------------------------------------------

def _is_device(evt) -> bool:
    return getattr(evt.device_type, "name", str(evt.device_type)) != "CPU"


@dataclasses.dataclass
class TraceView:
    """The profiled part of the window, on the profiler's clock (us).

    ``ranges``: the benchmark's spans (``name -> [(start, end)]``);
    ``device``: every device activity (kernels, copies, sets) as (name,
    start, end); ``launched``: each device activity as (host time of its
    launch, name, duration), sorted; ``unlinked``: device activities
    whose launch is not in the trace; ``host_spans``:
    every span of the window by the host clock; ``work``: what the
    driver says the traced spans did."""

    window: tuple
    ranges: Dict[str, List[tuple]]
    device: List[tuple]
    launched: List[tuple]
    host_spans: List[HostSpan]
    work: dict
    unlinked: int = 0

    @staticmethod
    def from_profiler(events, host_spans, work, wall_s) -> "TraceView":
        """Each device activity is attributed to the host time of the
        runtime call that launched it (the two share CUPTI's correlation
        id).  Activities with no such call in the trace are counted in
        ``unlinked``; while any is, ``under`` attributes nothing."""
        names = {s.name for s in host_spans if s.profiled} | {"bench.window"}
        ranges: Dict[str, List[tuple]] = {}
        device, launched, runtime = [], [], {}
        for e in events:
            t = (e.time_range.start, e.time_range.end)
            if _is_device(e):
                if e.name not in names:
                    device.append((e.name, t[0], t[1], e.id))
                continue
            if e.name in names:
                ranges.setdefault(e.name, []).append(t)
            elif e.name.startswith("cu"):          # a CUDA runtime call
                runtime[e.id] = t[0]
        for name, s, e, corr in device:
            if corr in runtime:
                launched.append((runtime[corr], name, e - s))
        unlinked = len(device) - len(launched)
        print(f"trace: {len(device)} device activities, {len(launched)} "
              f"linked to their launch", file=sys.stderr)
        win = ranges.get("bench.window", [(0.0, wall_s * 1e6)])[0]
        for v in ranges.values():
            v.sort()
        device = sorted((d[:3] for d in device), key=lambda d: d[1])
        return TraceView(win, ranges, device, sorted(launched),
                         list(host_spans), dict(work), unlinked)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[tuple]:
        """Device activity merged into disjoint intervals, clipped to the
        window."""
        lo, hi = self.window
        out: List[list] = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def under(self, span: str) -> Optional[List[tuple]]:
        """(name, duration us) of device activity launched while a range
        ``span`` was open on the host; None where some activity of the
        trace has no launch to attribute it by."""
        if self.unlinked:
            return None
        spans = self.ranges.get(span, [])
        starts = [s for s, _ in spans]
        out = []
        for t, name, dur in self.launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append((name, dur))
        return out

    def host_at(self, t: float) -> str:
        """The benchmark range open at ``t`` (the drivers' ranges do not
        overlap), or ``harness`` when none is."""
        if not hasattr(self, "_flat"):
            flat = sorted((s, e, name) for name, spans in self.ranges.items()
                          if name != "bench.window" for s, e in spans)
            self._flat = ([s for s, _, _ in flat], flat)
        starts, flat = self._flat
        i = bisect.bisect_right(starts, t) - 1
        return flat[i][2] if i >= 0 and t <= flat[i][1] else "harness"

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        gaps: Dict[str, float] = {}
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + \
            [self.window[1]]
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e > s:
                name = self.host_at(s)
                gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


# ---------------------------------------------------------------------------
# Running a cell and printing the result
# ---------------------------------------------------------------------------

def loaded_forbidden() -> List[str]:
    """Modules whose top-level name is jax, jaxlib, flax or repro."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(ctx: Ctx) -> dict:
    dev = ctx.device
    if dev.type == "cuda":
        kind, count, platform = torch.cuda.get_device_name(dev), 1, "gpu"
    else:
        kind, count, platform = "cpu", 1, "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": ctx.memory_peak}


def execute(cell: Cell, *, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, control: bool = False,
            out=None, err=None) -> dict:
    """Run ``cell`` once and print its result as the last line of ``out``
    (the numbers compared, beside their limits, as the last lines of
    ``err``).  Returns the result; raises ``SystemExit`` when a forbidden
    module was loaded."""
    out = out or sys.stdout
    err = err or sys.stderr
    ctx = Ctx(cell, seed=seed, seconds=seconds, trace=trace, device=device,
              t_start=t_start, control=control)
    outcome: Outcome = cell.driver.run(ctx)
    found = loaded_forbidden()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        raise SystemExit(3)
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": {},
              "device": device_info(ctx)}
    if not trace:
        values = dict(outcome.values, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    else:
        view = ctx.trace_view(outcome.work)
        if view is not None:
            for m in cell.per_layer:
                value = reader(m["name"])(view)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            result["device"]["busy_s"] = view.busy_s
            result["device"]["window_s"] = view.window_s
            result["breakdown"] = view.breakdown()
    result["checks"] = outcome.checks
    if ctx.setup_s is not None:
        parts = [f"start {ctx.t_ctx - ctx.t_start:.3f}"] + [
            f"{sp.name} {sp.t1 - sp.t0:.3f}" for sp in ctx.spans
            if sp.name.startswith("setup.")]
        print(f"setup_s {ctx.setup_s:.3f}: {', '.join(parts)}", file=err)
    for name, c in outcome.checks.items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        print(f"check {name}: {c['value']} ({bound})", file=err)
    print(json.dumps(result), file=out)
    out.flush()
    return result
