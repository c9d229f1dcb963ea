"""The readers of the engine's own spans (``bench/program_spans.py`` and
the three ``sig_*`` metrics): the clock fit and the attribution on a
synthetic trace, each case in which they read None, and a CPU-profiled
run of the preprocess driver whose trace is the same with and without the
engine's spans recording."""

import dataclasses
import time

import pytest
import torch

from bench import harness
from bench import program_spans as ps
from bench.yardstick import minhash_least_ms
from conftest import tiny
from repro_torch.obs import trace as tt

OFFSET_US = -98_765.25          # profiler us less perf-counter us
T0 = 50.0                       # perf-counter seconds of the first call
# a call's children (us from the engine.call span's start), and what each
# launches: (us from the start, kernel, device us)
CHILD_US = {"sig.plan": (3, 9), "sig.counts": (10, 40),
            "sig.kernel": (41, 90), "sig.epilogue": (91, 300)}
LAUNCHES = [(25, "reduce", 60.0), (70, "minhash2u_kernel", 1500.0),
            (120, "elementwise", 100.0), (200, "index_add", 150.0),
            (290, "elementwise", 90.0)]
WORK = {"k": 500, "b": 8, "four_u": False, "rows": [100] * 3,
        "nonzeros": [37_000] * 3}
READERS = ("sig_kernel_roofline_share.preprocess",
           "sig_epilogue_device_us_per_chunk.preprocess",
           "sig_counts_device_us_per_chunk.preprocess")


@pytest.fixture
def tracer():
    mine = tt.Tracer(enabled=True)
    prev = tt.set_tracer(mine)
    try:
        yield mine
    finally:
        tt.set_tracer(prev)


def synthetic(tracer, calls=3, lead_us=2.0, lag_us=2.0, extra=(),
              engine_end_us=301, call_end_us=303):
    """``calls`` engine calls 10 ms apart: the tracer's spans, the
    benchmark's host spans, and a ``TraceView`` whose ranges open
    ``lead_us`` before and close ``lag_us`` after them on the profiler's
    clock; ``extra``: more (us from a call's start, name, us) launches in
    every call; ``engine_end_us`` / ``call_end_us``: where each
    ``sig.engine`` / ``engine.call`` span ends."""
    host, ranges, launched = [], [], []
    for i in range(calls):
        t = T0 + 0.01 * i
        us = lambda off: t + off * 1e-6
        eng = tracer.start_span("sig.engine", t0=us(2),
                                args={"scheme": "minhash2u"})
        for name, (a, b) in CHILD_US.items():
            tracer.add_span(name, us(a), us(b), parent=eng)
        tracer.end_span(eng, t1=us(engine_end_us))
        host.append(harness.HostSpan("engine.call", t, us(call_end_us),
                                     True))
        ranges.append((t * 1e6 + OFFSET_US - lead_us,
                       us(call_end_us) * 1e6 + OFFSET_US + lag_us))
        for off, name, dur in list(LAUNCHES) + list(extra):
            launched.append((us(off) * 1e6 + OFFSET_US, name, dur))
    device = [(name, t, t + dur) for t, name, dur in launched]
    lo, hi = ranges[0][0] - 10, ranges[-1][1] + 10
    return harness.TraceView(
        window=(lo, hi), ranges={"engine.call": ranges,
                                 "bench.window": [(lo, hi)]},
        device=device, launched=sorted(launched), host_spans=host,
        work=dict(WORK))


def test_offset_fit_and_attribution(tracer):
    view = synthetic(tracer, lead_us=1.0, lag_us=3.0)
    split = ps.split(view)
    assert split.offset_us == pytest.approx(OFFSET_US + 1.0, abs=1e-3)
    assert split.calls == 3
    assert split.device_us == pytest.approx(
        {"sig.plan": 0.0, "sig.counts": 180.0, "sig.kernel": 4500.0,
         "sig.epilogue": 1020.0})
    assert split.call_us == pytest.approx(sum(split.device_us.values()))
    under = sum(d for _, d in view.under("engine.call"))
    assert split.call_us == pytest.approx(under)
    least_ms = 3 * minhash_least_ms(37_000, 100, 500, False, 8)
    read = {m: harness.reader(m)(view) for m in READERS}
    assert read == pytest.approx({
        READERS[0]: 100.0 * least_ms * 1e3 / 4500.0,
        READERS[1]: 340.0, READERS[2]: 60.0})


def test_a_launch_just_past_a_childs_edge_goes_to_that_child(tracer):
    """Within the tolerance of an edge, and nearest the counts' end."""
    view = synthetic(tracer, extra=[(40.4, "late", 7.0)])
    assert ps.split(view).device_us["sig.counts"] == pytest.approx(201.0)


def test_spans_outside_the_window_are_left_out(tracer):
    """A span recorded before the profiled calls (here 5 s earlier) maps
    outside every engine.call and is not counted."""
    eng = tracer.start_span("sig.engine", t0=T0 - 5.0)
    tracer.add_span("sig.kernel", T0 - 5.0, T0 - 4.9, parent=eng)
    tracer.end_span(eng, t1=T0 - 4.9)
    assert ps.split(synthetic(tracer)).calls == 3


def _refused(view):
    return ps.split(view) is None and \
        all(harness.reader(m)(view) is None for m in READERS)


def test_none_when_an_activity_is_unlinked(tracer):
    view = dataclasses.replace(synthetic(tracer), unlinked=1)
    assert _refused(view)


def test_none_when_spans_and_ranges_differ_in_count(tracer):
    view = synthetic(tracer)
    view.host_spans.pop()
    assert _refused(view)


def test_none_when_the_engine_calls_and_ranges_differ_in_count(tracer):
    view = synthetic(tracer)
    view.ranges["engine.call"].append((view.ranges["engine.call"][-1][1] +
                                       5_000.0,) * 2)
    view.host_spans.append(harness.HostSpan("engine.call", T0 + 0.04,
                                            T0 + 0.04, True))
    assert _refused(view)


def test_none_when_an_engine_span_leaves_its_call(tracer):
    late = 303 + 2 + ps.TOLERANCE_US + 1        # past its range's end
    assert _refused(synthetic(tracer, engine_end_us=late))


def test_none_when_a_launch_lands_in_no_child(tracer):
    stray = 300 + ps.TOLERANCE_US + 1             # past the epilogue's end
    view = synthetic(tracer, call_end_us=stray + 10,
                     extra=[(stray, "stray", 5.0)])
    assert _refused(view)


def test_none_when_the_tracer_dropped_spans(tracer):
    view = synthetic(tracer)
    assert ps.split(view) is not None
    tracer.dropped = 1
    assert _refused(dataclasses.replace(view))


def test_none_without_the_programs_spans(tracer):
    """The parent program records no ``sig.*`` span."""
    tracer.reset()
    view = synthetic(tt.Tracer(enabled=True))       # spans elsewhere
    assert _refused(view)


def test_none_where_the_export_names_another_clock(tracer, monkeypatch):
    view = synthetic(tracer)
    monkeypatch.setattr(tracer, "to_json", lambda: {
        "traceEvents": tracer.events(), "displayTimeUnit": "ms"})
    assert _refused(view)


def _profiled_view(recording: bool, monkeypatch, tracer):
    if not recording:
        monkeypatch.setattr(tracer, "recording", lambda: False)
    cell = tiny("preprocess.webspam-2u", trace_seconds=0.25)
    ctx = harness.Ctx(cell, seed=2**31 + 21, seconds=0.3, trace=True,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter())
    outcome = cell.driver.run(ctx)
    monkeypatch.undo()
    return ctx, outcome, ctx.trace_view(outcome.work)


def test_engine_spans_leave_the_profiled_trace_as_it_was(monkeypatch):
    tracer = tt.Tracer()
    prev = tt.set_tracer(tracer)
    try:
        ctx_on, out_on, on = _profiled_view(True, monkeypatch, tracer)
        recorded = {e["name"] for e in tracer.events()}
        tracer.reset()
        ctx_off, out_off, off = _profiled_view(False, monkeypatch, tracer)
        assert tracer.events() == []
    finally:
        tt.set_tracer(prev)
    assert recorded == {"sig.engine", "sig.plan", "sig.counts",
                        "sig.kernel"}
    assert out_on.correct and out_off.correct
    # in both runs the ranges are the benchmark's profiled spans, one for
    # one (which of them the window reaches depends on timing)
    for view, ctx in ((on, ctx_on), (off, ctx_off)):
        profiled = [s.name for s in ctx.spans if s.profiled]
        assert set(view.ranges) == set(profiled) | {"bench.window"}
        for name, spans in view.ranges.items():
            if name != "bench.window":
                assert len(spans) == profiled.count(name)
    assert "engine.call" in on.ranges and "engine.call" in off.ranges
    assert on.device == off.device == [] and on.unlinked == off.unlinked == 0
    # no device here: the readers read nothing, and raise nothing
    assert all(harness.reader(m)(on) is None for m in READERS)
