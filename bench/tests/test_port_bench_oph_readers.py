"""The OPH cell's three readers on a synthetic trace: the kernel's share
of the chunk's bound under ``sig.kernel``, the window's ``mfu``, and the
device time under the epilogue's ``sig.densify`` child; each case in
which the span readers read None; and a CPU-profiled run of the OPH
driver, whose engine records the densify and pack spans."""

import dataclasses
import time

import pytest
import torch

from bench import harness
from bench import program_spans as ps
from bench.yardstick_oph import oph_least_ms
from conftest import tiny
from repro_torch.obs import trace as tt

CELL = "preprocess.webspam-oph2u"
OFFSET_US = -45_678.5           # profiler us less perf-counter us
T0 = 80.0                       # perf-counter seconds of the first call
# a call's children and the epilogue's (us from the engine.call span's
# start), and what each launches: (us from the start, kernel, device us)
CHILD_US = {"sig.plan": (3, 9), "sig.counts": (10, 40),
            "sig.kernel": (41, 90), "sig.epilogue": (91, 300)}
EPILOGUE_US = {"sig.densify": (92, 250), "sig.pack": (251, 299)}
LAUNCHES = [(25, "reduce", 60.0), (70, "oph2u_kernel", 57.0),
            (120, "cummin", 100.0), (200, "gather", 150.0),
            (260, "pack_or", 30.0), (290, "mul", 10.0)]
WORK = {"k": 512, "b": 8, "four_u": False, "rows": [10_000] * 3,
        "nonzeros": [37_280_000] * 3}
KERNEL = "oph_kernel_roofline_share.preprocess_oph"
MFU = "mfu.preprocess_oph"
DENSIFY = "oph_densify_device_us_per_chunk.preprocess_oph"
SPAN_READERS = (KERNEL, DENSIFY)


@pytest.fixture
def tracer():
    mine = tt.Tracer(enabled=True)
    prev = tt.set_tracer(mine)
    try:
        yield mine
    finally:
        tt.set_tracer(prev)


def synthetic(tracer, calls=3, epilogue_kids=EPILOGUE_US, extra=()):
    """``calls`` engine calls 10 ms apart, as the OPH engine records them:
    the tracer's spans, the benchmark's host spans, and a ``TraceView``
    whose ranges open 2 us before and close 2 us after them on the
    profiler's clock; ``extra``: more launches in every call."""
    host, ranges, launched = [], [], []
    for i in range(calls):
        t = T0 + 0.01 * i
        us = lambda off: t + off * 1e-6
        eng = tracer.start_span("sig.engine", t0=us(2),
                                args={"scheme": "oph2u",
                                      "densify": "rotation"})
        for name, (a, b) in CHILD_US.items():
            sp = tracer.start_span(name, t0=us(a), parent=eng)
            if name == "sig.epilogue":
                for kid, (c, d) in epilogue_kids.items():
                    tracer.add_span(kid, us(c), us(d), parent=sp)
            tracer.end_span(sp, t1=us(b))
        tracer.end_span(eng, t1=us(301))
        host.append(harness.HostSpan("engine.call", t, us(303), True))
        ranges.append((t * 1e6 + OFFSET_US - 2,
                       us(303) * 1e6 + OFFSET_US + 2))
        for off, name, dur in list(LAUNCHES) + list(extra):
            launched.append((us(off) * 1e6 + OFFSET_US, name, dur))
    device = [(name, t, t + dur) for t, name, dur in launched]
    lo, hi = ranges[0][0] - 10, ranges[-1][1] + 10
    return harness.TraceView(
        window=(lo, hi), ranges={"engine.call": ranges,
                                 "bench.window": [(lo, hi)]},
        device=device, launched=sorted(launched), host_spans=host,
        work=dict(WORK))


def test_the_readers_on_an_oph_trace(tracer):
    view = synthetic(tracer)
    split = ps.split(view)
    assert split.device_us == pytest.approx(
        {"sig.plan": 0.0, "sig.counts": 180.0, "sig.kernel": 171.0,
         "sig.epilogue": 870.0})
    least_ms = 3 * oph_least_ms(37_280_000, 10_000, 512, 8)
    read = {m: harness.reader(m)(view) for m in (KERNEL, MFU, DENSIFY)}
    assert read == pytest.approx({
        KERNEL: 100.0 * least_ms * 1e3 / 171.0,
        MFU: 100.0 * least_ms * 1e-3 / view.window_s,
        DENSIFY: 250.0})
    # the densifier's part of the epilogue, the rest the pack's
    assert read[DENSIFY] <= split.per_call("sig.epilogue")


def test_a_launch_just_past_the_densify_edge_goes_to_it(tracer):
    view = synthetic(tracer, extra=[(250.4, "late", 7.0)])
    assert harness.reader(DENSIFY)(view) == pytest.approx(257.0)


def _refused(view):
    return all(harness.reader(m)(view) is None for m in SPAN_READERS)


def test_none_when_an_activity_is_unlinked(tracer):
    assert _refused(dataclasses.replace(synthetic(tracer), unlinked=1))


def test_none_when_the_tracer_dropped_spans(tracer):
    view = synthetic(tracer)
    assert harness.reader(DENSIFY)(view) is not None
    tracer.dropped = 1
    assert _refused(dataclasses.replace(view))


def test_none_when_spans_and_ranges_differ_in_count(tracer):
    view = synthetic(tracer)
    view.host_spans.pop()
    assert _refused(view)


def test_none_on_a_program_without_the_densify_span(tracer):
    """The parent's epilogue records no child: the densify reader reads
    None, the kernel's share reads as before."""
    view = synthetic(tracer, epilogue_kids={})
    assert harness.reader(DENSIFY)(view) is None
    assert harness.reader(KERNEL)(view) == pytest.approx(
        100.0 * 3 * oph_least_ms(37_280_000, 10_000, 512, 8) * 1e3 / 171.0)


def test_none_when_an_epilogue_launch_lies_in_no_child(tracer):
    """Densify ends at 200 and the pack starts at 251: the launch at 230
    lies in the epilogue and in neither of its children."""
    view = synthetic(tracer, epilogue_kids={"sig.densify": (92, 200),
                                            "sig.pack": (251, 299)},
                     extra=[(230, "stray", 5.0)])
    assert ps.split(view) is not None
    assert harness.reader(DENSIFY)(view) is None


def test_the_driver_records_densify_and_pack_under_a_profiler():
    """A CPU-profiled run of the OPH cell: the engine's spans come with
    the epilogue's two children; no device, so every reader of the
    device's trace reads None and none raises."""
    tracer = tt.Tracer()
    prev = tt.set_tracer(tracer)
    try:
        cell = tiny(CELL, trace_seconds=0.25)
        ctx = harness.Ctx(cell, seed=2**31 + 23, seconds=0.3, trace=True,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter())
        outcome = cell.driver.run(ctx)
        view = ctx.trace_view(outcome.work)
        events = tracer.events()
    finally:
        tt.set_tracer(prev)
    assert outcome.correct
    assert {e["name"] for e in events} == {
        "sig.engine", "sig.plan", "sig.counts", "sig.kernel", "sig.epilogue",
        "sig.densify", "sig.pack"}
    assert all(e["args"]["densify"] == "rotation" for e in events
               if e["name"] == "sig.engine")
    assert view.device == []
    assert all(harness.reader(m["name"])(view) is None
               for m in cell.per_layer if m["source"] == "device_trace")
