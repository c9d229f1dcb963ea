"""Device time launched under the engine's ``sig.densify`` spans (the OPH
epilogue's densifier and b-bit mask, children of ``sig.epilogue``), per
traced engine call (us).

Each launch that ``bench.program_spans.split`` gives to an engine call's
``sig.epilogue`` goes to the child of that epilogue open at its launch,
else the nearest within ``TOLERANCE_US``, on the same clock offset.
None wherever ``split`` is None, where the traced calls recorded no
``sig.densify`` (a program without the span), and where such a launch
lies in no child of its epilogue."""

import bisect

from bench.program_spans import (CALL, CHILDREN, ENGINE, TOLERANCE_US,
                                 _nearest, split, tracer_spans)

EPILOGUE = "sig.epilogue"
PARTS = ("sig.densify", "sig.pack")


def read(view):
    parts = split(view)
    spans = tracer_spans() if parts is not None else None
    if spans is None:
        return None
    off = parts.offset_us
    ranges = view.ranges[CALL]
    lo, hi = ranges[0][0] - TOLERANCE_US, ranges[-1][1] + TOLERANCE_US
    # the engine spans ``split`` paired one to one with the calls' ranges
    engines = [sid for _, sid in sorted(
        (t0 + off, sid) for name, sid, _, t0, t1 in spans
        if name == ENGINE and t1 + off >= lo and t0 + off <= hi)]
    kids = {sid: [] for sid in engines}
    grand = {sid: [] for sid in engines}
    engine_of = {}                  # an epilogue's span id -> its engine's
    for name, sid, parent, t0, t1 in spans:
        if parent in kids and name in CHILDREN:
            kids[parent].append((name, t0 + off, t1 + off))
            if name == EPILOGUE:
                engine_of[sid] = parent
    for name, _, parent, t0, t1 in spans:
        if parent in engine_of and name in PARTS:
            grand[engine_of[parent]].append((name, t0 + off, t1 + off))
    if not any(name == PARTS[0] for g in grand.values() for name, _, _ in g):
        return None
    starts = [r0 for r0, _ in ranges]
    densify_us = 0.0
    for t, _, dur in view.launched:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > ranges[i][1]:
            continue
        sid = engines[i]
        if _nearest(kids[sid], t) != EPILOGUE:
            continue
        part = _nearest(grand[sid], t)
        if part is None:
            return None
        if part == PARTS[0]:
            densify_us += dur
    return densify_us / parts.calls
