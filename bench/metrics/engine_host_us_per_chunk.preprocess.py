"""Host time of one ``SignatureEngine.packed_signatures`` call, enqueue
only (us, mean over the window's chunks): the benchmark's host clock
around the call, outside the profiled part of the window where there is
one, so the profiler's own cost is left out."""


def read(view):
    spans = [s for s in view.host_spans if s.name == "engine.call"]
    quiet = [s for s in spans if not s.profiled] or spans
    if not quiet:
        return None
    return sum(s.t1 - s.t0 for s in quiet) / len(quiet) * 1e6
