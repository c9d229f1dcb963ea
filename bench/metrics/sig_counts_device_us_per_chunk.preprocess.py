"""Device time launched under the engine's ``sig.counts`` spans (the
batch's row counts, ``SparseBatch.nnz_per_row``), per traced engine call
(us)."""

from bench.program_spans import split


def read(view):
    parts = split(view)
    return None if parts is None else parts.per_call("sig.counts")
