"""Least time of the traced chunks' signature work (the frozen
``minhash_ops`` / ``minhash_bytes``, packed) over the device time
launched under the engine's ``sig.kernel`` spans alone: the kernel's
share of its bound, without the engine's row counts and epilogue (%)."""

from bench.program_spans import split
from bench.yardstick import minhash_least_ms


def read(view):
    w, parts = view.work, split(view)
    if not w.get("rows") or parts is None:
        return None
    device_us = parts.device_us["sig.kernel"]
    if device_us <= 0:
        return None
    least_ms = sum(minhash_least_ms(nz, n, w["k"], w["four_u"], w["b"])
                   for n, nz in zip(w["rows"], w["nonzeros"]))
    return 100.0 * least_ms * 1e3 / device_us
