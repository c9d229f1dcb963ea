"""Least time of the traced chunks' signature work (the frozen
``minhash_ops`` / ``minhash_bytes``, packed) over the device time
launched under the engine calls that hashed them (%)."""

from bench.yardstick import minhash_least_ms


def read(view):
    w, launched = view.work, view.under("engine.call")
    if not w.get("rows") or launched is None:
        return None
    device_us = sum(d for _, d in launched)
    if device_us <= 0:
        return None
    least_ms = sum(minhash_least_ms(nz, n, w["k"], w["four_u"], w["b"])
                   for n, nz in zip(w["rows"], w["nonzeros"]))
    return 100.0 * least_ms * 1e3 / device_us
