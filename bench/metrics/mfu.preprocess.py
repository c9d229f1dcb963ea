"""The whole traced window's share of the chip's peak: least time of the
signature work it hashed (the frozen ``minhash_ops`` / ``minhash_bytes``,
packed) over its wall time (%)."""

from bench.yardstick import minhash_least_ms


def read(view):
    w = view.work
    if not w.get("rows") or view.window_s <= 0 or not view.device:
        return None
    least_ms = sum(minhash_least_ms(nz, n, w["k"], w["four_u"], w["b"])
                   for n, nz in zip(w["rows"], w["nonzeros"]))
    return 100.0 * least_ms * 1e-3 / view.window_s
