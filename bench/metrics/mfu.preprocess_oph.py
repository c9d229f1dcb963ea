"""The whole traced window's share of the chip's peak: least time of the
packed OPH work it hashed (``bench/yardstick_oph.py``) over its wall
time (%)."""

from bench.yardstick_oph import oph_least_ms


def read(view):
    w = view.work
    if not w.get("rows") or view.window_s <= 0 or not view.device:
        return None
    least_ms = sum(oph_least_ms(nz, n, w["k"], w["b"])
                   for n, nz in zip(w["rows"], w["nonzeros"]))
    return 100.0 * least_ms * 1e-3 / view.window_s
