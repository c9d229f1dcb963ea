"""Least time of one packed OPH chunk, the same whatever implements it,
on the frozen counts and peaks of ``bench/yardstick.py``.

Bytes: the ids and the row counts read once, the one 2U function's two
coefficients, and the packed codes written once, ``4 nonzeros + 4 n + 8
+ n k b / 8``.  Operations: the frozen ``oph_ops(nonzeros, n, k, False,
b)`` -- hash, shift and scatter a nonzero, and three a bin for its code.
The densification's few operations a bin are not counted: at webspam's
shapes the bytes bound a chunk six times over the operations, so they
would not move the bound.
"""

from bench.yardstick import bound, oph_ops


def oph_packed_bytes(nonzeros: int, n: int, k: int, b: int) -> int:
    """Ids and counts read once, two coefficients, packed words written."""
    return 4 * nonzeros + 4 * n + 8 + n * k * b // 8


def oph_least_ms(nonzeros: int, n: int, k: int, b: int) -> float:
    """Least ms of ``n`` rows holding ``nonzeros`` in all, k bins of one
    2U function, b-bit codes packed."""
    return bound(oph_packed_bytes(nonzeros, n, k, b),
                 oph_ops(nonzeros, n, k, False, b))[0]
