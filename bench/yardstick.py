"""The yardstick: least work of the benchmark's kernels and the H100's
peaks, frozen here so that no change to the program can move it.

A copy of ``chip_smoke.py``'s ``bound``, ``minhash_ops``,
``minhash_bytes``, ``oph_ops``, ``oph_bytes``, ``match_ops`` and
``match_bytes`` with their ``OPS_*`` constants, as they stood when the
benchmark was defined (``bench/tests/test_port_bench_yardstick.py`` holds the
two equal on the cells' shapes).  Every roofline share and every ``mfu``
the benchmark reports takes its least time from these counts, so the
same work has the same least time whatever implements it.

Published H100 SXM rates (NVIDIA data sheet; full 700 W power limit):
HBM3 at 3.35 TB/s, and 67 TFLOP/s float32 outside the tensor cores,
i.e. 33.5e12 lane-instructions/s (128 lanes per SM, an FMA counted once)
-- the dispatch rate that also bounds 32-bit integer instructions.

The least 32-bit lane-instructions each function needs, in sm_90 SASS
forms.  2U hash: one IMAD (a1 + a2*t, mod 2^32); variant high's shift
keeps the order of values, min(v >> x) == (min v) >> x, so minhash needs
it once per (row, j) and OPH, which splits every value, once per
nonzero.  4U hash by Horner (OPH, one evaluation per nonzero): three
steps of 6 -- IMAD.WIDE.U32, two folds of LOP3 + LEA.HI, one
VIADDMNMX.U32 -- then the s-bit mask.  4U minhash shares the powers of t
across its k functions: per nonzero, t^2 and t^3 mod p, two BitMod
products of 6; per (nonzero, j), three IMAD.WIDE.U32 chained into one
64-bit sum, its reduction (``OPS_REDUCE4``: fold 1 in 64 bits as LOP3,
SHF.R.U64, IADD3, LEA.HI.X; fold 2 as LOP3 + LEA.HI; one VIADDMNMX.U32),
and the s-bit mask.  Minhash's running min takes half a VIMNMX3 per
(nonzero, j); its epilogue the b-bit mask and, packed, one IMAD per
code.  OPH takes bin, offset, the bin's shared address and the atomicMin
per nonzero, and three per bin to write sentinel codes.

Packed match, per (query, doc, word) when code_bits | 32: the zero-field
test of x = q ^ c in three LOP3 and one add, and one LEA.HI folding the
flag bits ahead of one POPC and one add per code_bits words.  Straddling
codes, per (query, doc, code): one ISETP and one predicated IADD (a
second pair on sentinel wires); pulling a code out of its word pair is
per (row, code).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

OPS_2U, OPS_SHIFT, OPS_4U = 1, 1, 3 * 6 + 1
OPS_REDUCE4 = 7
OPS_MH4U_EVAL, OPS_MH4U_STAGE = 3 + OPS_REDUCE4 + 1, 2 * 6
OPS_MIN, OPS_SCATTER, OPS_CODE = 0.5, 4, 3
OPS_MATCH_WORD, OPS_MATCH_CODE, OPS_MATCH_CODE_SENT, OPS_EXTRACT = 5, 2, 4, 2


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes at
    the HBM rate and the operations at the lane-instruction rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def oph_ops(nonzeros: int, n: int, k: int, four_u: bool, code_b: int) -> float:
    per_nz = OPS_4U if four_u else OPS_2U + OPS_SHIFT
    return nonzeros * (per_nz + OPS_SCATTER) + n * k * (OPS_CODE if code_b else 0)


def minhash_ops(nonzeros: int, n: int, k: int, four_u: bool, b: int,
                pack: bool) -> float:
    """2U in either variant (both shift once per (row, j)); 4U as a sum
    of powers shared across the k functions."""
    per_eval = (OPS_MH4U_EVAL if four_u else OPS_2U) + OPS_MIN
    per_nz = OPS_MH4U_STAGE if four_u else 0
    per_out = (0 if four_u else OPS_SHIFT) + (b > 0) + pack
    return nonzeros * (k * per_eval + per_nz) + n * k * per_out


def match_ops(nq: int, nc: int, k: int, code_bits: int,
              sentinel: bool) -> float:
    """Least lane-instructions of one packed-match call."""
    if 32 % code_bits == 0:
        words = (k * code_bits + 31) // 32
        return nq * nc * words * OPS_MATCH_WORD
    per_code = OPS_MATCH_CODE_SENT if sentinel else OPS_MATCH_CODE
    return nq * nc * k * per_code + (nq + nc) * k * OPS_EXTRACT


def minhash_bytes(nonzeros: int, n: int, k: int, four_u: bool,
                  pack_b: int = 0) -> float:
    """Indices and row counts read once, the coefficients read once, the
    (n, k) codes written once, and the packed words when ``pack_b``."""
    return (4 * nonzeros + 4 * n + 4 * k * (4 if four_u else 2) + 4 * n * k
            + n * k * pack_b // 8)


def oph_bytes(nonzeros: int, n: int, k: int, four_u: bool) -> float:
    """Indices and row counts read once, the one function's coefficients,
    the (n, k) bins written once."""
    return 4 * nonzeros + 4 * n + 4 * (4 if four_u else 2) + 4 * n * k


def match_bytes(nq: int, nc: int, words: int, sentinel: bool) -> float:
    """Query and corpus words read once, the count outputs written once."""
    return 4 * (nq + nc) * words + 4 * nq * nc * (2 if sentinel else 1)


def minhash_least_ms(nonzeros: int, n: int, k: int, four_u: bool,
                     b: int) -> float:
    """Least ms of one packed minhash chunk: ``n`` rows holding
    ``nonzeros`` in all, k functions, b-bit codes packed."""
    return bound(minhash_bytes(nonzeros, n, k, four_u, pack_b=b),
                 minhash_ops(nonzeros, n, k, four_u, b, pack=True))[0]
