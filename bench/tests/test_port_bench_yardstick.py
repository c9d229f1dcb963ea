"""The frozen counts equal ``chip_smoke.py``'s on the cells' shapes and
on the rcv1 search shapes that PERF.md keeps for a later cell."""

import pytest

import chip_smoke
from bench import yardstick as ys

NZ_WEBSPAM = 10_000 * 3_728        # a webspam chunk's nonzeros at the mean
NZ_RCV1 = 1_024 * 12_062           # 1,024 rcv1 documents at the mean


@pytest.mark.parametrize("four_u", [False, True])
@pytest.mark.parametrize("b,pack", [(0, False), (8, False), (8, True)])
@pytest.mark.parametrize("k", [200, 500, 512])
def test_minhash_counts_equal_chip_smoke(four_u, b, pack, k):
    args = (NZ_WEBSPAM, 10_000, k, four_u)
    assert ys.minhash_ops(*args, b, pack) == chip_smoke.minhash_ops(
        *args, b, pack)
    assert ys.minhash_bytes(*args, b) == chip_smoke.minhash_bytes(*args, b)


@pytest.mark.parametrize("four_u", [False, True])
@pytest.mark.parametrize("code_b", [0, 8])
def test_oph_counts_equal_chip_smoke(four_u, code_b):
    args = (NZ_RCV1, 1_024, 512, four_u)
    assert ys.oph_ops(*args, code_b) == chip_smoke.oph_ops(*args, code_b)
    assert ys.oph_bytes(*args) == chip_smoke.oph_bytes(*args)


@pytest.mark.parametrize("nq,nc", [(256, 4_096), (1_024, 4_096),
                                   (1_024, 677_399), (256, 677_399)])
@pytest.mark.parametrize("code_bits,sentinel", [(8, False), (9, False),
                                                (9, True)])
def test_match_counts_equal_chip_smoke(nq, nc, code_bits, sentinel):
    words = (512 * code_bits + 31) // 32
    assert ys.match_ops(nq, nc, 512, code_bits, sentinel) == \
        chip_smoke.match_ops(nq, nc, 512, code_bits, sentinel)
    assert ys.match_bytes(nq, nc, words, sentinel) == \
        chip_smoke.match_bytes(nq, nc, words, sentinel)


@pytest.mark.parametrize("nbytes,ops", [(1e9, 1e12), (1e12, 1e9), (0, 0)])
def test_bound_and_peaks_equal_chip_smoke(nbytes, ops):
    assert ys.bound(nbytes, ops) == chip_smoke.bound(nbytes, ops)
    assert (ys.HBM_BYTES_PER_S, ys.INT32_OPS_PER_S) == \
        (chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT32_OPS_PER_S) == \
        (3.35e12, 33.5e12)


@pytest.mark.parametrize("four_u,table_ms", [(True, 6.4114), (False, 0.8348)])
def test_kernel_table_bounds(four_u, table_ms):
    """PERF.md's kernel table: 10,000 rows at webspam width, k = 500,
    b = 8, unpacked (phase 2's chunk held 37.27 M nonzeros, the mean
    37.28 M)."""
    ms, by = ys.bound(ys.minhash_bytes(NZ_WEBSPAM, 10_000, 500, four_u),
                      ys.minhash_ops(NZ_WEBSPAM, 10_000, 500, four_u, 8,
                                     False))
    assert by == "operations"
    assert abs(ms - table_ms) / table_ms < 2e-4


def test_match_table_bound():
    """The kernel table's 3.3130 ms: 256 queries against the corpus."""
    for nc, table_ms in [(677_399, 3.3130), (4_096, 0.0200)]:
        ms, by = ys.bound(ys.match_bytes(256, nc, 128, False),
                          ys.match_ops(256, nc, 512, 8, False))
        assert by == "operations" and round(ms, 4) == table_ms
