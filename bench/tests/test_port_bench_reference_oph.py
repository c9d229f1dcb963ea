"""The OPH reference (``bench/reference_oph.py``) against a per-row loop
written from the definition and against the program's plain CPU path at
a small size (the program is imported here, by the test, never by the
reference), and the OPH yardstick's least time against a hand count."""

import numpy as np
import pytest
import torch

from bench import generator as gen
from bench import reference as ref
from bench import reference_oph as ref_oph
from bench import yardstick as ys
from bench import yardstick_oph as yo

M32 = (1 << 32) - 1


def loop_codes(ids, a1, a2, s, k, b):
    """One row's b-bit codes, bin by bin, from the definition."""
    W = (1 << s) // k
    bins = [None] * k
    for t in set(ids):
        h = ((a1 + a2 * t) & M32) >> (32 - s)
        j, off = divmod(h, W)
        if bins[j] is None or off < bins[j]:
            bins[j] = off
    out = []
    for j in range(k):
        if bins[j] is not None:
            v = bins[j]
        elif all(x is None for x in bins):
            v = M32
        else:
            d = 1
            while bins[(j + d) % k] is None:
                d += 1
            v = (bins[(j + d) % k] + d * (W + 1)) & M32
        out.append(v & ((1 << b) - 1))
    return out


def padded_rows(rows):
    """Lists of ids -> (ids (n, width) int64, lengths), padding lanes
    holding ids that would land in bin 0 if they were counted."""
    width = max(1, max(len(r) for r in rows))
    ids = torch.zeros((len(rows), width), dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r, dtype=torch.int64)
    return ids, torch.tensor([len(r) for r in rows], dtype=torch.int64)


# s = 8, k = 16: bins 16 wide.  Under a1 = 0, a2 = 2^24 the hash of t <
# 2^8 is t itself, so bin t // 16 and offset t % 16 are chosen by hand.
S, K = 8, 16
IDENTITY = (0, 1 << (32 - S))
HAND_ROWS = {
    "many empty bins": [3, 85, 90, 250],
    "donor only past bin k - 1": [40, 47],            # bin 2 alone
    "donor at the last bin": [255, 17],               # bins 15 and 1
    "one nonzero": [200],
    "full": list(range(0, 256, 16)) + list(range(7, 256, 16)),
    "repeated ids": [5, 5, 5, 99, 99, 130, 5],
    "no nonzero": [],
}


@pytest.mark.parametrize("name", sorted(HAND_ROWS))
@pytest.mark.parametrize("b", [1, 8, 32])
def test_hand_rows_match_the_definition(name, b):
    row = HAND_ROWS[name]
    ids, lengths = padded_rows([row])
    got = ref_oph.oph_codes(ids, lengths, *IDENTITY, S, K, b)
    assert got[0].tolist() == loop_codes(row, *IDENTITY, S, K, b)


def test_hand_rows_have_the_bins_they_were_built_for():
    ids, lengths = padded_rows(list(HAND_ROWS.values()))
    bins = ref_oph.oph_bins(ids, lengths, *IDENTITY, S, K)
    empty = (bins == ref_oph.EMPTY).sum(dim=1).tolist()
    assert dict(zip(HAND_ROWS, empty)) == {
        "many empty bins": 13, "donor only past bin k - 1": 15,
        "donor at the last bin": 14, "one nonzero": 15, "full": 0,
        "repeated ids": 13, "no nonzero": 16}
    # bin 2 alone: bins 0 and 1 find it only by wrapping past bin 15
    bins2 = ref_oph.densify_rotation(bins[1:2], 16)[0].tolist()
    assert bins2[2] == 8 and bins2[1] == 8 + 1 * 17 and \
        bins2[0] == 8 + 2 * 17 and bins2[3] == 8 + 15 * 17


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**40 + 3])
def test_random_rows_match_the_definition(seed):
    """Generator rows (0 to 700 nonzeros in 512 bins) under drawn
    functions at s = 24, one function a row."""
    s, k, b, n = 24, 512, 8, 12
    data = gen.SetStream(seed, 0, n, 1 << s, [0, 300, 700])
    rows = torch.arange(n)
    ids, lengths = data.ids(rows), data.lengths(rows)
    coef = [gen.coefficients(seed, p, "2u", 1) for p in range(n)]
    a1 = torch.tensor([int(c["a1"][0]) for c in coef])
    a2 = torch.tensor([int(c["a2"][0]) for c in coef])
    got = ref_oph.oph_codes(ids, lengths, a1, a2, s, k, b)
    for i in range(n):
        row = ids[i, :int(lengths[i])].tolist()
        assert got[i].tolist() == loop_codes(row, int(a1[i]), int(a2[i]), s,
                                             k, b)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**45 + 1])
def test_packed_words_match_the_programs_plain_path(seed):
    """The port's CPU engine, OPH with rotation over one 2U function, k =
    64, s = 12, b = 8, packed, on rows of 0 to 90 nonzeros."""
    from repro_torch.core.hashing import Hash2U
    from repro_torch.core.oph import OPH
    from repro_torch.data.sparse import SparseBatch
    from repro_torch.kernels.engine import SignatureEngine
    s, k, b, n = 12, 64, 8, 200
    data = gen.SetStream(seed, 0, n, 1 << s, [0, 40, 90])
    idx, mask, lengths = data.batch(0, n, "cpu")
    coef = gen.coefficients(seed, 0, "2u", 1)
    fam = OPH(Hash2U.from_numpy(coef["a1"], coef["a2"], s, device="cpu"),
              k=k, densify="rotation")
    got = SignatureEngine(fam, b=b, packed=True).packed_signatures(
        SparseBatch(idx, mask)).data
    codes = ref_oph.oph_codes(data.ids(torch.arange(n)), lengths, coef["a1"],
                              coef["a2"], s, k, b)
    assert torch.equal(ref.as_words(got), ref.pack(codes, b))
    bins = ref_oph.oph_bins(data.ids(torch.arange(n)), lengths, coef["a1"],
                            coef["a2"], s, k)
    assert (bins == ref_oph.EMPTY).any()        # the rotation had work


def test_blocks_give_the_same_codes(monkeypatch):
    data = gen.SetStream(5, 0, 40, 1 << 24, [10, 200])
    rows = torch.arange(40)
    ids, lengths = data.ids(rows), data.lengths(rows)
    whole = ref_oph.oph_codes(ids, lengths, 12345, 678901, 24, 512, 8)
    monkeypatch.setattr(ref_oph, "BLOCK_ELEMS", ids.shape[1] * 3)
    assert torch.equal(ref_oph.oph_codes(ids, lengths, 12345, 678901, 24,
                                         512, 8), whole)


def test_least_time_of_the_cells_chunk_is_its_bytes():
    """10,000 rows at the mean's 3,728 nonzeros, k = 512, b = 8: ids and
    counts read once, two coefficients, 128 packed words a row."""
    nz, n = 10_000 * 3_728, 10_000
    nbytes = 4 * nz + 4 * n + 8 + n * 128 * 4
    assert yo.oph_packed_bytes(nz, n, 512, 8) == nbytes == 154_280_008
    ms, by = ys.bound(nbytes, ys.oph_ops(nz, n, 512, False, 8))
    assert by == "bytes"
    assert yo.oph_least_ms(nz, n, 512, 8) == ms == \
        nbytes / ys.HBM_BYTES_PER_S * 1e3
    assert np.isclose(ms, 0.046054, atol=1e-6)
