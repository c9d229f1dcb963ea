"""The reference agrees with the program's plain CPU path at tiny sizes
(the program is imported here, by the test, never by the reference)."""

import numpy as np
import pytest
import torch

from bench import generator as gen
from bench import reference as ref
from repro_torch.core.bbit import pack_codes
from repro_torch.core.u32 import from_numpy, widen
from repro_torch.kernels.minhash import minhash2u_plain, minhash4u_plain


def batch(seed, n, low, high, D):
    data = gen.SetStream(seed, 0, n, D, [low, high])
    rows = torch.arange(n)
    idx, mask, lengths = gen.padded(data.ids(rows), data.lengths(rows))
    return data.ids(rows), idx, mask, lengths


@pytest.mark.parametrize("family", ["2u", "4u"])
@pytest.mark.parametrize("b", [0, 1, 8])
def test_minhash_codes_match_the_plain_kernels(family, b):
    s, D, k = 24, 16_609_143, 40
    ids, idx, mask, lengths = batch(3, 50, 0, 90, D)
    coef = gen.coefficients(3, 0, family, k)
    counts = lengths.to(torch.int32)
    if family == "2u":
        got = minhash2u_plain(idx, counts, from_numpy(coef["a1"], "cpu"),
                              from_numpy(coef["a2"], "cpu"), s=s, b=b)
        want = ref.minhash_codes(ids, lengths, "2u",
                                 (coef["a1"], coef["a2"]), s, b or 32)
    else:
        got = minhash4u_plain(idx, counts, from_numpy(coef["a"], "cpu"), s=s,
                              b=b)
        want = ref.minhash_codes(ids, lengths, "4u", coef["a"], s, b or 32)
    assert torch.equal(widen(got), want)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_matches_the_wire(bits):
    codes = torch.randint(0, 1 << bits, (7, 64), dtype=torch.int64)
    got = pack_codes(codes.to(torch.int32), bits)
    assert torch.equal(widen(got), ref.pack(codes, bits))


def test_rows_differing():
    a = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    assert ref.rows_differing(a, a.to(torch.int64)) == 0
    assert ref.rows_differing(a, torch.tensor([[1, 2], [3, 5]])) == 1
    assert ref.rows_differing(a, np.array([[1, 2]], np.uint32)) == 2
