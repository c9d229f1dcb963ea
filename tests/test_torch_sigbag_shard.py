"""The row-shard ``sigbag`` (``kernels.sigbag`` with ``row0``): a table
of rows [row0, row0 + rows) of the whole 2^b axis, a token adding its
row there only.  The plain version against ``sigbag_plain`` of the whole
table, for M in {1, 2, 4, 8} shards, tokens -1, 2^b and 2^31 - 1 mixed
in:

  * each shard's bag == the whole table's bag with the rows outside the
    shard zeroed, bit for bit (adding +0 to a float32 sum is exact);
  * on a table of multiples of 2^-12 in [-1, 1] (float32 sums exact in
    any order) the M partial bags summed == the whole bag, bit for bit;
  * each shard's table gradient == rows [row0, row0 + rows) of the whole
    gradient, bit for bit (a gradient of multiples of 2^-8);
  * ``_SigbagFunction`` with ``row0`` passes ``gradcheck`` in float64.

The kernel's own twin of the dispatch rule (``staged_plan``) plans from
the shard's rows: a slot slice too large to stage whole stages in
shards.  The CUDA entry (``sigbag_shard_launch``) is held against this
plain version on the card (``chip_smoke.py`` phase 15).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.sigbag import (_SigbagFunction, sigbag, sigbag_cuda,
                                        sigbag_plain, sigbag_table_grad,
                                        staged_plan)

SHARDS = (1, 2, 4, 8)
EDGE_TOKENS = (-1, None, 2**31 - 1)     # None: 2^b


def _tokens(rng, n, k, two_b):
    tok = rng.integers(0, two_b, (n, k)).astype(np.int32)
    for i, t in enumerate(EDGE_TOKENS):
        tok[i::7, (3 * i) % k] = two_b if t is None else t
    return torch.from_numpy(tok)


def _dyadic(rng, shape):
    """Multiples of 2^-12 in [-1, 1]."""
    return torch.from_numpy(
        (rng.integers(-4096, 4097, shape) / 4096.0).astype(np.float32))


def _shards(m, two_b):
    rows = two_b // m
    return [(r * rows, rows) for r in range(m)]


@pytest.mark.parametrize("m", SHARDS)
def test_each_shard_is_the_whole_bag_of_its_rows(m):
    rng = np.random.default_rng(m)
    k, two_b, d, n = 9, 32, 5, 200
    table = torch.from_numpy(rng.standard_normal((k, two_b, d)).astype(
        np.float32))
    tok = _tokens(rng, n, k, two_b)
    for row0, rows in _shards(m, two_b):
        masked = torch.zeros_like(table)
        masked[:, row0:row0 + rows] = table[:, row0:row0 + rows]
        got = sigbag_plain(tok, table[:, row0:row0 + rows].contiguous(),
                           row0)
        assert torch.equal(got, sigbag_plain(tok, masked)), row0
        assert torch.equal(got, sigbag(tok, table[:, row0:row0 + rows],
                                       row0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", SHARDS)
def test_partials_sum_to_the_whole_on_a_dyadic_table(m, dtype):
    rng = np.random.default_rng(10 + m)
    k, two_b, d, n = 16, 64, 8, 300
    table = _dyadic(rng, (k, two_b, d)).to(dtype)
    tok = _tokens(rng, n, k, two_b)
    whole = sigbag_plain(tok, table)
    parts = [sigbag_plain(tok, table[:, r0:r0 + rows], r0).float()
             for r0, rows in _shards(m, two_b)]
    total = torch.stack(parts).sum(0)
    if dtype == torch.float32:
        assert torch.equal(total, whole.float())
    else:
        # each partial rounds to bfloat16 once, the whole once
        torch.testing.assert_close(total, whole.float(), rtol=2**-7,
                                   atol=2**-6)


@pytest.mark.parametrize("m", SHARDS)
def test_shard_gradient_is_the_whole_gradients_rows(m):
    rng = np.random.default_rng(20 + m)
    k, two_b, d, n = 7, 16, 3, 150
    tok = _tokens(rng, n, k, two_b)
    g_out = torch.from_numpy(
        (rng.integers(-256, 257, (n, d)) / 256.0).astype(np.float32))
    whole = sigbag_table_grad(tok, g_out, (k, two_b, d), torch.float32)
    for row0, rows in _shards(m, two_b):
        got = sigbag_table_grad(tok, g_out, (k, rows, d), torch.float32,
                                row0)
        assert torch.equal(got, whole[:, row0:row0 + rows]), row0
        t = torch.zeros((k, rows, d), requires_grad=True)
        (auto,) = torch.autograd.grad(sigbag(tok, t, row0), t, g_out)
        assert torch.equal(auto, got)


@pytest.mark.parametrize("row0", [0, 4, 12])
def test_shard_function_gradcheck_in_float64(row0):
    rng = np.random.default_rng(30 + row0)
    k, rows, d, n = 5, 4, 3, 12
    tok = _tokens(rng, n, k, 16)
    table = torch.from_numpy(rng.standard_normal((k, rows, d))).requires_grad_(
        True)
    assert torch.autograd.gradcheck(
        lambda t: _SigbagFunction.apply(tok, t, row0), (table,))


def test_tokens_are_shifted_in_int64():
    """A token near 2^31 - 1 stays out of a shard at a large row0 (no
    int32 wrap), and the shard's first and last rows are its own."""
    k, rows, d = 1, 4, 2
    row0 = 2**31 - 1 - rows
    table = torch.arange(k * rows * d, dtype=torch.float32).reshape(
        k, rows, d) + 1
    tok = torch.tensor([[row0], [row0 + rows - 1], [row0 + rows], [-1],
                        [row0 - 1]], dtype=torch.int32)
    got = sigbag_plain(tok, table, row0)
    assert torch.equal(got[0], table[0, 0]) and torch.equal(got[1],
                                                            table[0, -1])
    assert not got[2:].any()


def test_cuda_entry_refuses_cpu_tensors():
    tok = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sigbag_cuda(tok, torch.zeros((3, 4, 2)), 4)


def test_a_shard_plans_from_its_own_rows():
    """2^b = 1024, d = 64 float32: a slot slice of 256 KiB cannot stage
    (two must fit in 227 KiB); a shard of 128 rows stages."""
    n, d, sms = 262_144, 64, 132
    assert not staged_plan(n, 1024, d, 4, sms).staged
    for m in SHARDS:
        plan = staged_plan(n, 1024 // m, d, 4, sms)
        assert plan.staged == (m >= 4), m
        if plan.staged:
            assert plan.stage_bytes == -(-(1024 // m + 1) * d * 4 // 128) * 128
