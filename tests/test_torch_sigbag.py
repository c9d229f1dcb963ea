"""Port parity for the signature embedding-bag kernel module: the port's
plain version against the JAX package's Pallas kernel (interpret mode),
bit for bit, and against its ``sigbag_ref`` oracle within that oracle's
own test tolerance (``tests/test_kernels.py``).

The Pallas kernel adds slot j's row to a float32 accumulator in the order
j = 0, 1, ..., k-1 and casts once to the table's type; ``sigbag_plain``
(and the CUDA kernel, held against it on the card by ``chip_smoke.py``)
do the same, so they agree exactly.  ``sigbag_ref`` sums in ``jnp.sum``'s
order and differs in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bbit import expand_onehot
from repro.kernels import ref as kref
from repro.kernels import sigbag as j_sigbag
from repro_torch.kernels.ref import sigbag_plain
from repro_torch.kernels.sigbag import sigbag, sigbag_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (n, k, b, d): the reference test's shapes and the recsys frontend's
SHAPES = [(10, 16, 4, 8), (130, 32, 6, 32), (64, 500, 8, 1), (130, 64, 8, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, n, k, b, d, dtype):
    """Tokens in [0, 2^b) and an N(0, 1) table, rounded to ``dtype`` in
    JAX and handed to torch through float32 (exact for bfloat16)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 2**b, (n, k)).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    j_table = jnp.asarray(rng.normal(size=(k, 2**b, d)), jdt)
    t_table = torch.from_numpy(np.array(j_table, np.float32)).to(tdt)
    return tok, j_table, t_table


def _pallas(tok, j_table):
    """``repro.kernels.sigbag`` through the Pallas kernel in interpret
    mode (rows padded to its block, as the engine does)."""
    out = j_sigbag(jnp.asarray(tok), j_table, backend="interpret")
    return np.asarray(out.astype(jnp.float32))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,k,b,d", SHAPES)
def test_plain_equals_pallas_kernel_bit_for_bit(n, k, b, d, dtype):
    tok, j_table, t_table = _inputs(n * k + d, n, k, b, d, dtype)
    got = sigbag_plain(torch.from_numpy(tok), t_table)
    assert got.dtype == t_table.dtype and got.shape == (n, d)
    np.testing.assert_array_equal(_f32(got), _pallas(tok, j_table))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,k,b,d", SHAPES)
def test_plain_matches_sigbag_ref(n, k, b, d, dtype):
    """Against the oracle, at the reference test's tolerance per type."""
    tok, j_table, t_table = _inputs(n * k + d + 1, n, k, b, d, dtype)
    got = _f32(sigbag_plain(torch.from_numpy(tok), t_table))
    want = np.asarray(kref.sigbag_ref(jnp.asarray(tok), j_table), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=0.3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_out_of_range_token_adds_nothing(dtype):
    """A token outside [0, 2^b) contributes nothing, as in the Pallas
    kernel (its one-hot row is all zero; ``sigbag_ref`` gives NaN)."""
    n, k, b, d = 12, 8, 3, 4
    tok, j_table, t_table = _inputs(5, n, k, b, d, dtype)
    tok[0, 0], tok[1, 3], tok[2, 7], tok[3, :] = -1, 2**b, 2**b + 5, -7
    got = _f32(sigbag_plain(torch.from_numpy(tok), t_table))
    np.testing.assert_array_equal(got, _pallas(tok, j_table))
    assert not got[3].any()
    # the same sums written out: float32 adds in slot order, invalid skipped
    table = _f32(t_table)
    want = np.zeros((n, d), np.float32)
    for i in range(n):
        for j in range(k):
            if 0 <= tok[i, j] < 2**b:
                want[i] = want[i] + table[j, tok[i, j]]
    want = _f32(torch.from_numpy(want).to(t_table.dtype))
    np.testing.assert_array_equal(got, want)


def test_d1_is_eq5_inner_product():
    """With d = 1, sigbag is the Eq. (5) one-hot expansion's dot product."""
    rng = np.random.default_rng(9)
    k, b, n = 24, 3, 12
    tok = rng.integers(0, 2**b, (n, k)).astype(np.int32)
    w = rng.normal(size=(k * 2**b,)).astype(np.float32)
    got = sigbag_plain(torch.from_numpy(tok),
                       torch.from_numpy(w).reshape(k, 2**b, 1))[:, 0]
    oh = np.asarray(expand_onehot(jnp.asarray(tok.astype(np.uint32)), b))
    np.testing.assert_allclose(got.numpy(), oh @ w, rtol=1e-5, atol=1e-5)


def test_dispatch_runs_plain_version_on_cpu():
    """The dispatching ``sigbag`` runs the plain version on CPU tensors and
    launches nothing."""
    tok, _, table = _inputs(3, 20, 16, 4, 8, "float32")
    tok = torch.from_numpy(tok)
    assert torch.equal(sigbag(tok, table), sigbag_plain(tok, table))
    assert sigbag_cuda.launches == 0


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_args():
    tok, _, table = _inputs(4, 6, 16, 4, 8, "float32")
    tok = torch.from_numpy(tok)
    with pytest.raises(ValueError, match="CUDA"):
        sigbag_cuda(tok, table)
    with pytest.raises(ValueError, match="k="):
        sigbag_plain(tok[:, :8], table)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sigbag_plain(tok, table.half())
    assert sigbag_cuda.launches == 0
