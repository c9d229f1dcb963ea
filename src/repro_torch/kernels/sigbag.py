"""Signature embedding-bag: the CUDA kernel and its plain version (port of
``repro.kernels.sigbag``), the Eq. (5) forward

    out[i] = sum_j table[j, tokens[i, j]]

for ``tokens (n, k)`` int32 b-bit signature values and ``table (k, 2^b,
d)`` float32 or bfloat16; the output is (n, d) in the table's type.  With
d = 1 it is the paper's linear-model inner product, with d > 1 the hashed
embedding frontend of the recsys models.

Every output element is a float32 sum from 0 over j = 0, 1, ..., k-1 in
order, cast once to the table's type: what the Pallas kernel computes, bit
for bit (``repro.kernels.ref.sigbag_ref`` sums in ``jnp.sum``'s tree order
instead).  A token outside [0, 2^b) adds nothing, as the Pallas kernel's
all-zero one-hot row does (``sigbag_ref`` gives NaN there).

A row shard: with ``row0``, ``table`` (k, rows, d) holds rows [row0, row0
+ rows) of the whole table's 2^b axis, and a token t adds ``table[j, t -
row0]`` when row0 <= t < row0 + rows, nothing otherwise.  The shards'
bags summed are the whole table's bag (exactly, where the float32 sums
are exact in any order); a table row-sharded over a mesh axis is bagged
so, then summed across the axis (``models.recsys.minhash_frontend``).

  * ``sigbag_plain`` -- a loop over j of row gathers added in float32
    (``t - row0`` in int64, so no token wraps).
  * ``sigbag_cuda``  -- launches ``csrc/sigbag.cu``'s row-shard entry
    ``sigbag_shard_launch`` on the current stream (the whole table is the
    shard at row0 = 0); counts its launches in ``sigbag_cuda.launches``.
  * ``sigbag(tokens, table, row0)`` -- the plain version for CPU tensors,
    the kernel for CUDA tensors; differentiable in ``table`` when
    autograd records it.
  * ``sigbag_table_grad`` -- its backward, the scatter-add
    ``d table[j, tokens[i, j] - row0, :] += d out[i, :]`` in plain
    PyTorch (``index_put_`` with ``accumulate``), dropping the tokens the
    forward drops.  The JAX package has no backward kernel either: its
    training graph differentiates ``sigbag_ref`` by autodiff.

The kernel has two designs (see the header of ``csrc/sigbag.cu``): (A)
slot tables staged in shared memory, for bulk batches, and (B) a direct
gather, for request batches and every shape (A) cannot hold.
``staged_plan`` is the rule that picks one, the twin of the kernel's
``make_plan``; ``direct_layout`` gives (B)'s lanes.  ``sigbag_plan_cuda``
asks the built kernel (its ``sigbag_plan``) which design a call takes.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.device import same_device
from repro_torch.kernels import build

TABLE_DTYPES = (torch.float32, torch.bfloat16)
# the plain version also takes float64 (summed in float64), for gradient
# checks by finite differences
PLAIN_DTYPES = TABLE_DTYPES + (torch.float64,)

# csrc/sigbag.cu's constants
A_WARPS = 8             # consumer warps of a staged block (+ 2 producers)
A_ROWS_MAX = 1024       # rows of a staged block
A_ACC = 128             # float32 sums a consumer thread
A_TCH = 8               # slots a token stage
A_SPS = 2               # slots a consumer step
A_PPT = 2               # 16-byte pieces a consumer thread
A_SMEM_MAX = 232_448    # opt-in shared memory a block (227 KB)
A_BARRIER_BYTES = 256
A_MAX_STAGES = 8
B_SLOTS = 64            # slot loads in flight a lane


@dataclasses.dataclass(frozen=True)
class SigbagPlan:
    """The design of one call: ``staged`` (A) with ``rows`` a block,
    ``stages`` slot stages of ``stage_bytes`` and ``tpr`` 16-byte pieces a
    table row, or direct (B) with the other fields 0."""

    staged: bool
    rows: int = 0
    stages: int = 0
    stage_bytes: int = 0
    tpr: int = 0


def staged_rows(tpr: int, esize: int) -> int:
    """Rows of a staged block: a thread takes A_PPT of a row's tpr 16-byte
    pieces (1 where tpr = 1), so A_WARPS warps take 32 / (tpr / A_PPT)
    rows each a step, for as many steps as A_ACC float32 sums a thread and
    A_ROWS_MAX allow."""
    ppt = A_PPT if tpr > 1 else 1
    step = A_WARPS * (32 // (tpr // ppt))
    return step * min(A_ACC // (ppt * 16 // esize), A_ROWS_MAX // step)


def staged_plan(n: int, two_b: int, d: int, esize: int, sms: int,
                table_ptr: int = 0) -> SigbagPlan:
    """The dispatch rule of the kernel's launch: design (A) when a table row
    is 16 * tpr bytes (tpr a power of two <= 32), the table (at address
    ``table_ptr``) 16-byte aligned, two slot slices (2^b rows and a zero
    row, 128-byte rounded) fit beside the two token stages, and
    ceil(n / rows) >= sms; else (B)."""
    rowb = d * esize
    tpr = rowb // 16
    if (rowb % 16 or not 1 <= tpr <= 32 or tpr & (tpr - 1)
            or table_ptr % 16):
        return SigbagPlan(False)
    rows = staged_rows(tpr, esize)
    stage_bytes = -(-(two_b * rowb + rowb) // 128) * 128
    stages = ((A_SMEM_MAX - A_BARRIER_BYTES - 2 * rows * A_TCH * 4)
              // stage_bytes)
    if stages < 2 or -(-n // rows) < sms:
        return SigbagPlan(False)
    return SigbagPlan(True, rows, min(stages, A_MAX_STAGES), stage_bytes, tpr)


def direct_layout(d: int, esize: int, table_ptr: int = 0):
    """Design (B)'s (V, L): V = 2 columns a lane where d is even and the
    table (at ``table_ptr``) aligned to 2 * esize bytes, else 1; L lanes
    a row, the power of two >= ceil(d / V), at most 32."""
    v = 2 if d % 2 == 0 and table_ptr % (2 * esize) == 0 else 1
    lanes = 1
    while lanes < min(-(-d // v), 32):
        lanes *= 2
    return v, lanes


def _check_shapes(name: str, tokens: torch.Tensor, table: torch.Tensor,
                  dtypes=TABLE_DTYPES):
    if tokens.dim() != 2 or table.dim() != 3:
        raise ValueError(f"{name}: need tokens (n, k) and table (k, 2^b, d), "
                         f"got {tuple(tokens.shape)} and {tuple(table.shape)}")
    if table.shape[0] != tokens.shape[1]:
        raise ValueError(f"{name}: table k={table.shape[0]} != tokens "
                         f"k={tokens.shape[1]}")
    if table.dtype not in dtypes:
        also = " (or float64, in the plain version)" * (
            dtypes == PLAIN_DTYPES)
        raise TypeError(f"{name}: table must be float32 or bfloat16{also}, "
                        f"got {table.dtype}")


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 sums, float64 ones for a float64 table."""
    return torch.promote_types(dtype, torch.float32)


def sigbag_plain(tokens: torch.Tensor, table: torch.Tensor,
                 row0: int = 0) -> torch.Tensor:
    """Plain PyTorch ``sigbag`` over the rows [row0, row0 + rows) that
    ``table`` holds (see the module docstring)."""
    _check_shapes("sigbag_plain", tokens, table, PLAIN_DTYPES)
    n, k = tokens.shape
    two_b, d = table.shape[1], table.shape[2]
    acc = torch.zeros((n, d), dtype=_sum_dtype(table.dtype),
                      device=table.device)
    for j in range(k):
        tok = tokens[:, j].to(torch.int64) - row0
        valid = (tok >= 0) & (tok < two_b)
        rows = table[j].index_select(0, tok.clamp(0, two_b - 1))
        acc += torch.where(valid[:, None], rows.to(acc.dtype), 0.0)
    return acc.to(table.dtype)


def _sigbag_output(tokens, table, row0) -> torch.Tensor:
    return torch.empty((tokens.shape[0], table.shape[2]), dtype=table.dtype,
                       device=tokens.device)


def _sigbag_launch(tokens, table, row0):
    out = _sigbag_output(tokens, table, row0)
    n, k = tokens.shape
    two_b, d = table.shape[1], table.shape[2]
    if n and d:
        dev = tokens.device
        lib, bf16 = build.library("sigbag"), int(table.dtype == torch.bfloat16)
        with torch.cuda.device(dev):
            status = lib.sigbag_shard_launch(
                tokens.data_ptr(), table.data_ptr(), n, k, two_b, row0, d,
                bf16, out.data_ptr(), build.stream_handle(dev))
        build.check(status, "sigbag")
        build.count_launch(sigbag_cuda)
    return out


_SIGBAG = build.kernel_op(
    "sigbag(Tensor tokens, Tensor table, int row0) -> Tensor",
    _sigbag_launch, _sigbag_output)


def sigbag_cuda(tokens: torch.Tensor, table: torch.Tensor,
                row0: int = 0) -> torch.Tensor:
    """Launch ``sigbag_shard_launch`` (csrc/sigbag.cu) on the current
    stream (the operator ``repro_torch::sigbag``); returns the same as
    ``sigbag_plain(tokens, table, row0)``."""
    _check_shapes("sigbag", tokens, table)
    dev = same_device(tokens, table)
    if dev.type not in ("cuda", "meta"):   # meta: a trace's shapes only
        raise ValueError(f"sigbag: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    if tokens.dtype != torch.int32:
        raise TypeError(f"sigbag: tokens must be int32, got {tokens.dtype}")
    for key, t in (("tokens", tokens), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"sigbag: {key} must be contiguous")
    n, k = tokens.shape
    two_b, d = table.shape[1], table.shape[2]
    if max(n, k, two_b, d) > 2**31 - 1:
        raise ValueError(f"sigbag: every extent must fit in int32, got n={n}"
                         f" and table {tuple(table.shape)}")
    if not 0 <= row0 <= 2**31 - 1 - two_b:
        raise ValueError(f"sigbag: rows [{row0}, {row0} + {two_b}) of a row "
                         "shard must lie in [0, 2^31 - 1)")
    return _SIGBAG(tokens, table, row0)


sigbag_cuda.launches = 0


def sigbag_plan_cuda(tokens: torch.Tensor, table: torch.Tensor):
    """The design ``sigbag_cuda(tokens, table)`` takes, as the built
    kernel's ``sigbag_plan`` decides it: (``SigbagPlan``, SM count)."""
    _check_shapes("sigbag", tokens, table)
    dev = same_device(tokens, table)
    if dev.type != "cuda":
        raise ValueError(f"sigbag: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    n = tokens.shape[0]
    two_b, d = table.shape[1], table.shape[2]
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(dev):
        status = build.library("sigbag").sigbag_plan(
            table.data_ptr(), n, two_b, d,
            int(table.dtype == torch.bfloat16), info)
    build.check(status, "sigbag_plan")
    staged, rows, stages, stage_bytes, tpr, sms = info
    return SigbagPlan(bool(staged), rows, stages, stage_bytes, tpr), sms


def _sigbag_forward(tokens: torch.Tensor, table: torch.Tensor,
                    row0: int) -> torch.Tensor:
    if same_device(tokens, table).type == "cpu":
        return sigbag_plain(tokens, table, row0)
    return sigbag_cuda(tokens, table, row0)


def sigbag_table_grad(tokens: torch.Tensor, grad_out: torch.Tensor,
                      table_shape, dtype: torch.dtype,
                      row0: int = 0) -> torch.Tensor:
    """The gradient of ``sigbag(tokens, table, row0)`` in ``table`` given
    the output's gradient ``grad_out (n, d)``: a (k, rows, d) table of
    ``dtype`` summed in float32 (float64 for float64) -- rows [row0, row0
    + rows) of the whole table's gradient.  Tokens outside those rows
    scatter into a spare row that is cut off, so they add nothing, as in
    the forward."""
    k, two_b, d = table_shape
    n = tokens.shape[0]
    tok = tokens.to(torch.int64) - row0
    slots = torch.arange(k, dtype=torch.int64, device=tok.device) * two_b
    flat = torch.where((tok >= 0) & (tok < two_b), tok + slots, k * two_b)
    grad = torch.zeros((k * two_b + 1, d), dtype=_sum_dtype(dtype),
                       device=grad_out.device)
    rows = grad_out.to(grad.dtype)[:, None, :].expand(n, k, d)
    grad.index_put_((flat.reshape(-1),), rows.reshape(n * k, d),
                    accumulate=True)
    return grad[:-1].reshape(k, two_b, d).to(dtype)


class _SigbagFunction(torch.autograd.Function):
    """``sigbag`` with its table gradient (tokens are integers: none)."""

    @staticmethod
    def forward(ctx, tokens, table, row0=0):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = tuple(table.shape), table.dtype
        ctx.row0 = row0
        return _sigbag_forward(tokens, table, row0)

    @staticmethod
    def backward(ctx, grad_out):
        (tokens,) = ctx.saved_tensors
        return None, sigbag_table_grad(tokens, grad_out, ctx.table_shape,
                                       ctx.table_dtype, ctx.row0), None


def sigbag(tokens: torch.Tensor, table: torch.Tensor,
           row0: int = 0) -> torch.Tensor:
    """Signature embedding-bag over the row shard at ``row0``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors;
    through ``_SigbagFunction`` when autograd needs the table's
    gradient."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _SigbagFunction.apply(tokens, table, row0)
    return _sigbag_forward(tokens, table, row0)
