"""Packed-signature match counts: the CUDA kernel and its plain version
(port of ``repro.kernels.hamming``), the scoring hot path of retrieval.

For a batch of packed query signatures ``qwords (Q, W)`` and a packed
corpus ``cwords (N, W)`` (int32 uint32 bit patterns in the bitstream wire
format of ``repro_torch.core.bbit.pack_codes``), every (query, doc) pair
gets the number of the first k ``code_bits``-wide codes that agree:
``(Q, N)`` int32.  With ``sentinel`` (OPH codes, EMPTY = 2^(code_bits-1))
jointly-EMPTY positions are left out of the matches and counted in a
second output, ``(matches, both_empty)`` -- the Li-Owen-Zhang numerator
and denominator correction.

  * ``packed_match_plain`` -- unpack with ``core/bbit.py``, broadcast
    compare, sum (the counterpart of ``repro.kernels.ref.packed_match_ref``).
  * ``packed_match_cuda``  -- launches ``csrc/hamming.cu`` on the current
    stream; counts its launches in ``packed_match_cuda.launches``.
  * ``packed_match(qwords, cwords, spec)`` -- the plain version for CPU
    tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.bbit import packed_words, unpack_codes
from repro_torch.device import same_device
from repro_torch.kernels import build
from repro_torch.kernels.oph import _PLAIN_ELEMS, check_cuda_args
from repro_torch.kernels.pack import PackSpec

# grid.y (65,535) x queries per output tile (32 in the 9-bit kernel, 64
# in the SWAR one)
MAX_QUERIES = 65_535 * 32


def _check_format(name: str, k: int, code_bits: int, sentinel: bool,
                  w: int, wc: int) -> None:
    if k < 1:
        raise ValueError(f"{name}: k must be >= 1, got {k}")
    if sentinel and code_bits < 2:
        raise ValueError(f"{name}: sentinel codes need code_bits >= 2")
    words = packed_words(k, code_bits)
    if w != words or wc != words:
        raise ValueError(f"{name}: packed operands have {w}/{wc} words, "
                         f"k={k} codes of {code_bits} bits need {words}")


def packed_match_plain(qwords: torch.Tensor, cwords: torch.Tensor, *, k: int,
                       code_bits: int, sentinel: bool = False):
    """Plain PyTorch match counts (see the module docstring).

    The corpus is compared in row chunks so the (Q, rows, k) compare
    stays within ``_PLAIN_ELEMS`` elements.
    """
    _check_format("packed_match_plain", k, code_bits, sentinel,
                  qwords.shape[-1], cwords.shape[-1])
    nq, nc = qwords.shape[0], cwords.shape[0]
    qc = unpack_codes(qwords, code_bits, k)                  # (Q, k)
    ec = 1 << (code_bits - 1)
    q_empty = (qc == ec)[:, None, :] if sentinel else None
    matches, both = [], []
    step = max(1, _PLAIN_ELEMS // max(1, nq * k))
    for lo in range(0, nc, step):
        cc = unpack_codes(cwords[lo:lo + step], code_bits, k)
        eq = qc[:, None, :] == cc[None, :, :]
        if sentinel:
            be = q_empty & (cc == ec)[None, :, :]
            matches.append((eq & ~be).sum(2, dtype=torch.int32))
            both.append(be.sum(2, dtype=torch.int32))
        else:
            matches.append(eq.sum(2, dtype=torch.int32))
    empty = torch.zeros((nq, 0), dtype=torch.int32, device=qwords.device)
    m = torch.cat(matches, 1) if matches else empty
    if sentinel:
        return m, (torch.cat(both, 1) if both else empty.clone())
    return m


def _field_masks(code_bits: int):
    """(hi, lo) of the SWAR zero-field test for code_bits | 32: the top
    bit of every field, and the bits below it."""
    if 32 % code_bits:
        return 0, 0
    top = 1 << (code_bits - 1)
    hi = sum(top << f for f in range(0, 32, code_bits))
    return hi, hi ^ sum((2 * top - 1) << f for f in range(0, 32, code_bits))


def _last_word_mask(k: int, code_bits: int) -> int:
    """Bits of the last packed word that belong to codes below k."""
    used = k * code_bits - 32 * (packed_words(k, code_bits) - 1)
    return 0xFFFFFFFF if used == 32 else (1 << used) - 1


def packed_match_cuda(qwords: torch.Tensor, cwords: torch.Tensor, *, k: int,
                      code_bits: int, sentinel: bool = False):
    """Launch ``packed_match_launch`` (csrc/hamming.cu) on the current
    stream; returns the same as ``packed_match_plain``."""
    nq, w = qwords.shape
    nc = cwords.shape[0]
    dev = check_cuda_args("packed_match", {"qwords": (nq, w),
                                           "cwords": (nc, w)},
                          qwords=qwords, cwords=cwords)
    _check_format("packed_match", k, code_bits, sentinel, w,
                  cwords.shape[1])
    if nq > MAX_QUERIES:
        raise ValueError(f"packed_match: at most {MAX_QUERIES} queries a "
                         f"launch, got {nq}")
    matches = torch.empty((nq, nc), dtype=torch.int32, device=dev)
    both = (torch.empty((nq, nc), dtype=torch.int32, device=dev)
            if sentinel else None)
    if nq and nc:
        hi, lo = _field_masks(code_bits)
        with torch.cuda.device(dev):
            status = build.library("hamming").packed_match_launch(
                qwords.data_ptr(), cwords.data_ptr(), nq, nc, w, k,
                code_bits, int(sentinel), hi, lo,
                _last_word_mask(k, code_bits), matches.data_ptr(),
                both.data_ptr() if sentinel else None,
                build.stream_handle(dev))
        build.check(status, "packed_match")
        build.count_launch(packed_match_cuda)
    return (matches, both) if sentinel else matches


packed_match_cuda.launches = 0


def packed_match(qwords: torch.Tensor, cwords: torch.Tensor, spec: PackSpec):
    """Match counts between packed batches in the wire format ``spec``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (Q, N) int32, or ``(matches, both_empty)`` for sentinel
    wires."""
    fn = (packed_match_plain if same_device(qwords, cwords).type == "cpu"
          else packed_match_cuda)
    return fn(qwords, cwords, k=spec.k, code_bits=spec.code_bits,
              sentinel=spec.sentinel)
