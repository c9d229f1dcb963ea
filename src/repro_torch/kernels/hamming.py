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
  * ``packed_match_cuda``  -- launches ``csrc/hamming.cu``'s
    ``packed_match_tiled_launch`` on the current stream with an output
    tile of ``HAMMING_TILES``; counts its launches in
    ``packed_match_cuda.launches``.
  * ``packed_match(qwords, cwords, spec, blocks=, tuning=)`` -- the plain
    version for CPU tensors, the kernel for CUDA tensors; the tile is
    ``blocks``, else the ``TuningTable``'s ``"hamming"`` entry for (k,
    packed words), else the kernel's default.

A tile is ``{"blk_q": queries, "blk_n": docs}``.  ``check_tile`` holds it
to the tiles the build instantiates for the wire's kernel (``swar`` where
the code width divides 32, else ``straddle``) on either device, so a bad
table entry raises ``ValueError`` on the CPU as on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bbit import packed_words, unpack_codes
from repro_torch.device import same_device
from repro_torch.kernels import build
from repro_torch.kernels.engine import backend_for, default_tuning_table
from repro_torch.kernels.oph import _PLAIN_ELEMS, check_cuda_args
from repro_torch.kernels.pack import PackSpec

# The (queries, docs) output tiles csrc/hamming.cu instantiates for each
# kernel (its SWAR_TILES / STRADDLE_TILES), the default first.
HAMMING_TILES = {
    "swar": ((64, 64), (32, 64), (64, 32), (32, 32)),
    "straddle": ((32, 64), (64, 32), (32, 32), (16, 64)),
}
MAX_GRID_Y = 65_535        # a launch has at most this many query tiles


def tile_kernel(code_bits: int) -> str:
    """The kernel that scores a wire of ``code_bits``-wide codes."""
    return "swar" if 32 % code_bits == 0 else "straddle"


def default_tile(code_bits: int) -> dict:
    q, n = HAMMING_TILES[tile_kernel(code_bits)][0]
    return {"blk_q": q, "blk_n": n}


def check_tile(blocks: dict, code_bits: int) -> tuple:
    """(blk_q, blk_n) of ``blocks``; raise ``ValueError`` unless it is a
    tile the build has for the ``code_bits`` wire's kernel."""
    kernel = tile_kernel(code_bits)
    have = HAMMING_TILES[kernel]
    if not isinstance(blocks, dict) or set(blocks) != {"blk_q", "blk_n"}:
        raise ValueError(f"packed_match: a tile is {{'blk_q': q, 'blk_n': n}}"
                         f", got {blocks!r}")
    tile = (blocks["blk_q"], blocks["blk_n"])
    if tile not in have or any(isinstance(v, bool) for v in tile):
        raise ValueError(f"packed_match: the {kernel} kernel (code_bits="
                         f"{code_bits}) is built for tiles {list(have)} "
                         f"(blk_q, blk_n), not {tile}")
    return int(tile[0]), int(tile[1])


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
                      code_bits: int, sentinel: bool = False,
                      blocks: Optional[dict] = None):
    """Launch ``packed_match_tiled_launch`` (csrc/hamming.cu) on the
    current stream with the output tile ``blocks`` (the kernel's default
    when None); returns the same as ``packed_match_plain``."""
    nq, w = qwords.shape
    nc = cwords.shape[0]
    dev = check_cuda_args("packed_match", {"qwords": (nq, w),
                                           "cwords": (nc, w)},
                          qwords=qwords, cwords=cwords)
    _check_format("packed_match", k, code_bits, sentinel, w,
                  cwords.shape[1])
    blk_q, blk_n = check_tile(blocks or default_tile(code_bits), code_bits)
    if nq > MAX_GRID_Y * blk_q:
        raise ValueError(f"packed_match: at most {MAX_GRID_Y * blk_q} "
                         f"queries a launch of {blk_q}-query tiles, got {nq}")
    matches = torch.empty((nq, nc), dtype=torch.int32, device=dev)
    both = (torch.empty((nq, nc), dtype=torch.int32, device=dev)
            if sentinel else None)
    if nq and nc:
        hi, lo = _field_masks(code_bits)
        with torch.cuda.device(dev):
            status = build.library("hamming").packed_match_tiled_launch(
                qwords.data_ptr(), cwords.data_ptr(), nq, nc, w, k,
                code_bits, int(sentinel), hi, lo,
                _last_word_mask(k, code_bits), blk_q, blk_n,
                matches.data_ptr(), both.data_ptr() if sentinel else None,
                build.stream_handle(dev))
        build.check(status, "packed_match")
        build.count_launch(packed_match_cuda)
    return (matches, both) if sentinel else matches


packed_match_cuda.launches = 0


def resolve_tile(spec: PackSpec, device: torch.device,
                 blocks: Optional[dict] = None, tuning=None) -> dict:
    """The output tile for ``spec``'s wire on ``device``: ``blocks``, else
    the table's ``"hamming"`` entry keyed on (k, packed words) under the
    device's backend (``tuning``, else ``default_tuning_table()``), else
    the kernel's default; checked against the build's tiles."""
    if not blocks:
        table = tuning or default_tuning_table()
        blocks = (table.lookup(backend_for(device).name, "hamming", spec.k,
                               spec.words) or default_tile(spec.code_bits))
    check_tile(blocks, spec.code_bits)
    return dict(blocks)


def packed_match(qwords: torch.Tensor, cwords: torch.Tensor, spec: PackSpec,
                 *, blocks: Optional[dict] = None, tuning=None):
    """Match counts between packed batches in the wire format ``spec``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    The output tile comes from ``resolve_tile`` (explicit ``blocks`` >
    ``tuning`` entry > default); the plain version checks it and computes
    the same counts.  Returns (Q, N) int32, or ``(matches, both_empty)``
    for sentinel wires."""
    dev = same_device(qwords, cwords)
    blocks = resolve_tile(spec, dev, blocks, tuning)
    kw = dict(k=spec.k, code_bits=spec.code_bits, sentinel=spec.sentinel)
    if dev.type == "cpu":
        return packed_match_plain(qwords, cwords, **kw)
    return packed_match_cuda(qwords, cwords, blocks=blocks, **kw)
