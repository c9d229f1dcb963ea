"""The plain reference the benchmark holds the program to: the paper's
definitions in plain PyTorch, written from the definitions and not from
the program (it imports nothing of ``repro_torch``).

  * ``minhash_codes`` -- k-pass minwise hashing of a padded batch: each
    row's minimum under each of k 2U functions (``((a1 + a2 t) mod 2^32)
    >> (32 - s)``) or 4U functions (``((a1 + a2 t + a3 t^2 + a4 t^3) mod
    p) mod 2^s``, p = 2^31 - 1, reduced by a true modulo), kept to b bits.
  * ``pack`` -- code j in bits [j c, (j + 1) c) of its row's
    little-endian bitstream of 32-bit words (c | 32).

Every function works on the device of its inputs, in blocks, so that it
fits beside what the run has left on the card.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
P31 = (1 << 31) - 1
EMPTY = M32
BLOCK_ELEMS = 1 << 26          # elements of the largest temporary


def _masked_min(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Minimum over lanes (dim 1) of (rows, lanes, k) values, padding
    lanes left out; a row without lanes gets EMPTY."""
    h = torch.where(mask[:, :, None], h, EMPTY)
    return h.min(dim=1).values


def minhash_codes(ids: torch.Tensor, lengths: torch.Tensor, family: str,
                  coef, s: int, b: int) -> torch.Tensor:
    """(rows, k) int64 b-bit codes of k-pass minwise hashing.

    ``ids`` (rows, width) int64 in [0, 2^s); lanes at or past a row's
    ``length`` are padding.  ``coef``: ``(a1, a2)`` int64 arrays of k
    values (2U) or a (4, k) array ``[a1, a2, a3, a4]`` (4U)."""
    rows, width = ids.shape
    dev = ids.device
    mask = torch.arange(width, device=dev)[None, :] < lengths[:, None]
    if family == "2u":
        a1, a2 = (torch.as_tensor(np.asarray(c, np.int64), device=dev)
                  for c in coef)
        k = a1.shape[0]
    else:
        a = torch.as_tensor(np.asarray(coef, np.int64), device=dev)
        k = a.shape[1]
    step = max(1, BLOCK_ELEMS // max(1, width * k))
    out = []
    for r0 in range(0, rows, step):
        t = ids[r0:r0 + step, :, None]
        if family == "2u":
            h = ((a1 + a2 * t) & M32) >> (32 - s)
        else:
            acc = a[3].expand(t.shape[0], width, k)
            for c in (a[2], a[1], a[0]):
                acc = (acc * t + c) % P31
            h = acc & ((1 << s) - 1)
        out.append(_masked_min(h, mask[r0:r0 + step]))
    codes = torch.cat(out) if out else torch.empty((0, k), dtype=torch.int64,
                                                   device=dev)
    return codes & ((1 << b) - 1)


def pack(codes: torch.Tensor, code_bits: int) -> torch.Tensor:
    """(rows, k) codes -> (rows, k * code_bits / 32) int64 words in
    [0, 2^32); needs code_bits | 32 and whole words."""
    rows, k = codes.shape
    per = 32 // code_bits
    if 32 % code_bits or k % per:
        raise ValueError(f"pack needs code_bits | 32 and whole words, got "
                         f"code_bits={code_bits}, k={k}")
    shifts = torch.arange(per, device=codes.device) * code_bits
    fields = (codes & ((1 << code_bits) - 1)).reshape(rows, k // per, per)
    return (fields << shifts).sum(dim=2)


def as_words(x) -> torch.Tensor:
    """int32 bit patterns, uint32 numpy words or int64 values -> int64
    values in [0, 2^32) (a tensor on the input's device)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    return x.to(torch.int64) & M32


def rows_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows of two word matrices that differ anywhere (all of them when
    the shapes differ)."""
    if a.shape != b.shape:
        return max(a.shape[0], b.shape[0])
    return int((as_words(a) != as_words(b).to(a.device)).any(dim=1).sum())
