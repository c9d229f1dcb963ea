"""b-bit codes, packing and the Eq. (5) expansion (port of
``repro.core.bbit``).

  * ``lowest_bits``      -- z & (2^b - 1)
  * ``pack_signatures``  -- lane-aligned packing of b-bit values, b | 32
  * ``pack_codes`` / ``unpack_codes`` -- the bitstream wire format: code j
    occupies bits [j*code_bits, (j+1)*code_bits) of its row, so codes may
    straddle words (code_bits = 9 for sentinel b = 8, 17, ...)
  * ``expand_tokens``    -- token ids ``j * 2^b + z_j`` of the implicit
    Eq. (5) expansion
  * ``expand_onehot``    -- the explicit dense 0/1 expansion (tests, small n)
  * ``storage_bits`` / ``vw_storage_bits`` / ``raw_storage_bits`` -- the
    paper's per-example storage accounting

Inputs are uint32 values as int32 bit patterns or int64; uint32 outputs
are int32 bit patterns (``repro_torch.core.u32``).
"""

from __future__ import annotations

import torch

from repro_torch.core.u32 import M32, narrow, widen


def lowest_bits(sig: torch.Tensor, b: int) -> torch.Tensor:
    """Keep the lowest b bits of each value."""
    if b >= 32:
        return narrow(widen(sig))
    return narrow(widen(sig) & ((1 << b) - 1))


def expand_tokens(sig_b: torch.Tensor, b: int) -> torch.Tensor:
    """``tok[i, j] = j * 2^b + z_{i,j}`` as int64 (wraps like the
    reference's uint32 sum, then reads as int32)."""
    k = sig_b.shape[-1]
    offs = (torch.arange(k, dtype=torch.int64, device=sig_b.device) << b) & M32
    return narrow(widen(sig_b) + offs).to(torch.int64)


def expand_onehot(sig_b: torch.Tensor, b: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Explicit (n, k * 2^b) 0/1 expansion of Eq. (5): a one at each
    token.  As the reference's sum of one-hots, a token outside
    [0, k * 2^b) adds nothing and two equal tokens add two."""
    n, k = sig_b.shape
    dim = k * (1 << b)
    tok = expand_tokens(sig_b, b)
    inside = (tok >= 0) & (tok < dim)
    out = torch.zeros((n, dim), dtype=dtype, device=sig_b.device)
    return out.scatter_add_(1, torch.where(inside, tok, 0), inside.to(dtype))


def pack_signatures(sig_b: torch.Tensor, b: int) -> torch.Tensor:
    """(n, k) b-bit values -> (n, ceil(k*b/32)) words, b | 32, value
    ``c`` of word w at bits [c*b, (c+1)*b)."""
    if 32 % b != 0:
        raise ValueError(f"pack_signatures needs b | 32, got b={b}")
    per_word = 32 // b
    n, k = sig_b.shape
    k_pad = -(-k // per_word) * per_word
    z = torch.nn.functional.pad(widen(sig_b), (0, k_pad - k))
    z = z.reshape(n, k_pad // per_word, per_word)
    shifts = torch.arange(per_word, device=z.device, dtype=torch.int64) * b
    return narrow(((z << shifts) & M32).sum(-1))


def unpack_signatures(packed: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_signatures``: (n, k) int32 values."""
    per_word = 32 // b
    shifts = torch.arange(per_word, device=packed.device, dtype=torch.int64) * b
    z = (widen(packed)[..., None] >> shifts) & ((1 << b) - 1)
    return narrow(z.reshape(packed.shape[0], -1)[:, :k])


def packed_words(k: int, code_bits: int) -> int:
    """uint32 words per example for k ``code_bits``-wide codes."""
    if not 1 <= code_bits <= 32:
        raise ValueError(f"code_bits must be in [1, 32], got {code_bits}")
    return (k * code_bits + 31) // 32


def _code_geometry(k: int, code_bits: int, device):
    """(low word index, bit shift) of each code in the bitstream."""
    bit0 = torch.arange(k, dtype=torch.int64, device=device) * code_bits
    return bit0 >> 5, bit0 & 31


def pack_codes(values: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Bitstream-pack (n, k) codes (< 2^code_bits) into (n, words) words.

    ``v << sh`` drops the code's high bits on purpose (they land in the
    next word through ``hi``); the contributions to one word occupy
    disjoint bits, so an add is an or.
    """
    n, k = values.shape
    words = packed_words(k, code_bits)
    v = widen(values)
    if code_bits < 32:
        v = v & ((1 << code_bits) - 1)
    wlo, sh = _code_geometry(k, code_bits, v.device)
    lo = (v << sh) & M32
    hi = (v >> (31 - sh)) >> 1
    out = torch.zeros((n, words), dtype=torch.int64, device=v.device)
    out.index_add_(1, wlo, lo)
    out.index_add_(1, torch.clamp(wlo + 1, max=words - 1), hi)
    return narrow(out)


def unpack_codes(packed: torch.Tensor, code_bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_codes``: (n, k) int32 codes."""
    words = packed.shape[-1]
    if words < packed_words(k, code_bits):
        raise ValueError(
            f"packed has {words} words, need {packed_words(k, code_bits)} "
            f"for k={k}, code_bits={code_bits}")
    p = widen(packed)
    wlo, sh = _code_geometry(k, code_bits, p.device)
    lo = p[:, wlo] >> sh
    hi = ((p[:, torch.clamp(wlo + 1, max=words - 1)] << (31 - sh)) << 1) & M32
    out = lo | hi
    if code_bits < 32:
        out = out & ((1 << code_bits) - 1)
    return narrow(out)


def storage_bits(k: int, b: int) -> int:
    """Per-example storage of the hashed representation: k*b bits."""
    return k * b


def vw_storage_bits(m_bins: int, bits_per_counter: int = 32) -> int:
    """Per-example storage for VW feature hashing with m bins (dense)."""
    return m_bins * bits_per_counter


def raw_storage_bits(avg_nnz: float, index_bits: int = 32) -> float:
    """Per-example storage of the original sparse binary data."""
    return avg_nnz * index_bits
