"""Packed b-bit wire format (port of ``repro.kernels.pack``).

  * ``PackSpec`` -- (k, b, sentinel) -> code width and word count.  Plain
    signatures pack b-bit codes; sentinel OPH packs (b+1)-bit codes with
    EMPTY stored as 2^b.
  * ``encode_sentinel`` / ``decode_sentinel`` -- EMPTY <-> 2^b.
  * ``pack_device`` / ``unpack_device`` -- the pack / unpack epilogues, in
    plain PyTorch on the tensor's device.
  * ``can_pack_in_kernel`` -- the reference's rule for its TPU kernels'
    fused epilogue (whole ``blk_k`` tiles).  The port's CUDA epilogue
    (``csrc/minhash.cu``, the port of ``pack_block``) also packs a ragged
    last warp, so it needs only b | 32 (``minhash.can_fuse_pack``).
  * ``pack_block`` -- that epilogue's plain version.

Bit layout (shared with ``repro_torch.core.bbit.pack_codes``): code j
occupies bits [j*code_bits, (j+1)*code_bits) of its row's bitstream.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.bbit import (pack_codes, pack_signatures, packed_words,
                                   unpack_codes)
from repro_torch.core.u32 import EMPTY, narrow, widen


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of one packed-signature wire format."""

    k: int                  # signature length (values per example)
    b: int                  # b-bit width of genuine values
    sentinel: bool = False  # True: OPH sentinel scheme, EMPTY coded as 2^b

    def __post_init__(self):
        if not 1 <= self.b <= 16:
            raise ValueError(f"packed wire format needs 1 <= b <= 16, "
                             f"got b={self.b}")

    @property
    def code_bits(self) -> int:
        return self.b + 1 if self.sentinel else self.b

    @property
    def words(self) -> int:
        return packed_words(self.k, self.code_bits)

    @property
    def empty_code(self) -> int:
        return 1 << self.b

    def bytes_per_example(self) -> int:
        return 4 * self.words


def encode_sentinel(sig: torch.Tensor, b: int) -> torch.Tensor:
    """b-bit values with EMPTY markers -> (b+1)-bit codes (EMPTY = 2^b)."""
    v = widen(sig)
    return narrow(torch.where(v == EMPTY, 1 << b, v & ((1 << b) - 1)))


def decode_sentinel(codes: torch.Tensor, b: int) -> torch.Tensor:
    """(b+1)-bit codes -> b-bit values with EMPTY restored."""
    v = widen(codes)
    return narrow(torch.where(v == (1 << b), EMPTY, v))


def pack_device(sig: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """(n, k) signature values -> (n, spec.words) int32 words."""
    if sig.shape[-1] != spec.k:
        raise ValueError(f"sig has k={sig.shape[-1]}, spec has k={spec.k}")
    codes = encode_sentinel(sig, spec.b) if spec.sentinel else sig
    return pack_codes(codes, spec.code_bits)


def unpack_device(packed: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """(n, spec.words) words -> (n, k) values, EMPTY restored."""
    codes = unpack_codes(packed, spec.code_bits, spec.k)
    return decode_sentinel(codes, spec.b) if spec.sentinel else codes


def can_pack_in_kernel(k_pad: int, k: int, b: int, blk_k: int) -> bool:
    """The reference's rule: True when its TPU kernel's epilogue can emit
    packed words directly: lane-aligned codes (b | 32), k a whole number
    of hash-function blocks (``k_pad``, k rounded up to ``blk_k``, equals
    k), whole words per block."""
    return (0 < b <= 16 and 32 % b == 0 and k_pad == k
            and (blk_k * b) % 32 == 0)


def pack_block(tile: torch.Tensor, b: int) -> torch.Tensor:
    """Plain version of the fused epilogue: (rows, k) b-bit codes ->
    (rows, ceil(k*b/32)) words, zero padded past k.  Equals
    ``pack_codes`` when b | 32."""
    return pack_signatures(tile, b)
