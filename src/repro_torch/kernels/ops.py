"""Legacy public wrappers (port of ``repro.kernels.ops``), over the port's
kernels and engine.

The reference kept this module so that old imports go on working; the
port keeps the same names.  The TPU launch knobs of the reference's
wrappers (``use_pallas``, ``backend``, ``blk_*``) have no counterpart: the
tensors' device picks the CUDA kernel or its plain version, at the
kernels' default launch shapes (a tuned shape goes through
``SignatureEngine`` and its ``TuningTable``).  New code should import from
``repro_torch.kernels`` directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import minhash as kmin
from repro_torch.kernels import oph as koph
from repro_torch.kernels.engine import batch_signatures, oph_epilogue
from repro_torch.kernels.sigbag import sigbag

__all__ = ["batch_signatures", "minhash2u", "minhash4u", "oph2u", "oph4u",
           "sigbag"]


def minhash2u(indices: torch.Tensor, counts: torch.Tensor, a1: torch.Tensor,
              a2: torch.Tensor, *, s: int, b: int = 0,
              variant: str = "high") -> torch.Tensor:
    """Batched 2U minhash signatures. counts: (n,) or (n, 1) int32."""
    return kmin.minhash2u(indices, counts.reshape(-1), a1, a2, s=s, b=b,
                          variant=variant)


def minhash4u(indices: torch.Tensor, counts: torch.Tensor, a: torch.Tensor,
              *, s: int, b: int = 0) -> torch.Tensor:
    """Batched 4U minhash signatures (Mersenne BitMod path)."""
    return kmin.minhash4u(indices, counts.reshape(-1), a, s=s, b=b)


def oph2u(indices: torch.Tensor, counts: torch.Tensor, a1: torch.Tensor,
          a2: torch.Tensor, *, s: int, k: int, densify: str = "rotation",
          b: int = 0, variant: str = "high") -> torch.Tensor:
    """Batched 2U OPH signatures: ONE hash pass -> (n, k) bin minima,
    densified and b-bit masked."""
    bin_bits = k.bit_length() - 1
    raw = koph.oph2u(indices, counts.reshape(-1), a1, a2, s=s,
                     bin_bits=bin_bits, variant=variant)
    return oph_epilogue(raw, k=k, s=s, bin_bits=bin_bits, densify=densify, b=b)


def oph4u(indices: torch.Tensor, counts: torch.Tensor, a: torch.Tensor, *,
          s: int, k: int, densify: str = "rotation", b: int = 0
          ) -> torch.Tensor:
    """Batched 4U OPH signatures (Mersenne BitMod path); see ``oph2u``."""
    bin_bits = k.bit_length() - 1
    raw = koph.oph4u(indices, counts.reshape(-1), a, s=s, bin_bits=bin_bits)
    return oph_epilogue(raw, k=k, s=s, bin_bits=bin_bits, densify=densify, b=b)
