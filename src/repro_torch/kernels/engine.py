"""SignatureEngine: scheme dispatch onto the kernels, and the packed wire
format (port of ``repro.kernels.engine``).

  * ``Backend`` / ``BACKENDS`` -- ``cuda`` runs the hand-written kernels on
    CUDA tensors; ``torch`` runs their plain versions on CPU tensors.  A
    backend never runs on the other device: no silent fallback.
  * ``TuningTable`` -- launch parameters keyed on (backend, scheme, k,
    nnz bucket).  It is empty: ``tune()`` is the one function of the
    reference's modules still to port (see ``TuningTable``).
  * ``SignaturePlan`` / ``SignatureEngine`` -- a frozen description of one
    signature computation and its execution through the ``_RUNNERS``
    registry over (minhash | oph) x (2u | 4u | perm).
  * ``PackedSignatures`` -- k*code_bits bits per example; sentinel OPH
    packs (b+1)-bit codes with EMPTY as 2^b.

The OPH epilogue (slice, densify, b bits, pack) is plain PyTorch on the
device, as the reference's was plain jnp.  The TPU's padding of rows,
nnz and k to its tiles is gone: kernels take the batch as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.bbit import pack_codes
from repro_torch.core.hashing import Hash2U, Hash4U, PermutationFamily
from repro_torch.core.oph import OPH, densify_and_bbit, oph_signatures
from repro_torch.data.sparse import SparseBatch
from repro_torch.device import same_device
from repro_torch.kernels import minhash as kmin
from repro_torch.kernels import oph as koph
from repro_torch.kernels.pack import (PackSpec, can_pack_in_kernel,
                                      pack_device, unpack_device)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    """One way to execute the signature kernels, bound to a device type."""

    name: str
    device_type: str
    notes: str = ""


BACKENDS: Dict[str, Backend] = {
    "cuda": Backend("cuda", "cuda", "hand-written CUDA kernels (csrc/)"),
    "torch": Backend("torch", "cpu", "plain PyTorch versions, CPU tensors only"),
}


def backend_for(device: torch.device) -> Backend:
    """The backend that runs on ``device``: there is exactly one."""
    for be in BACKENDS.values():
        if be.device_type == device.type:
            return be
    raise ValueError(f"no signature backend runs on {device}; registered: "
                     f"{sorted(BACKENDS)}")


# ---------------------------------------------------------------------------
# Launch-parameter tuning table
# ---------------------------------------------------------------------------

def nnz_bucket(nnz: int) -> int:
    """Bucket a padded nnz width to the next power of two (>= 128)."""
    return max(128, 1 << max(0, int(nnz) - 1).bit_length())


class TuningTable:
    """Launch parameters keyed on (backend, scheme, k, nnz bucket), as in
    the reference.  It is empty: the reference's entries were measured on
    a TPU, and ``tune()``, which would fill it for the card, is not ported
    yet -- the roofline and the dry run it would sit beside are -- so
    every lookup misses and the kernels run with their module constants
    (``MINHASH_BLK_K``, ``OPH_THREADS``).  The ``minhash`` and ``oph``
    launchers already take their block shape as an argument; the
    ``"hamming"`` scheme's tiles are fixed when ``csrc/hamming.cu`` is
    compiled, so tuning it needs more instantiations of that kernel."""

    def __init__(self):
        self.entries: Dict[str, dict] = {}

    @staticmethod
    def key(backend: str, scheme: str, k: int, bucket: int) -> str:
        return f"{backend}/{scheme}/k={k}/nnz<={bucket}"

    def lookup(self, backend: str, scheme: str, k: int,
               nnz: int) -> Optional[dict]:
        return self.entries.get(self.key(backend, scheme, k, nnz_bucket(nnz)))


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedSignatures:
    """Bit-packed signatures: (n, words) int32 words, k*code_bits bits per
    example; ``unpack`` restores the (n, k) values, EMPTY included."""

    data: torch.Tensor       # (n, words) int32 uint32 bit patterns
    k: int
    b: int
    sentinel: bool = False

    @property
    def spec(self) -> PackSpec:
        return PackSpec(self.k, self.b, self.sentinel)

    @property
    def code_bits(self) -> int:
        return self.spec.code_bits

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def nbytes(self) -> int:
        return self.data.numel() * 4

    def unpack(self) -> torch.Tensor:
        return unpack_device(self.data, self.spec)

    def __getitem__(self, idx) -> "PackedSignatures":
        return PackedSignatures(self.data[idx], self.k, self.b, self.sentinel)

    def __len__(self) -> int:
        return self.n


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SignaturePlan:
    """Static description of one signature computation (no tensors)."""

    scheme: str                  # "minhash" | "oph"
    family: str                  # "2u" | "4u" | "perm"
    k: int
    s: int
    b: int = 0
    densify: Optional[str] = None   # OPH only
    variant: str = "high"           # 2U only
    packed: bool = False

    @property
    def sentinel(self) -> bool:
        return self.densify == "sentinel"

    @property
    def pack_spec(self) -> PackSpec:
        return PackSpec(self.k, self.b, self.sentinel)


def _family_statics(family) -> dict:
    """The single isinstance seam: hash-family object -> plan statics."""
    if isinstance(family, OPH):
        base = family.base
        if isinstance(base, Hash2U):
            fam = "2u"
        elif isinstance(base, Hash4U):
            fam = "4u"
        elif isinstance(base, PermutationFamily):
            fam = "perm"
        else:
            raise TypeError(f"unsupported OPH base {type(base)}")
        return dict(scheme="oph", family=fam, k=family.k, s=family.s,
                    densify=family.densify,
                    variant=getattr(base, "variant", "high"))
    if isinstance(family, Hash2U):
        return dict(scheme="minhash", family="2u", k=family.k, s=family.s,
                    variant=family.variant)
    if isinstance(family, Hash4U):
        return dict(scheme="minhash", family="4u", k=family.k, s=family.s)
    raise TypeError(
        f"SignatureEngine supports 2U/4U/OPH families, got {type(family)}")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class SignatureEngine:
    """Signature computation for one hash family on the family's device.

    The backend follows the device: ``cuda`` for a CUDA family, ``torch``
    (the plain versions) for a CPU one.  ``signatures`` returns (n, k)
    int32 values (b-bit masked when b > 0); ``packed_signatures`` returns
    ``PackedSignatures``, packed in the minhash kernels' epilogue where
    alignment allows.
    """

    def __init__(self, family, *, b: int = 0, packed: bool = False):
        self.family_obj = family
        self.statics = _family_statics(family)
        self.device = family.device
        self.b = b
        self.packed = packed
        self.backend = backend_for(self.device).name
        if packed:
            PackSpec(self.statics["k"], b,
                     self.statics.get("densify") == "sentinel")  # validate b
        key = (self.statics["scheme"], self.statics["family"])
        if key not in _RUNNERS:
            raise TypeError(f"no runner for scheme/family {key}")
        self._runner = _RUNNERS[key]
        self.plan = SignaturePlan(b=b, packed=packed, **self.statics)

    def _run(self, batch: SparseBatch, packed: bool):
        if same_device(batch.indices, batch.mask) != self.device:
            raise ValueError(f"batch on {batch.device}, family on {self.device}")
        return self._runner(self, batch, self.plan, packed=packed)

    def signatures(self, batch: SparseBatch) -> torch.Tensor:
        """(n, k) int32 signature values (b-bit masked when b > 0)."""
        return self._run(batch, packed=False)

    def packed_signatures(self, batch: SparseBatch) -> PackedSignatures:
        """The packed wire format: k*code_bits bits per example."""
        plan = self.plan
        return PackedSignatures(self._run(batch, packed=True), plan.k, plan.b,
                                plan.sentinel)

    def __call__(self, batch: SparseBatch):
        return self.packed_signatures(batch) if self.packed \
            else self.signatures(batch)


def _run_minhash(eng, batch, plan, *, packed):
    fam = eng.family_obj
    counts = batch.nnz_per_row()
    if plan.family == "2u":
        run = lambda **kw: kmin.minhash2u(batch.indices, counts, fam.a1,
                                          fam.a2, s=plan.s, b=plan.b,
                                          variant=plan.variant, **kw)
    else:
        run = lambda **kw: kmin.minhash4u(batch.indices, counts, fam.a,
                                          s=plan.s, b=plan.b, **kw)
    blk_k = kmin.MINHASH_BLK_K
    k_pad = -(-plan.k // blk_k) * blk_k
    if packed and can_pack_in_kernel(k_pad, plan.k, plan.b, blk_k):
        return run(pack=True)[1]
    out = run()
    return pack_device(out, PackSpec(plan.k, plan.b)) if packed else out


def _run_oph(eng, batch, plan, *, packed):
    base = eng.family_obj.base
    counts = batch.nnz_per_row()
    bin_bits = plan.k.bit_length() - 1
    # packed sentinel: the kernel's epilogue emits the (b+1)-bit codes and
    # only the bitstream pack remains; otherwise raw minima + epilogue
    coded = packed and plan.sentinel
    code_b = plan.b if coded else 0
    if plan.family == "2u":
        raw = koph.oph2u(batch.indices, counts, base.a1, base.a2, s=plan.s,
                         bin_bits=bin_bits, variant=plan.variant,
                         code_b=code_b)
    else:
        raw = koph.oph4u(batch.indices, counts, base.a, s=plan.s,
                         bin_bits=bin_bits, code_b=code_b)
    return oph_epilogue(raw, k=plan.k, s=plan.s, bin_bits=bin_bits,
                        densify=plan.densify, b=plan.b, packed=packed,
                        coded=coded)


def oph_epilogue(raw: torch.Tensor, *, k: int, s: int, bin_bits: int,
                 densify: str, b: int, packed: bool = False,
                 coded: bool = False) -> torch.Tensor:
    """Slice to k bins, densify, keep b bits, optionally pack; shares
    ``densify_and_bbit`` with the reference so both stay bit-exact.
    ``coded=True``: the kernel already emitted sentinel codes."""
    sig = raw[:, :k]
    spec = PackSpec(k, b, sentinel=(densify == "sentinel")) if packed else None
    if coded:
        return pack_codes(sig, spec.code_bits)
    sig = densify_and_bbit(sig, 1 << (s - bin_bits), densify, b)
    return pack_device(sig, spec) if packed else sig


def _run_oph_perm(eng, batch, plan, *, packed):
    # permutation base: the gold-standard plain reference (small D only)
    sig = oph_signatures(batch.indices, batch.mask, eng.family_obj, b=plan.b)
    return pack_device(sig, plan.pack_spec) if packed else sig


_RUNNERS = {
    ("minhash", "2u"): _run_minhash,
    ("minhash", "4u"): _run_minhash,
    ("oph", "2u"): _run_oph,
    ("oph", "4u"): _run_oph,
    ("oph", "perm"): _run_oph_perm,
}


def batch_signatures(batch: SparseBatch, family, *, b: int = 0,
                     packed: bool = False):
    """Signatures of a SparseBatch through a ``SignatureEngine``;
    ``packed=True`` returns ``PackedSignatures``."""
    return SignatureEngine(family, b=b, packed=packed)(batch)
