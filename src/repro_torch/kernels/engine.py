"""SignatureEngine: scheme dispatch onto the kernels, and the packed wire
format (port of ``repro.kernels.engine``).

  * ``Backend`` / ``BACKENDS`` -- ``cuda`` runs the hand-written kernels on
    CUDA tensors; ``torch`` runs their plain versions on CPU tensors.  A
    backend never runs on the other device: no silent fallback.
  * ``TuningTable`` -- launch shapes keyed on (backend, scheme, k, nnz
    bucket), saved as JSON in the reference's schema;
    ``default_tuning_table()`` is the process-wide one
    (``$REPRO_TORCH_TUNING_TABLE``, else the packaged
    ``tuning_table.json``, else empty).
  * ``tune()`` -- times candidate launch shapes of one engine on one batch
    (or of ``packed_match`` on one pair of packed operands) and records
    the fastest in a table.
  * ``SignaturePlan`` / ``SignatureEngine`` -- a frozen description of one
    signature computation, its launch shape included, and its execution
    through the ``_RUNNERS`` registry over (minhash | oph) x (2u | 4u |
    perm).
  * ``PackedSignatures`` -- k*code_bits bits per example; sentinel OPH
    packs (b+1)-bit codes with EMPTY as 2^b.

The OPH epilogue (slice, densify, b bits, pack) is plain PyTorch on the
device, as the reference's was plain jnp.  The TPU's padding of rows,
nnz and k to its tiles is gone: kernels take the batch as it is.

Spans: while ``get_tracer().recording()`` (the tracer enabled, or a
``torch.profiler`` running; asked once a call), each call records
``sig.engine`` (args ``scheme``, ``rows``, ``nnz``, ``k``, ``b``,
``threads``, ``shape`` -- ``explicit`` | ``table`` | ``default``, where the
launch shape came from -- and ``pack`` -- ``kernel`` | ``epilogue`` |
``none``) with the children ``sig.plan`` (device and shape checks, the
table lookup), ``sig.counts`` (``nnz_per_row``), ``sig.kernel`` (the
launcher: argument checks, the operator's dispatch, the launch) and
``sig.epilogue`` (the plain-PyTorch work after the kernel; absent where
there is none).  The permutation runner, which runs no kernel, records
``sig.engine`` and ``sig.plan`` only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from pathlib import Path
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
from repro_torch.obs.trace import get_tracer


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
# Launch shapes and the tuning table
# ---------------------------------------------------------------------------

# The default launch shape of each kernel the engine runs, by its table
# scheme: the kernels' module constants.  A shape names the card's launch
# parameter -- the group size of ``minhash.cu``, the block size of
# ``oph.cu`` -- not the TPU's tiles (``blk_n`` / ``blk_t`` / ``blk_k``).
# ``packed_match``'s ``"hamming"`` tiles live in ``kernels/hamming.py``.
DEFAULT_BLOCKS = {
    "minhash2u": {"threads": kmin.MINHASH_BLK_K},
    "minhash4u": {"threads": kmin.MINHASH_BLK_K},
    "oph2u": {"threads": koph.OPH_THREADS},
    "oph4u": {"threads": koph.OPH_THREADS},
}
TABLE_ENV = "REPRO_TORCH_TUNING_TABLE"
PACKAGED_TABLE = Path(__file__).with_name("tuning_table.json")


def nnz_bucket(nnz: int) -> int:
    """Bucket a padded nnz width to the next power of two (>= 128)."""
    return max(128, 1 << max(0, int(nnz) - 1).bit_length())


def check_blocks(scheme: str, blocks: dict) -> int:
    """The ``threads`` of a launch shape for ``scheme``'s kernel; raise
    ``ValueError`` on any other key or on a value the launcher refuses."""
    if not isinstance(blocks, dict) or set(blocks) != {"threads"}:
        raise ValueError(f"{scheme}: a launch shape is {{'threads': t}}, "
                         f"got {blocks!r}")
    check = (kmin.check_threads if scheme.startswith("minhash")
             else koph.check_threads)
    return check(scheme, blocks["threads"])


class TuningTable:
    """Launch shapes keyed on (backend, scheme, k, nnz bucket), in the
    reference's JSON schema (``{"version": 1, "entries": {...}}``, keys
    ``"{backend}/{scheme}/k={k}/nnz<={bucket}"``): given the same entries
    both packages write the same bytes and each loads the other's.

    ``tune()`` fills it on the card; every engine then picks its entries
    up through ``lookup``, and a key it lacks falls back to the default
    shape.  Backends are the port's (``cuda``, ``torch``), so no entry of
    the reference's ``tpu`` / ``interpret`` backends can match.  Schemes
    are the kernels' names (``minhash2u``, ``minhash4u``, ``oph2u``,
    ``oph4u``): the reference keys 2U and 4U alike (``minhash``, ``oph``),
    but on the card they are two kernels, each with its own launch rule
    (2U cuts its block to k rounded up to 32, 4U does not; OPH 4U runs
    half the threads), so one shape need not suit both.
    ``"hamming"`` (``kernels/hamming.py`` ``packed_match``) is keyed on
    the packed word count instead of nnz, as in the reference."""

    def __init__(self, entries: Optional[dict] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, dict] = dict(entries or {})
        self.path = path

    @staticmethod
    def key(backend: str, scheme: str, k: int, bucket: int) -> str:
        return f"{backend}/{scheme}/k={k}/nnz<={bucket}"

    def lookup(self, backend: str, scheme: str, k: int,
               nnz: int) -> Optional[dict]:
        return self.entries.get(self.key(backend, scheme, k, nnz_bucket(nnz)))

    def record(self, backend: str, scheme: str, k: int, nnz: int,
               blocks: dict) -> None:
        self.entries[self.key(backend, scheme, k, nnz_bucket(nnz))] = \
            dict(blocks)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no path given and table has none")
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": self.entries}, f, indent=2,
                      sort_keys=True)
        self.path = path
        return path

    @staticmethod
    def load(path: str) -> "TuningTable":
        with open(path) as f:
            doc = json.load(f)
        return TuningTable(doc.get("entries", {}), path=path)


_DEFAULT_TABLE: Optional[TuningTable] = None


def default_tuning_table() -> TuningTable:
    """The process-wide table, loaded once: ``$REPRO_TORCH_TUNING_TABLE``
    if set (a missing file raises), else the packaged
    ``tuning_table.json`` if there is one, else an empty table.  The
    variable is the port's own, so a table set for the reference
    (``$REPRO_TUNING_TABLE``) never loads here."""
    global _DEFAULT_TABLE
    if _DEFAULT_TABLE is None:
        path = os.environ.get(TABLE_ENV)
        if path:
            _DEFAULT_TABLE = TuningTable.load(path)
        elif PACKAGED_TABLE.exists():
            _DEFAULT_TABLE = TuningTable.load(str(PACKAGED_TABLE))
        else:
            _DEFAULT_TABLE = TuningTable()
    return _DEFAULT_TABLE


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
    threads: Optional[int] = None   # the launch shape (None: no kernel)

    @property
    def sentinel(self) -> bool:
        return self.densify == "sentinel"

    @property
    def blocks(self) -> dict:
        return {} if self.threads is None else {"threads": self.threads}

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
    (the plain versions) for a CPU one.  The launch shape comes from
    ``blocks`` if given, else the ``tuning`` table's entry for (backend,
    scheme, k, nnz bucket) (``default_tuning_table()`` when ``tuning`` is
    None), else the kernel's default; ``plan_for`` resolves it.
    ``signatures`` returns (n, k) int32 values (b-bit masked when b > 0);
    ``packed_signatures`` returns ``PackedSignatures``, packed in the
    minhash kernels' epilogue where the launch's group allows.
    """

    def __init__(self, family, *, b: int = 0, packed: bool = False,
                 blocks: Optional[dict] = None,
                 tuning: Optional[TuningTable] = None):
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
        self.scheme = "".join(key)          # the kernel: "minhash2u", ...
        self._blocks = dict(blocks) if blocks else None
        self._tuning = tuning
        if self._blocks:
            self.plan_for(0)                # an explicit shape fails here

    # -- plan / launch shape --------------------------------------------
    def blocks_for(self, nnz: int) -> dict:
        """The launch shape for a batch ``nnz`` wide: explicit ``blocks``
        > the table's entry > the kernel's default ({} where no kernel
        runs: a permutation base)."""
        return self._shape(nnz)[0]

    def _shape(self, nnz: int):
        """(the launch shape, where it came from: ``explicit`` | ``table``
        | ``default``)."""
        if self._blocks:
            return dict(self._blocks), "explicit"
        if self.scheme not in DEFAULT_BLOCKS:
            return {}, "default"
        table = self._tuning or default_tuning_table()
        hit = table.lookup(self.backend, self.scheme, self.statics["k"], nnz)
        if hit:
            return dict(hit), "table"
        return dict(DEFAULT_BLOCKS[self.scheme]), "default"

    def plan_for(self, nnz: int) -> SignaturePlan:
        return self._plan(nnz)[0]

    def _plan(self, nnz: int):
        blocks, source = self._shape(nnz)
        if self.scheme not in DEFAULT_BLOCKS:
            if blocks:
                raise ValueError(f"{self.scheme} runs no kernel: it takes no "
                                 f"launch shape, got {blocks!r}")
            threads = None
        else:
            threads = check_blocks(self.scheme, blocks)
        return SignaturePlan(b=self.b, packed=self.packed, threads=threads,
                             **self.statics), source

    # -- execution ------------------------------------------------------
    def _checked_plan(self, batch: SparseBatch):
        if same_device(batch.indices, batch.mask) != self.device:
            raise ValueError(f"batch on {batch.device}, family on {self.device}")
        return self._plan(batch.indices.shape[1])

    def _run(self, batch: SparseBatch, packed: bool):
        tracer = get_tracer()
        if not tracer.recording():
            plan = self._checked_plan(batch)[0]
            return plan, self._runner(self, batch, plan, packed=packed,
                                      span=_untraced)
        n, nnz = batch.indices.shape
        with tracer.program_span("sig.engine", args={
                "scheme": self.scheme, "rows": n, "nnz": nnz,
                "k": self.statics["k"], "b": self.b}) as top:
            with tracer.program_span("sig.plan"):
                plan, source = self._checked_plan(batch)
            top.args.update(threads=plan.threads, shape=source,
                            pack=_pack_mode(plan, packed))
            return plan, self._runner(self, batch, plan, packed=packed,
                                      span=tracer.program_span)

    def signatures(self, batch: SparseBatch) -> torch.Tensor:
        """(n, k) int32 signature values (b-bit masked when b > 0)."""
        return self._run(batch, packed=False)[1]

    def packed_signatures(self, batch: SparseBatch) -> PackedSignatures:
        """The packed wire format: k*code_bits bits per example."""
        plan, words = self._run(batch, packed=True)
        return PackedSignatures(words, plan.k, plan.b, plan.sentinel)

    def __call__(self, batch: SparseBatch):
        return self.packed_signatures(batch) if self.packed \
            else self.signatures(batch)


_NO_SPAN = contextlib.nullcontext()


def _untraced(name: str):
    return _NO_SPAN


def _fused_pack(plan: SignaturePlan) -> bool:
    """Whether the minhash kernel's epilogue packs the words: it fills
    groups of the launch's block, as the kernel cuts it."""
    group = kmin.pack_group(plan.family == "4u", plan.k, plan.threads)
    k_pad = -(-plan.k // group) * group
    return can_pack_in_kernel(k_pad, plan.k, plan.b, group)


def _pack_mode(plan: SignaturePlan, packed: bool) -> str:
    """Where a call's pack runs: ``kernel`` | ``epilogue`` | ``none``."""
    if not packed:
        return "none"
    if plan.scheme == "minhash" and _fused_pack(plan):
        return "kernel"
    return "epilogue"


def _run_minhash(eng, batch, plan, *, packed, span):
    fam = eng.family_obj
    with span("sig.counts"):
        counts = batch.nnz_per_row()
    kw = dict(s=plan.s, b=plan.b, threads=plan.threads)
    if plan.family == "2u":
        run = lambda **pk: kmin.minhash2u(batch.indices, counts, fam.a1,
                                          fam.a2, variant=plan.variant,
                                          **kw, **pk)
    else:
        run = lambda **pk: kmin.minhash4u(batch.indices, counts, fam.a, **kw,
                                          **pk)
    if packed and _fused_pack(plan):
        with span("sig.kernel"):
            return run(pack=True)[1]
    with span("sig.kernel"):
        out = run()
    if not packed:
        return out
    with span("sig.epilogue"):
        return pack_device(out, PackSpec(plan.k, plan.b))


def _run_oph(eng, batch, plan, *, packed, span):
    base = eng.family_obj.base
    with span("sig.counts"):
        counts = batch.nnz_per_row()
    bin_bits = plan.k.bit_length() - 1
    # packed sentinel: the kernel's epilogue emits the (b+1)-bit codes and
    # only the bitstream pack remains; otherwise raw minima + epilogue
    coded = packed and plan.sentinel
    code_b = plan.b if coded else 0
    with span("sig.kernel"):
        if plan.family == "2u":
            raw = koph.oph2u(batch.indices, counts, base.a1, base.a2,
                             s=plan.s, bin_bits=bin_bits,
                             variant=plan.variant, code_b=code_b,
                             threads=plan.threads)
        else:
            raw = koph.oph4u(batch.indices, counts, base.a, s=plan.s,
                             bin_bits=bin_bits, code_b=code_b,
                             threads=plan.threads)
    with span("sig.epilogue"):
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


def _run_oph_perm(eng, batch, plan, *, packed, span):
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


# ---------------------------------------------------------------------------
# The tuning loop
# ---------------------------------------------------------------------------

def _time_candidates(candidates, run_one, iters: int,
                     device: torch.device) -> dict:
    """Run each candidate launch shape once untimed (which also builds the
    kernel's library at first use), then ``iters`` times between two
    clock reads, and keep the fastest mean.  On the card the device is
    synchronised before every clock read.  A candidate that fails raises."""
    candidates = [dict(c) for c in candidates]
    if not candidates:
        raise ValueError("tune() needs at least one candidate launch shape")
    if iters < 1:
        raise ValueError(f"tune() needs iters >= 1, got {iters}")
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    best, best_s = None, math.inf
    for blocks in candidates:
        run_one(blocks)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            run_one(blocks)
        sync()
        mean_s = (time.perf_counter() - t0) / iters
        if mean_s < best_s:
            best, best_s = blocks, mean_s
    return best


def tune(engine, batch, candidates, iters: int = 3,
         table: Optional[TuningTable] = None) -> dict:
    """Time candidate launch shapes and record the fastest in a table
    (``table``, else the engine's, else ``default_tuning_table()``);
    returns it.

    Two schemes, as in the reference:
      * ``engine`` a ``SignatureEngine`` and ``batch`` a ``SparseBatch``:
        candidates ``{"threads": t}`` of the engine's kernel, recorded
        under (backend, the kernel's scheme, k, the batch's nnz width);
      * ``engine`` a ``PackSpec`` and ``batch`` a ``(qwords, cwords)`` pair:
        ``packed_match`` output tiles ``{"blk_q": q, "blk_n": n}``,
        recorded under ``"hamming"`` keyed on (k, ``spec.words``).

    The entry goes under the tensors' backend.  On CPU tensors that is
    ``torch``: the plain versions run, whose times say nothing about a
    launch shape (the plain versions compute the same values whatever
    the shape); only a ``cuda`` entry is a measurement of the kernel.
    """
    if isinstance(engine, PackSpec):
        from repro_torch.kernels.hamming import packed_match
        qwords, cwords = batch
        device = same_device(qwords, cwords)
        best = _time_candidates(
            candidates, lambda blocks: packed_match(qwords, cwords, engine,
                                                    blocks=blocks),
            iters, device)
        tab = table or default_tuning_table()
        tab.record(backend_for(device).name, "hamming", engine.k,
                   engine.words, best)
        return best
    if engine.scheme not in DEFAULT_BLOCKS:
        raise ValueError(f"{engine.scheme} runs no kernel: nothing to tune")

    def run_one(blocks):
        SignatureEngine(engine.family_obj, b=engine.b, packed=engine.packed,
                        blocks=blocks)(batch)

    best = _time_candidates(candidates, run_one, iters, engine.device)
    tab = table or engine._tuning or default_tuning_table()
    tab.record(engine.backend, engine.scheme, engine.statics["k"],
               batch.indices.shape[1], best)
    return best
