"""One Permutation Hashing bin minima: the CUDA kernels and their plain
versions (port of ``repro.kernels.oph``).

``oph2u`` / ``oph4u`` take a padded batch ``indices (n, nnz) int32`` with
per-row valid counts ``counts (n,) int32`` and ONE 2U / 4U hash function,
and return ``(n, 2^bin_bits)`` int32 uint32 bit patterns: the minimum
in-bin offset of each bin, EMPTY (0xFFFFFFFF) where a bin got no element,
or with ``code_b > 0`` the (code_b+1)-bit sentinel codes (EMPTY -> 2^code_b).

They dispatch on the tensors' device: CPU tensors go to the plain PyTorch
versions (``*_plain``), CUDA tensors to the kernels of ``csrc/oph.cu``
(``*_cuda``, which raise on anything they do not take).  Each CUDA wrapper
counts its launches in ``<wrapper>.launches``.  ``threads`` is the launch
shape: 2U's block size, ``OPH_THREADS`` by default (a ``TuningTable``
entry may name another multiple of 64 up to 1024), checked before the
device dispatch; the plain versions take it and compute the same values.  Unlike the TPU kernels no
bin padding to 128 lanes is kept: the output has exactly k columns.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import hash2u_apply, hash4u_apply
from repro_torch.core.oph import binned_min, split_hash
from repro_torch.core.u32 import EMPTY, narrow
from repro_torch.device import same_device
from repro_torch.kernels import build

# threads per block (one block per row) of 2U, a multiple of 64 (oph.cu's
# launcher rejects any other); 4U runs OPH_THREADS // 2 threads with twice
# the 16-byte loads each (oph.cu's OPH_VPT = 4 for 2U, 8 for 4U)
OPH_THREADS = 256
# every block size a launch may take (a TuningTable entry may name any)
OPH_THREAD_CHOICES = tuple(range(64, 1025, 64))
MAX_BIN_BITS = 13     # k <= 8192 bins: 32 KB of shared memory per block
_PLAIN_ELEMS = 1 << 27   # int64 elements per plain-version row chunk (1 GB)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _oph_plain(hash_fn, indices, counts, *, s, bin_bits, code_b):
    n, nnz = indices.shape
    counts = counts.reshape(-1).to(torch.int64)
    col = torch.arange(nnz, device=indices.device)
    outs = []
    step = max(1, _PLAIN_ELEMS // max(1, nnz))
    for r0 in range(0, n, step):
        idx = indices[r0:r0 + step]
        valid = col[None, :] < counts[r0:r0 + step, None]
        bins, offs = split_hash(hash_fn(idx), s, bin_bits)
        sig = binned_min(bins, offs, valid, 1 << bin_bits)
        if code_b > 0:
            sig = torch.where(sig == EMPTY, 1 << code_b, sig & ((1 << code_b) - 1))
        outs.append(sig)
    if not outs:
        return torch.empty((0, 1 << bin_bits), dtype=torch.int32,
                           device=indices.device)
    return narrow(torch.cat(outs))


def check_threads(name: str, threads) -> int:
    """Raise ``ValueError`` unless ``threads`` is in ``OPH_THREAD_CHOICES``."""
    if isinstance(threads, bool) or threads not in OPH_THREAD_CHOICES:
        raise ValueError(f"{name}: threads must be a multiple of 64 in "
                         f"[64, 1024], got {threads!r}")
    return int(threads)


def oph2u_plain(indices, counts, a1, a2, *, s: int, bin_bits: int,
                variant: str = "high", code_b: int = 0,
                threads: int = OPH_THREADS) -> torch.Tensor:
    """Plain PyTorch ``oph2u``: raw (or sentinel-coded) bin minima."""
    check_threads("oph2u", threads)
    fn = lambda idx: hash2u_apply(idx, a1[0], a2[0], s, variant)
    return _oph_plain(fn, indices, counts, s=s, bin_bits=bin_bits,
                      code_b=code_b)


def oph4u_plain(indices, counts, a, *, s: int, bin_bits: int,
                code_b: int = 0, threads: int = OPH_THREADS) -> torch.Tensor:
    """Plain PyTorch ``oph4u``; ``a`` is (4, 1)."""
    check_threads("oph4u", threads)
    fn = lambda idx: hash4u_apply(idx, a[0, 0], a[1, 0], a[2, 0], a[3, 0], s)
    return _oph_plain(fn, indices, counts, s=s, bin_bits=bin_bits,
                      code_b=code_b)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def check_cuda_args(name: str, shapes: dict, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA int32 tensor of the
    given shape (None in a shape matches any size) on one device."""
    dev = same_device(*tensors.values())
    if dev.type not in ("cuda", "meta"):   # meta: a trace's shapes only
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {dev}")
    for key, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = shapes[key]
        if t.dim() != len(want) or any(w is not None and w != g
                                       for w, g in zip(want, t.shape)):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    return dev


def _check_oph_statics(name, s, bin_bits, code_b):
    if not 1 <= s <= 31:
        raise ValueError(f"{name}: OPH needs 1 <= s <= 31, got {s}")
    if not 0 <= bin_bits <= min(s, MAX_BIN_BITS):
        raise ValueError(f"{name}: need 0 <= bin_bits <= min(s, "
                         f"{MAX_BIN_BITS}), got {bin_bits}")
    if not 0 <= code_b <= 16:
        raise ValueError(f"{name}: code_b must be in [0, 16], got {code_b}")


def _oph_output(indices, bin_bits: int) -> torch.Tensor:
    return torch.empty((indices.shape[0], 1 << bin_bits), dtype=torch.int32,
                       device=indices.device)


def _oph2u_launch(indices, counts, a1, a2, s, bin_bits, high, code_b,
                  threads):
    out = _oph_output(indices, bin_bits)
    n, nnz = indices.shape
    if n == 0:
        return out
    dev = indices.device
    with torch.cuda.device(dev):
        status = build.library("oph").oph2u_launch(
            indices.data_ptr(), counts.data_ptr(), n, nnz, a1.data_ptr(),
            a2.data_ptr(), s, bin_bits, int(high), code_b,
            out.data_ptr(), threads, build.stream_handle(dev))
    build.check(status, "oph2u")
    build.count_launch(oph2u_cuda)
    return out


def _oph4u_launch(indices, counts, a, s, bin_bits, code_b, threads):
    out = _oph_output(indices, bin_bits)
    n, nnz = indices.shape
    if n == 0:
        return out
    dev = indices.device
    with torch.cuda.device(dev):
        status = build.library("oph").oph4u_launch(
            indices.data_ptr(), counts.data_ptr(), n, nnz, a.data_ptr(), s,
            bin_bits, code_b, out.data_ptr(), threads,
            build.stream_handle(dev))
    build.check(status, "oph4u")
    build.count_launch(oph4u_cuda)
    return out


_OPH2U = build.kernel_op(
    "oph2u(Tensor indices, Tensor counts, Tensor a1, Tensor a2, int s, "
    "int bin_bits, bool high, int code_b, int threads) -> Tensor",
    _oph2u_launch,
    lambda indices, counts, a1, a2, s, bin_bits, high, code_b, threads:
        _oph_output(indices, bin_bits))
_OPH4U = build.kernel_op(
    "oph4u(Tensor indices, Tensor counts, Tensor a, int s, int bin_bits, "
    "int code_b, int threads) -> Tensor",
    _oph4u_launch,
    lambda indices, counts, a, s, bin_bits, code_b, threads:
        _oph_output(indices, bin_bits))


def oph2u_cuda(indices, counts, a1, a2, *, s: int, bin_bits: int,
               variant: str = "high", code_b: int = 0,
               threads: int = OPH_THREADS) -> torch.Tensor:
    """Launch ``oph2u_launch`` (csrc/oph.cu) on the current stream, a block
    of ``threads`` a row (the operator ``repro_torch::oph2u``)."""
    n, nnz = indices.shape
    threads = check_threads("oph2u", threads)
    check_cuda_args("oph2u", {"indices": (n, nnz), "counts": (n,),
                              "a1": (1,), "a2": (1,)},
                    indices=indices, counts=counts, a1=a1, a2=a2)
    _check_oph_statics("oph2u", s, bin_bits, code_b)
    if variant not in ("high", "low"):
        raise ValueError(f"oph2u: variant must be 'high' or 'low', got {variant!r}")
    return _OPH2U(indices, counts, a1, a2, s, bin_bits, variant == "high",
                  code_b, threads)


def oph4u_cuda(indices, counts, a, *, s: int, bin_bits: int,
               code_b: int = 0, threads: int = OPH_THREADS) -> torch.Tensor:
    """Launch ``oph4u_launch`` (csrc/oph.cu), ``threads // 2`` threads a
    row; ``a`` is (4, 1) (the operator ``repro_torch::oph4u``)."""
    n, nnz = indices.shape
    threads = check_threads("oph4u", threads)
    check_cuda_args("oph4u", {"indices": (n, nnz), "counts": (n,),
                              "a": (4, 1)},
                    indices=indices, counts=counts, a=a)
    _check_oph_statics("oph4u", s, bin_bits, code_b)
    return _OPH4U(indices, counts, a, s, bin_bits, code_b, threads)


oph2u_cuda.launches = 0
oph4u_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch on the tensors' device
# ---------------------------------------------------------------------------

def oph2u(indices, counts, a1, a2, *, s: int, bin_bits: int,
          variant: str = "high", code_b: int = 0,
          threads: int = OPH_THREADS) -> torch.Tensor:
    """2U OPH bin minima: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = (oph2u_plain if same_device(indices, counts, a1, a2).type == "cpu"
          else oph2u_cuda)
    return fn(indices, counts, a1, a2, s=s, bin_bits=bin_bits,
              variant=variant, code_b=code_b, threads=threads)


def oph4u(indices, counts, a, *, s: int, bin_bits: int, code_b: int = 0,
          threads: int = OPH_THREADS) -> torch.Tensor:
    """4U OPH bin minima (Mersenne BitMod); see ``oph2u``."""
    fn = (oph4u_plain if same_device(indices, counts, a).type == "cpu"
          else oph4u_cuda)
    return fn(indices, counts, a, s=s, bin_bits=bin_bits, code_b=code_b,
              threads=threads)
