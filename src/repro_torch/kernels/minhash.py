"""k-pass minwise-hash signatures: the CUDA kernels and their plain
versions (port of ``repro.kernels.minhash``), the paper's §3 kernel.

``minhash2u`` / ``minhash4u`` take ``indices (n, nnz) int32``, ``counts
(n,) int32`` and k hash functions, and return the (n, k) minima as int32
uint32 bit patterns -- masked to b bits when ``b > 0``; with ``pack=True``
(b | 32, b <= 16, any k) also the (n, ceil(k*b/32)) packed words of the
fused epilogue, zero padded past k, as ``(sig, words)``.  ``threads`` is
the kernel's launch shape (the group size, ``MINHASH_BLK_K`` by default;
a ``TuningTable`` entry may name another): any multiple of 32 in [32,
1024], checked before the device dispatch, so a bad value raises on CPU
tensors too.  The plain versions take it and compute the same values
whatever it is.

CPU tensors go to the plain versions, CUDA tensors to the kernels of
``csrc/minhash.cu``.  Each CUDA wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.bbit import packed_words
from repro_torch.core.hashing import hash2u_apply, hash4u_apply
from repro_torch.core.u32 import EMPTY, narrow
from repro_torch.device import same_device
from repro_torch.kernels import build
from repro_torch.kernels.oph import _PLAIN_ELEMS, check_cuda_args
from repro_torch.kernels.pack import pack_block

# threads per block by default, a multiple of 32: four hash functions each
# (strided by this) in 4U; in 2U one when k <= 128 (k rounded up to 32
# threads), else four, so that one block covers a row's k <= 512
# functions
MINHASH_BLK_K = 128
# every group size a launch may take (a TuningTable entry may name any)
MINHASH_THREADS = tuple(range(32, 1025, 32))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def check_threads(name: str, threads) -> int:
    """Raise ``ValueError`` unless ``threads`` is in ``MINHASH_THREADS``."""
    if isinstance(threads, bool) or threads not in MINHASH_THREADS:
        raise ValueError(f"{name}: threads must be a multiple of 32 in "
                         f"[32, 1024], got {threads!r}")
    return int(threads)


def _minhash_plain(hash_fn, indices, counts, k, *, b, pack):
    """Row-chunked so the (rows, nnz, k) int64 hash tensor stays <= 1 GB."""
    n, nnz = indices.shape
    counts = counts.reshape(-1).to(torch.int64)
    col = torch.arange(nnz, device=indices.device)
    outs = []
    step = max(1, _PLAIN_ELEMS // max(1, nnz * k))
    for r0 in range(0, n, step):
        idx = indices[r0:r0 + step]
        valid = col[None, :] < counts[r0:r0 + step, None]
        h = torch.where(valid[..., None], hash_fn(idx[..., None]), EMPTY)
        outs.append(h.min(dim=1).values if nnz else
                    torch.full((idx.shape[0], k), EMPTY, device=idx.device))
    out = (torch.cat(outs) if outs else
           torch.empty((0, k), dtype=torch.int64, device=indices.device))
    if b > 0:
        out = out & ((1 << b) - 1)
    out = narrow(out)
    if pack:
        _check_pack(b)
        return out, pack_block(out, b)
    return out


def minhash2u_plain(indices, counts, a1, a2, *, s: int, b: int = 0,
                    variant: str = "high", pack: bool = False,
                    threads: int = MINHASH_BLK_K):
    """Plain PyTorch ``minhash2u``."""
    check_threads("minhash2u", threads)
    fn = lambda t: hash2u_apply(t, a1, a2, s, variant)
    return _minhash_plain(fn, indices, counts, a1.shape[0], b=b, pack=pack)


def minhash4u_plain(indices, counts, a, *, s: int, b: int = 0,
                    pack: bool = False, threads: int = MINHASH_BLK_K):
    """Plain PyTorch ``minhash4u``; ``a`` is (4, k)."""
    check_threads("minhash4u", threads)
    fn = lambda t: hash4u_apply(t, a[0], a[1], a[2], a[3], s)
    return _minhash_plain(fn, indices, counts, a.shape[1], b=b, pack=pack)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def can_fuse_pack(b: int) -> bool:
    """True when the kernels' epilogue can pack b-bit codes: lane-aligned
    codes (b | 32), b <= 16.  Any k and launch shape: a ragged last warp
    packs its live codes and zero padding."""
    return 0 < b <= 16 and 32 % b == 0


def _check_pack(b: int) -> None:
    if not can_fuse_pack(b):
        raise ValueError(f"fused pack needs b | 32 and b <= 16, got b={b}")


def _check_b(name: str, b: int) -> None:
    if not 0 <= b <= 32:
        raise ValueError(f"{name}: b must be in [0, 32], got {b}")


def _outputs(indices, k: int, b: int, pack: bool):
    """The signatures (n, k) and the packed words (n, ceil(k * b / 32);
    no columns without ``pack``) a launch writes."""
    n = indices.shape[0]
    new = lambda cols: torch.empty((n, cols), dtype=torch.int32,
                                   device=indices.device)
    return new(k), new(packed_words(k, b) if pack else 0)


def _minhash2u_launch(indices, counts, a1, a2, s, high, b, pack, threads):
    out, words = _outputs(indices, a1.shape[0], b, pack)
    (n, nnz), k = indices.shape, a1.shape[0]
    if n and k:
        dev = indices.device
        with torch.cuda.device(dev):
            status = build.library("minhash").minhash2u_launch(
                indices.data_ptr(), counts.data_ptr(), n, nnz, a1.data_ptr(),
                a2.data_ptr(), k, s, int(high), b, out.data_ptr(),
                words.data_ptr() if pack else None,
                words.shape[1] if pack else 0, threads,
                build.stream_handle(dev))
        build.check(status, "minhash2u")
        build.count_launch(minhash2u_cuda)
    return out, words


def _minhash4u_launch(indices, counts, a, s, b, pack, threads):
    out, words = _outputs(indices, a.shape[1], b, pack)
    (n, nnz), k = indices.shape, a.shape[1]
    if n and k:
        dev = indices.device
        with torch.cuda.device(dev):
            status = build.library("minhash").minhash4u_launch(
                indices.data_ptr(), counts.data_ptr(), n, nnz, a.data_ptr(), k,
                s, b, out.data_ptr(), words.data_ptr() if pack else None,
                words.shape[1] if pack else 0, threads,
                build.stream_handle(dev))
        build.check(status, "minhash4u")
        build.count_launch(minhash4u_cuda)
    return out, words


_MINHASH2U = build.kernel_op(
    "minhash2u(Tensor indices, Tensor counts, Tensor a1, Tensor a2, int s, "
    "bool high, int b, bool pack, int threads) -> (Tensor, Tensor)",
    _minhash2u_launch,
    lambda indices, counts, a1, a2, s, high, b, pack, threads:
        _outputs(indices, a1.shape[0], b, pack))
_MINHASH4U = build.kernel_op(
    "minhash4u(Tensor indices, Tensor counts, Tensor a, int s, int b, "
    "bool pack, int threads) -> (Tensor, Tensor)",
    _minhash4u_launch,
    lambda indices, counts, a, s, b, pack, threads:
        _outputs(indices, a.shape[1], b, pack))


def minhash2u_cuda(indices, counts, a1, a2, *, s: int, b: int = 0,
                   variant: str = "high", pack: bool = False,
                   threads: int = MINHASH_BLK_K):
    """Launch ``minhash2u_launch`` (csrc/minhash.cu) on the current stream
    with groups of ``threads`` (the operator ``repro_torch::minhash2u``)."""
    n, nnz = indices.shape
    k = a1.shape[0]
    threads = check_threads("minhash2u", threads)
    check_cuda_args("minhash2u", {"indices": (n, nnz), "counts": (n,),
                                  "a1": (k,), "a2": (k,)},
                    indices=indices, counts=counts, a1=a1, a2=a2)
    if not 1 <= s <= 32:
        raise ValueError(f"minhash2u: need 1 <= s <= 32, got {s}")
    if variant not in ("high", "low"):
        raise ValueError(f"minhash2u: variant must be 'high' or 'low', got {variant!r}")
    _check_b("minhash2u", b)
    if pack:
        _check_pack(b)
    out, words = _MINHASH2U(indices, counts, a1, a2, s, variant == "high",
                            b, pack, threads)
    return (out, words) if pack else out


def minhash4u_cuda(indices, counts, a, *, s: int, b: int = 0,
                   pack: bool = False, threads: int = MINHASH_BLK_K):
    """Launch ``minhash4u_launch`` (csrc/minhash.cu); ``a`` is (4, k) (the
    operator ``repro_torch::minhash4u``)."""
    n, nnz = indices.shape
    k = a.shape[1]
    threads = check_threads("minhash4u", threads)
    check_cuda_args("minhash4u", {"indices": (n, nnz), "counts": (n,),
                                  "a": (4, k)},
                    indices=indices, counts=counts, a=a)
    if not 1 <= s <= 31:
        raise ValueError(f"minhash4u: need 1 <= s <= 31, got {s}")
    _check_b("minhash4u", b)
    if pack:
        _check_pack(b)
    out, words = _MINHASH4U(indices, counts, a, s, b, pack, threads)
    return (out, words) if pack else out


minhash2u_cuda.launches = 0
minhash4u_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch on the tensors' device
# ---------------------------------------------------------------------------

def minhash2u(indices, counts, a1, a2, *, s: int, b: int = 0,
              variant: str = "high", pack: bool = False,
              threads: int = MINHASH_BLK_K):
    """2U minhash signatures: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = (minhash2u_plain if same_device(indices, counts, a1, a2).type == "cpu"
          else minhash2u_cuda)
    return fn(indices, counts, a1, a2, s=s, b=b, variant=variant, pack=pack,
              threads=threads)


def minhash4u(indices, counts, a, *, s: int, b: int = 0, pack: bool = False,
              threads: int = MINHASH_BLK_K):
    """4U minhash signatures (Mersenne BitMod); see ``minhash2u``."""
    fn = (minhash4u_plain if same_device(indices, counts, a).type == "cpu"
          else minhash4u_cuda)
    return fn(indices, counts, a, s=s, b=b, pack=pack, threads=threads)
