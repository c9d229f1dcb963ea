"""k-pass minwise-hash signatures: the CUDA kernels and their plain
versions (port of ``repro.kernels.minhash``), the paper's §3 kernel.

``minhash2u`` / ``minhash4u`` take ``indices (n, nnz) int32``, ``counts
(n,) int32`` and k hash functions, and return the (n, k) minima as int32
uint32 bit patterns -- masked to b bits when ``b > 0``; with ``pack=True``
also the (n, k*b/32) packed words of the fused epilogue, as
``(sig, words)``.

CPU tensors go to the plain versions, CUDA tensors to the kernels of
``csrc/minhash.cu``.  Each CUDA wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import hash2u_apply, hash4u_apply
from repro_torch.core.u32 import EMPTY, narrow
from repro_torch.device import same_device
from repro_torch.kernels import build
from repro_torch.kernels.oph import _PLAIN_ELEMS, check_cuda_args
from repro_torch.kernels.pack import pack_block

# threads per block, a multiple of 32: four hash functions each (strided
# by this) in 4U; in 2U one when k <= 128 (k rounded up to 32 threads),
# else four, so that one block covers a row's k <= 512 functions; the
# fused pack packs groups of this many codes
MINHASH_BLK_K = 128


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

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
        _check_pack(b, k)
        return out, pack_block(out, b)
    return out


def minhash2u_plain(indices, counts, a1, a2, *, s: int, b: int = 0,
                    variant: str = "high", pack: bool = False):
    """Plain PyTorch ``minhash2u``."""
    fn = lambda t: hash2u_apply(t, a1, a2, s, variant)
    return _minhash_plain(fn, indices, counts, a1.shape[0], b=b, pack=pack)


def minhash4u_plain(indices, counts, a, *, s: int, b: int = 0,
                    pack: bool = False):
    """Plain PyTorch ``minhash4u``; ``a`` is (4, k)."""
    fn = lambda t: hash4u_apply(t, a[0], a[1], a[2], a[3], s)
    return _minhash_plain(fn, indices, counts, a.shape[1], b=b, pack=pack)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_pack(b: int, k: int) -> None:
    if b <= 0 or 32 % b or b > 16 or k % MINHASH_BLK_K:
        raise ValueError(f"fused pack needs b | 32, b <= 16 and k a multiple "
                         f"of {MINHASH_BLK_K}; got b={b}, k={k}")


def _outputs(name, dev, n, k, b, pack):
    if not 0 <= b <= 32:
        raise ValueError(f"{name}: b must be in [0, 32], got {b}")
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    words = None
    if pack:
        _check_pack(b, k)
        words = torch.empty((n, k * b // 32), dtype=torch.int32, device=dev)
    return out, words


def minhash2u_cuda(indices, counts, a1, a2, *, s: int, b: int = 0,
                   variant: str = "high", pack: bool = False):
    """Launch ``minhash2u_launch`` (csrc/minhash.cu) on the current stream."""
    n, nnz = indices.shape
    k = a1.shape[0]
    dev = check_cuda_args("minhash2u", {"indices": (n, nnz), "counts": (n,),
                                        "a1": (k,), "a2": (k,)},
                          indices=indices, counts=counts, a1=a1, a2=a2)
    if not 1 <= s <= 32:
        raise ValueError(f"minhash2u: need 1 <= s <= 32, got {s}")
    if variant not in ("high", "low"):
        raise ValueError(f"minhash2u: variant must be 'high' or 'low', got {variant!r}")
    out, words = _outputs("minhash2u", dev, n, k, b, pack)
    if n and k:
        with torch.cuda.device(dev):
            status = build.library("minhash").minhash2u_launch(
                indices.data_ptr(), counts.data_ptr(), n, nnz, a1.data_ptr(),
                a2.data_ptr(), k, s, int(variant == "high"), b, out.data_ptr(),
                words.data_ptr() if pack else None,
                words.shape[1] if pack else 0, MINHASH_BLK_K,
                build.stream_handle(dev))
        build.check(status, "minhash2u")
        build.count_launch(minhash2u_cuda)
    return (out, words) if pack else out


def minhash4u_cuda(indices, counts, a, *, s: int, b: int = 0,
                   pack: bool = False):
    """Launch ``minhash4u_launch`` (csrc/minhash.cu); ``a`` is (4, k)."""
    n, nnz = indices.shape
    k = a.shape[1]
    dev = check_cuda_args("minhash4u", {"indices": (n, nnz), "counts": (n,),
                                        "a": (4, k)},
                          indices=indices, counts=counts, a=a)
    if not 1 <= s <= 31:
        raise ValueError(f"minhash4u: need 1 <= s <= 31, got {s}")
    out, words = _outputs("minhash4u", dev, n, k, b, pack)
    if n and k:
        with torch.cuda.device(dev):
            status = build.library("minhash").minhash4u_launch(
                indices.data_ptr(), counts.data_ptr(), n, nnz, a.data_ptr(), k,
                s, b, out.data_ptr(), words.data_ptr() if pack else None,
                words.shape[1] if pack else 0, MINHASH_BLK_K,
                build.stream_handle(dev))
        build.check(status, "minhash4u")
        build.count_launch(minhash4u_cuda)
    return (out, words) if pack else out


minhash2u_cuda.launches = 0
minhash4u_cuda.launches = 0


# ---------------------------------------------------------------------------
# Dispatch on the tensors' device
# ---------------------------------------------------------------------------

def minhash2u(indices, counts, a1, a2, *, s: int, b: int = 0,
              variant: str = "high", pack: bool = False):
    """2U minhash signatures: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if same_device(indices, counts, a1, a2).type == "cpu":
        return minhash2u_plain(indices, counts, a1, a2, s=s, b=b,
                               variant=variant, pack=pack)
    return minhash2u_cuda(indices, counts, a1, a2, s=s, b=b, variant=variant,
                          pack=pack)


def minhash4u(indices, counts, a, *, s: int, b: int = 0, pack: bool = False):
    """4U minhash signatures (Mersenne BitMod); see ``minhash2u``."""
    if same_device(indices, counts, a).type == "cpu":
        return minhash4u_plain(indices, counts, a, s=s, b=b, pack=pack)
    return minhash4u_cuda(indices, counts, a, s=s, b=b, pack=pack)
