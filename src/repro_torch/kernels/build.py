"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edit
rebuilds and a rerun reuses the library.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them; ``hamming.cu``,
whose output tiles are instantiated several times over, also splits its
own compilation across the host's cores (``EXTRA_FLAGS``).  Every C entry
returns ``cudaGetLastError()``; ``check`` raises on anything but 0.
Nothing is built at import time; each kernel module registers its
launchers as operators (``kernel_op``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels for a source checkout (src/repro_torch/...)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("oph", "minhash", "hamming", "sigbag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per source, after NVCC_FLAGS: hamming.cu instantiates 52 kernels (11
# code-width variants of swar_kernel and 2 of straddle_kernel, 4 output
# tiles each), so nvcc splits their optimisation over the host's cores
EXTRA_FLAGS = {"hamming": ("--split-compile=0",)}


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
# argtypes of every C entry: pointers and the stream as c_void_p
SIGNATURES = {
    "oph": {
        "oph2u_launch": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P],
        "oph4u_launch": [_P, _P, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    },
    "minhash": {
        "minhash2u_launch": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                             _I, _I, _P],
        "minhash4u_launch": [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I,
                             _P],
    },
    "hamming": {
        "packed_match_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _U,
                                _P, _P, _P],
        "packed_match_tiled_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U,
                                      _U, _I, _I, _P, _P, _P],
    },
    "sigbag": {
        "sigbag_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "sigbag_shard_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
        "sigbag_plan": [_P, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every source not yet built, all ``nvcc`` runs in parallel.

    Returns the wall seconds of each build (0.0 where the library was
    already there).  Raises with the compiler's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *flags(name), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, path) -> ctypes.CDLL:
    """Load a shared library built from a ``<name>.cu`` (this checkout's or
    another's with the same C interface) and declare its C entries."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        entry = getattr(lib, fn, None)
        if entry is None:          # an older checkout's library lacks it
            continue
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, or
    the one ``install`` gave."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = load(name, _lib_path(name))
        return lib


def install(name: str, lib: ctypes.CDLL) -> None:
    """Send the wrappers of ``csrc/<name>.cu`` to ``lib`` from now on (for
    timing another checkout's kernel through this checkout's wrappers)."""
    with _LOCK:
        _LIBS[name] = lib


# the kernels as operators of the "repro_torch" namespace (``kernel_op``)
_OPS = torch.library.Library("repro_torch", "FRAGMENT")


def kernel_op(schema: str, launch, outputs):
    """Register the operator ``repro_torch::<schema>`` and return it:
    ``launch`` runs it on CUDA tensors (allocates its results, launches
    the kernel, counts the launch), ``outputs`` on meta and fake tensors
    (allocates the same results; no library, no launch).  A dispatch mode
    sees a call as one operation with its operands and results, as XLA
    sees a custom call; CPU tensors have no kernel."""
    name = schema.split("(", 1)[0]
    _OPS.define(schema)
    _OPS.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", outputs, lib=_OPS)
    return getattr(torch.ops.repro_torch, name).default


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under one process-wide lock.

    Several dispatch threads launch through one wrapper at once; a bare
    ``+= 1`` on the attribute is a read-modify-write that can lose an
    increment between threads.  Readers read the attribute and resetters
    assign 0 to it, both single operations.
    """
    with _COUNT_LOCK:
        wrapper.launches += 1


def stream_handle(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int for ``c_void_p``."""
    return torch.cuda.current_stream(device).cuda_stream
