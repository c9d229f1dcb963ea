"""Batch preprocessing: raw shards -> packed ``.sig`` shards (port of
``repro.data.preprocess``), the paper's §3 batch entry point.

Raw sparse shards stream through the signature engine in chunks; each
chunk becomes one bit-packed ``.sig`` shard (k*b bits per example, sentinel
OPH as (b+1)-bit codes), and the three phases -- load / kernel / store --
are timed as Figures 1-3 split them.  The engine runs on the family's
device: the CUDA kernels for a family on the card, the plain versions for
one on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.hashing import Hash2U, Hash4U
from repro_torch.core.oph import OPH
from repro_torch.core.u32 import to_numpy
from repro_torch.data.pipeline import ChunkedLoader
from repro_torch.data.sigshard import read_sig_shard, write_sig_shard
from repro_torch.kernels import SignatureEngine


@dataclasses.dataclass
class PreprocessStats:
    examples: int = 0
    load_s: float = 0.0
    kernel_s: float = 0.0
    store_s: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0

    def reduction(self) -> float:
        return self.bytes_in / max(self.bytes_out, 1)


def preprocess_shards(shard_paths: Sequence[str], out_dir: str, family, *,
                      b: int = 8, chunk_size: int = 10_000,
                      n_workers: int = 1,
                      loader_kwargs: Optional[dict] = None
                      ) -> PreprocessStats:
    """Run the full preprocessing pipeline; returns phase accounting.

    family: Hash2U / Hash4U (k-pass minwise hashing) or an ``OPH`` scheme
    over a 2U/4U base -- no permutation matrices at scale (their storage is O(k*D)).
    ``kernel_s`` ends with a ``torch.cuda.synchronize`` on the card.
    """
    if isinstance(family, OPH):
        if not isinstance(family.base, (Hash2U, Hash4U)):
            raise TypeError("production OPH preprocessing uses 2U/4U bases")
    elif not isinstance(family, (Hash2U, Hash4U)):
        raise TypeError("production preprocessing uses 2U/4U/OPH families")
    engine = SignatureEngine(family, b=b, packed=True)
    dev = engine.device
    os.makedirs(out_dir, exist_ok=True)
    stats = PreprocessStats()
    loader = ChunkedLoader(shard_paths, chunk_size=chunk_size,
                           n_workers=n_workers, device=dev,
                           **(loader_kwargs or {}))
    t_mark = time.perf_counter()
    for idx, chunk in enumerate(loader):
        t_loaded = time.perf_counter()
        stats.load_s += t_loaded - t_mark
        stats.examples += chunk.n
        stats.bytes_in += chunk.nbytes()

        packed = engine.packed_signatures(chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_kernel = time.perf_counter()
        stats.kernel_s += t_kernel - t_loaded

        out_path = os.path.join(out_dir, f"sig_{idx:05d}.sig")
        labels = (chunk.labels.cpu().numpy() if chunk.labels is not None
                  else torch.zeros(chunk.n).numpy())
        write_sig_shard(out_path, to_numpy(packed.data), labels,
                        k=packed.k, b=packed.b, code_bits=packed.code_bits,
                        sentinel=packed.sentinel)
        stats.bytes_out += os.path.getsize(out_path)
        t_mark = time.perf_counter()
        stats.store_s += t_mark - t_kernel
    return stats


def read_signature_shard(path: str):
    """Load a plain b-bit ``.sig`` shard: (uint32 words (n, words), labels,
    k, b).  Refuses sentinel/(b+1)-bit shards, whose words this 4-tuple
    cannot describe; use ``repro_torch.data.sigshard.read_sig_shard``."""
    words, labels, meta = read_sig_shard(path)
    if meta.sentinel or meta.code_bits != meta.b:
        raise ValueError(
            f"{path}: {meta.code_bits}-bit"
            f"{' sentinel' if meta.sentinel else ''} codes cannot be "
            "decoded through the (words, labels, k, b) contract; "
            "use repro_torch.data.sigshard.read_sig_shard")
    return words, labels, meta.k, meta.b
