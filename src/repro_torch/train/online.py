"""Streaming online learning on packed signatures (port of
``repro.train.online``), paper §6.

  * ``SignatureCache`` -- wraps a ``SignatureStream``.  Epoch 0 hashes the
    raw shards (signatures go straight to the SGD step on the device)
    while writing bit-packed ``.sig`` shards (``repro_torch.data.sigshard``,
    byte-identical to the reference's); epochs >= 1 replay them with the
    same prefetch and straggler/IO-retry machinery as ``ChunkedLoader``.
    Packed words go to the device as they are and are unpacked inside
    the SGD step.  ``max_cache_bytes`` bounds the footprint (chunks past
    it are re-hashed on replay), ``ttl_s`` expires shards, and ``close()``
    removes an owned temp cache dir.
  * ``OnlineTrainer`` -- the Bottou SGD / ASGD / logistic epoch loop over
    any ``(signatures, labels)`` source, with per-epoch ``EpochStats``
    (load / kernel / train seconds, bytes read).
  * ``make_family`` -- the switch over the paper's hashing schemes.

Every ``SignatureCache`` exports its footprint and its replay loader's
counters through ``repro_torch.obs`` (``_sigcache_samples``,
``loader_collector("replay")``), so ``/metrics`` of a serving process
shows the learning path too.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import tempfile
import time
import weakref
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.hashing import Hash2U, Hash4U
from repro_torch.core.oph import OPH
from repro_torch.data.lockfile import FileLock
from repro_torch.data.pipeline import (LoaderStats, SignatureStream,
                                       loader_collector, prefetch_iter,
                                       read_with_retries)
from repro_torch.data.sigshard import read_sig_shard, write_sig_shard
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import PackedSignatures
from repro_torch.kernels.pack import PackSpec, pack_device, unpack_device
from repro_torch.models.linear import (accuracy, asgd_model, sgd_svm_init,
                                       sgd_svm_step)


def make_family(scheme: str, k: int, s: int, *, densify: str = "rotation",
                variant: str = "high",
                generator: Optional[torch.Generator] = None,
                coefficients: Optional[dict] = None,
                device: DeviceLike = None):
    """Build a hashing scheme for the online-learning front half.

    ``scheme``: ``"2u"`` / ``"4u"`` are the k-pass minwise families;
    ``"oph"`` (2U base) / ``"oph-4u"`` one-permutation hashing with k bins
    and ``densify`` in rotation / optimal / fast / sentinel.
    Coefficients are drawn from ``generator``, or taken from
    ``coefficients`` -- numpy arrays ``{"a1", "a2"}`` (2U) or ``{"a"}``
    (4U), of length k, or 1 for the OPH base -- which is how the same
    family is built in both packages.
    """
    dev = resolve_device(device)
    if scheme == "2u" or scheme in ("oph", "oph-2u"):
        kk = k if scheme == "2u" else 1
        if coefficients is None:
            base = Hash2U.create(kk, s, variant, generator=generator,
                                 device=dev)
        else:
            base = Hash2U.from_numpy(coefficients["a1"], coefficients["a2"],
                                     s, variant, dev)
    elif scheme in ("4u", "oph-4u"):
        kk = k if scheme == "4u" else 1
        base = (Hash4U.create(kk, s, generator=generator, device=dev)
                if coefficients is None else
                Hash4U.from_numpy(coefficients["a"], s, dev))
    else:
        raise ValueError(f"scheme must be '2u', '4u', 'oph'/'oph-2u' or "
                         f"'oph-4u', got {scheme!r}")
    if base.k != kk:
        raise ValueError(f"{scheme}: coefficients hold {base.k} functions, "
                         f"need {kk}")
    return base if scheme in ("2u", "4u") else OPH(base, k, densify)


# ---------------------------------------------------------------------------
# SignatureCache: hash once, replay packed .sig shards every later epoch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheStats:
    """Epoch-0 accounting: what the cache cost and what it saves."""

    bytes_original: int = 0      # raw shard bytes read to build the cache
    bytes_cached: int = 0        # packed signature shard bytes written
    bytes_payload: int = 0       # signature payload only (k*b-bit budget)
    shards: int = 0
    uncached_chunks: int = 0     # chunks past max_cache_bytes (re-hashed)
    examples: int = 0
    write_s: float = 0.0

    def reduction(self) -> float:
        """Original/hashed size ratio -- the paper's Table-2/§6 number."""
        return self.bytes_original / max(self.bytes_cached, 1)


def _sigcache_samples(cache: "SignatureCache"):
    """Registry collector: cache footprint gauges + lifecycle counters.

    Reads ``cache.stats`` at collect time -- a repopulate (TTL eviction)
    swaps in a fresh ``CacheStats``, and the gauges must follow it.
    """
    from repro_torch.obs.metrics import Sample
    st = cache.stats
    gauges = (
        ("sigcache_bytes_original", "raw shard bytes read to build the cache",
         st.bytes_original),
        ("sigcache_bytes_cached", "packed signature shard bytes on disk",
         st.bytes_cached),
        ("sigcache_bytes_payload", "signature payload bytes (k*b-bit budget)",
         st.bytes_payload),
        ("sigcache_shards", "signature shards tracked", st.shards),
        ("sigcache_uncached_chunks", "chunks past max_cache_bytes (re-hashed)",
         st.uncached_chunks),
        ("sigcache_examples", "examples cached", st.examples),
    )
    for name, help, value in gauges:
        yield Sample(name, "gauge", help, (), float(value))
    yield Sample("sigcache_write_seconds_total", "counter",
                 "wall clock spent writing signature shards", (),
                 float(st.write_s))
    yield Sample("sigcache_ttl_dropped_total", "counter",
                 "stale shard files removed by TTL eviction", (),
                 float(cache.ttl_dropped))


def _wire_spec(b: int, sentinel: bool) -> Tuple[int, bool]:
    """(code_bits, sentinel_flag) for storing b-bit signatures on disk.

    1 <= b <= 16 stores the bitstream wire format ((b+1)-bit codes for
    sentinel schemes); anything else falls back to raw 32-bit lanes,
    which also carry the EMPTY marker verbatim.
    """
    if 1 <= b <= 16:
        return (b + 1, True) if sentinel else (b, False)
    return 32, False


class SignatureCache:
    """Hash on epoch 0, replay packed ``.sig`` signature shards afterwards.

    Iterating yields ``(signatures, labels)`` chunks exactly like the
    wrapped ``SignatureStream`` (packed streams yield
    ``PackedSignatures``); the first full pass additionally writes each
    chunk as a bit-packed ``.sig`` shard under ``cache_dir`` (bit-exact:
    replayed signatures equal the fresh stream's output).  Replay uses
    the same prefetch and straggler/IO-retry machinery as
    ``ChunkedLoader`` (``replay_stats`` is a ``LoaderStats``), memory-maps
    the payload, and defers unpacking to the device (packed streams: to
    the SGD step itself), so the host only moves k*b bits per example.

    Sharing: a persistent ``cache_dir`` may be shared by several
    trainers (even across processes) -- populate passes serialize on the
    directory's ``.lock`` file (``repro_torch.data.lockfile.FileLock``,
    bounded by ``lock_timeout_s``) and every shard write is atomic, so a
    reader never maps a truncated shard and sweeps never interleave with
    another trainer's writes.

    Lifecycle: ``ttl_s`` expires shards by file mtime -- stale shard
    files are dropped on populate (leftovers in a shared ``cache_dir``)
    and on replay (a stale tracked shard invalidates the cache, which
    re-hashes on the next pass; ``ttl_dropped`` counts removals).
    ``max_cache_bytes`` caps the shard footprint -- chunks
    past the budget are not written and get re-hashed during replay
    (``stats.uncached_chunks``); the tail read resumes at the first
    uncached chunk's shard offset, recorded at populate time via
    ``ChunkedLoader.resume_point``, so the cached prefix's raw shards
    are never re-read.  ``close()`` (or context-manager exit)
    deletes the shards, and removes the cache dir entirely when this
    cache created it (``tempfile.mkdtemp``); a ``weakref.finalize``
    backstop covers caches that are garbage-collected unclosed.
    """

    def __init__(self, stream: SignatureStream, cache_dir: Optional[str] = None,
                 *, prefetch: int = 2, straggler_deadline_s: float = 30.0,
                 max_retries: int = 2, max_cache_bytes: Optional[int] = None,
                 ttl_s: Optional[float] = None,
                 lock_timeout_s: float = 600.0):
        self.stream = stream
        self.b = stream.b
        fam = stream.family
        self.k = fam.k
        self.sentinel = isinstance(fam, OPH) and fam.densify == "sentinel"
        self.packed = stream.packed
        self._owns_dir = cache_dir is None
        self.cache_dir = cache_dir or tempfile.mkdtemp(prefix="repro_sigcache_")
        os.makedirs(self.cache_dir, exist_ok=True)
        self.prefetch = prefetch
        self.deadline = straggler_deadline_s
        self.max_retries = max_retries
        self.max_cache_bytes = max_cache_bytes
        self.ttl_s = ttl_s
        self.lock_timeout_s = lock_timeout_s
        self.ttl_dropped = 0          # stale shard files removed so far
        self.populated = False
        self.closed = False
        self.paths: List[str] = []
        self._tail_resume = None      # (shard idx, skip) past the budget
        self.stats = CacheStats()
        self.replay_stats = LoaderStats()
        self._finalizer = (weakref.finalize(self, shutil.rmtree,
                                            self.cache_dir,
                                            ignore_errors=True)
                           if self._owns_dir else None)
        from repro_torch.obs.metrics import get_registry
        reg = get_registry()
        reg.register_object(self, _sigcache_samples)
        reg.register_object(self.replay_stats, loader_collector("replay"))

    # -- stats protocol (read by OnlineTrainer as per-epoch deltas) -----
    @property
    def cumulative_stats(self) -> dict:
        return {"kernel_s": self.stream.kernel_seconds,
                "bytes_read": (self.stream.loader.stats.bytes_read
                               + self.replay_stats.bytes_read),
                "source": "cache" if self.populated else "hash"}

    def __iter__(self):
        if self.closed:
            raise RuntimeError("SignatureCache is closed")
        if self.populated and self._ttl_expired():
            self.evict()
        if self.populated:
            yield from self._replay()
        else:
            yield from self._populate()

    # -- TTL eviction ---------------------------------------------------
    def _ttl_expired(self) -> bool:
        """Drop tracked shard files older than ``ttl_s`` (by mtime).

        Replay needs the full ordered shard sequence, so any stale shard
        invalidates the cache: the stale files are removed here and the
        caller evicts + re-populates on the next pass.
        """
        if self.ttl_s is None:
            return False
        cutoff = time.time() - self.ttl_s

        def is_stale(path: str) -> bool:
            try:
                return os.path.getmtime(path) <= cutoff
            except OSError:        # vanished (e.g. swept by another process)
                return True

        stale = [p for p in self.paths if is_stale(p)]
        for path in stale:
            try:
                os.remove(path)
            except OSError:
                pass
        self.ttl_dropped += len(stale)
        return bool(stale)

    def _ttl_sweep_dir(self) -> None:
        """Populate-time sweep: clear stale ``sig_*.sig`` leftovers from a
        shared/persistent ``cache_dir`` (files this instance never wrote)
        before writing fresh shards over them."""
        if self.ttl_s is None:
            return
        cutoff = time.time() - self.ttl_s
        for path in glob.glob(os.path.join(self.cache_dir, "sig_*.sig")):
            try:
                if os.path.getmtime(path) <= cutoff:
                    os.remove(path)
                    self.ttl_dropped += 1
            except OSError:
                pass

    # -- lifecycle ------------------------------------------------------
    def evict(self) -> None:
        """Drop all cached shards; the next pass hashes and re-populates."""
        for path in self.paths:
            try:
                os.remove(path)
            except OSError:
                pass
        self.paths = []
        self.populated = False
        self._tail_resume = None
        self.stats = CacheStats()

    def close(self) -> None:
        """Evict shards and delete the cache dir if this cache owns it."""
        if self.closed:
            return
        self.evict()
        if self._owns_dir:
            shutil.rmtree(self.cache_dir, ignore_errors=True)
            if self._finalizer is not None:
                self._finalizer.detach()
        self.closed = True

    def __enter__(self) -> "SignatureCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- epoch 0: hash + write-through ---------------------------------
    def _encode(self, sig) -> np.ndarray:
        """Device signatures -> host packed uint32 words for storage."""
        if isinstance(sig, PackedSignatures):
            return u32.to_numpy(sig.data)
        if _wire_spec(self.b, self.sentinel)[0] == 32:
            return u32.to_numpy(sig)
        spec = PackSpec(self.k, self.b, self.sentinel)
        return u32.to_numpy(pack_device(sig, spec))

    @property
    def code_bits(self) -> int:
        """Bits per stored signature value ((b+1) for sentinel wires).

        Packed streams always satisfy 1 <= b <= 16 (engine-enforced), so
        ``_wire_spec`` is THE definition for both stream kinds.
        """
        return _wire_spec(self.b, self.sentinel)[0]

    def _populate(self):
        # the populate pass is serialized across processes sharing this
        # cache_dir on the directory's lock file: two trainers can point
        # at one dir and never interleave one's TTL sweep with the other's
        # shard writes.  Shard writes are atomic (write_sig_shard: tmp +
        # os.replace), so a replaying reader racing a later populate only
        # ever maps complete shards.  The lock releases on generator
        # close too (abandoned epochs).
        with FileLock(os.path.join(self.cache_dir, ".lock"),
                      timeout_s=self.lock_timeout_s):
            yield from self._populate_locked()

    def _populate_locked(self):
        # a partially-consumed epoch-0 pass may have written some shards
        # and read some raw bytes already; restart the accounting so
        # replay never sees duplicates and the reduction stays honest
        self.evict()
        self._ttl_sweep_dir()
        raw_bytes_before = self.stream.loader.stats.bytes_read
        budget = self.max_cache_bytes
        for i, (sig, labels) in enumerate(self.stream):
            if budget is not None and self.stats.bytes_cached >= budget:
                self.stats.uncached_chunks += 1
                self.stats.examples += len(sig)
                yield sig, labels
                continue
            t0 = time.perf_counter()
            data = self._encode(sig)
            code_bits = self.code_bits
            path = os.path.join(self.cache_dir, f"sig_{i:05d}.sig")
            meta = write_sig_shard(path, data, labels.cpu().numpy(), k=self.k,
                                   b=self.b, code_bits=code_bits,
                                   sentinel=self.sentinel and code_bits != 32)
            self.paths.append(path)
            self.stats.bytes_cached += os.path.getsize(path)
            self.stats.bytes_payload += meta.payload_bytes
            self.stats.shards += 1
            self.stats.examples += len(sig)
            self.stats.write_s += time.perf_counter() - t0
            yield sig, labels
        self.stats.bytes_original = (self.stream.loader.stats.bytes_read
                                     - raw_bytes_before)
        if self.stats.uncached_chunks:
            # every cached chunk is full-size (a later chunk exists), so
            # the first uncached chunk starts at this stream offset; the
            # loader maps it to (shard, in-shard skip) for the replay tail
            self._tail_resume = self.stream.loader.resume_point(
                len(self.paths) * self.stream.loader.chunk_size)
        self.populated = True

    # -- epochs >= 1: replay packed shards -----------------------------
    @staticmethod
    def _read_host(path: str):
        return read_sig_shard(path, mmap=True)

    def _decode(self, payload) -> Tuple[object, torch.Tensor]:
        words, labels, meta = payload
        dev = self.stream.device
        data = u32.from_numpy(words, dev)                # packed words -> device
        labels = torch.from_numpy(labels).to(dev)
        if self.packed:
            return PackedSignatures(data, meta.k, meta.b, meta.sentinel), labels
        if meta.code_bits == 32:
            return data, labels                          # raw uint32 lanes
        spec = PackSpec(meta.k, meta.b, meta.sentinel)
        return unpack_device(data, spec), labels         # unpack ON DEVICE

    def _replay(self):
        def chunks():
            for path in self.paths:
                yield read_with_retries(self._read_host, path,
                                        self.replay_stats,
                                        deadline=self.deadline,
                                        max_retries=self.max_retries)
        for payload in prefetch_iter(chunks, self.prefetch):
            yield self._decode(payload)
        if self.stats.uncached_chunks:
            # budget-evicted tail: re-hash only the chunks past the
            # cached prefix.  Populate recorded the first uncached
            # chunk's (shard, in-shard offset), so the tail read starts
            # there -- the cached prefix's raw shards are never re-read
            # (bytes_read counts only the tail shards).
            start_shard, skip = self._tail_resume
            for chunk in self.stream.loader.iter_from(start_shard, skip):
                yield self.stream.hash_chunk(chunk)


# ---------------------------------------------------------------------------
# OnlineTrainer: the §6 epoch loop over any (signatures, labels) source
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochStats:
    """Per-epoch accounting (the split behind Figs 16/18 and Table 4).

    ``load_s`` is time the trainer waited on the source -- on a "hash"
    epoch that includes the hashing kernel (``kernel_s`` reports the
    device portion separately); on a "cache" epoch it is pure replay I/O.
    """

    epoch: int
    source: str                  # "hash" (fresh stream) | "cache" (replay)
    load_s: float = 0.0
    kernel_s: float = 0.0
    train_s: float = 0.0
    bytes_read: int = 0
    examples: int = 0


@dataclasses.dataclass
class OnlineTrainer:
    """Streaming SGD / ASGD / logistic regression on b-bit signatures.

    ``fit`` consumes chunked ``(signatures, labels)`` sources -- a
    ``SignatureStream`` (hash every epoch) or a ``SignatureCache`` (hash
    once, replay packed shards) -- and runs the Bottou update (Eq. 11-12)
    mini-batch by mini-batch on ``device``, the state updated in place
    (where the reference donates it to a jitted step).  Packed chunks are
    unpacked inside the step (``feature_kind="packed"``).

    ``kind``: ``"svm"`` (Eq. 6 hinge) or ``"logistic"`` (Eq. 7);
    ``average=True`` keeps the §6.3 ASGD average and makes
    ``model``/``evaluate`` use it.  ``close()`` closes every closeable
    source this trainer consumed.
    """

    k: int
    b: int
    kind: str = "svm"
    average: bool = False
    lam: float = 1e-4
    eta0: float = 0.5
    batch_size: int = 16
    avg_start: float = 0.0
    device: DeviceLike = None

    def __post_init__(self):
        if self.kind not in ("svm", "logistic"):
            raise ValueError(f"kind must be 'svm' or 'logistic', got {self.kind!r}")
        self.device = resolve_device(self.device)
        self.dim = self.k * (1 << self.b)
        self.state = sgd_svm_init(self.dim, avg_start=self.avg_start,
                                  device=self.device)
        self.epoch_stats: List[EpochStats] = []
        self._sources: List[object] = []

    def _step(self, feats, y, feature_kind: str, sentinel: bool = False):
        sgd_svm_step(self.state, feats, y, lam=self.lam, eta0=self.eta0,
                     b=self.b, feature_kind=feature_kind, kind=self.kind,
                     average=self.average,
                     k=self.k if feature_kind == "packed" else None,
                     sentinel=sentinel)

    @property
    def model(self):
        return asgd_model(self.state) if self.average else self.state.model

    def evaluate(self, sig_b, labels: torch.Tensor) -> float:
        if isinstance(sig_b, PackedSignatures):
            if (sig_b.k, sig_b.b) != (self.k, self.b):
                raise ValueError(
                    f"packed eval set has (k={sig_b.k}, b={sig_b.b}), "
                    f"trainer expects (k={self.k}, b={self.b}) -- a "
                    "mismatched wire would decode silently wrong")
            return float(accuracy(self.model, sig_b.data, labels,
                                  feature_kind="packed", b=self.b,
                                  k=sig_b.k, sentinel=sig_b.sentinel))
        return float(accuracy(self.model, sig_b, labels,
                              feature_kind="hashed", b=self.b))

    def close(self) -> None:
        """Close every closeable source consumed by ``fit`` (cache dirs)."""
        for src in self._sources:
            closer = getattr(src, "close", None)
            if callable(closer):
                closer()
        self._sources = []

    def __enter__(self) -> "OnlineTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fit(self, source: Iterable, n_epochs: int,
            eval_fn: Optional[Callable[["OnlineTrainer"], float]] = None
            ) -> Tuple[object, List[EpochStats], List[float]]:
        """Run ``n_epochs`` passes over ``source``.

        Returns ``(final SGDState, this call's per-epoch EpochStats, this
        call's per-epoch evals)``; ``eval_fn`` (if given) is called with
        the trainer after each epoch.  ``train_s`` of a chunk ends with a
        ``torch.cuda.synchronize`` on the card.
        """
        if not any(src is source for src in self._sources):
            self._sources.append(source)
        evals: List[float] = []
        first = len(self.epoch_stats)
        cuda = self.device.type == "cuda"
        for _ in range(n_epochs):
            before = dict(getattr(source, "cumulative_stats", None) or {})
            es = EpochStats(epoch=len(self.epoch_stats),
                            source=before.get("source", "stream"))
            t_mark = time.perf_counter()
            for sig, labels in source:
                t_loaded = time.perf_counter()
                es.load_s += t_loaded - t_mark
                if isinstance(sig, PackedSignatures):
                    feats, kind, sentinel = sig.data, "packed", sig.sentinel
                else:
                    feats, kind, sentinel = sig, "hashed", False
                feats = feats.to(self.device)
                y = labels.to(self.device)
                n = feats.shape[0]
                for i in range(0, n, self.batch_size):
                    self._step(feats[i:i + self.batch_size],
                               y[i:i + self.batch_size], kind, sentinel)
                if cuda:
                    torch.cuda.synchronize(self.device)
                es.examples += n
                t_mark = time.perf_counter()
                es.train_s += t_mark - t_loaded
            after = dict(getattr(source, "cumulative_stats", None) or {})
            es.kernel_s = after.get("kernel_s", 0.0) - before.get("kernel_s", 0.0)
            es.bytes_read = after.get("bytes_read", 0) - before.get("bytes_read", 0)
            self.epoch_stats.append(es)
            evals.append(float(eval_fn(self)) if eval_fn else float("nan"))
        return self.state, self.epoch_stats[first:], evals
