"""Chunked streaming data pipeline (port of ``repro.data.pipeline``): the
paper's batch-of-10K-sets loop.

Responsibilities:
  * on-disk shard format(s): LibSVM-style text and binary .npz -- the paper
    notes binary loading is ~5x faster than text (§3.7 Table 2 caption, §6.1);
    both are implemented so benchmarks can reproduce that ratio,
  * chunked iteration: yield SparseBatch chunks of ``chunk_size`` sets,
  * double-buffered background prefetch (overlap load with compute),
  * worker shard assignment + straggler mitigation: a shard read that
    exceeds its deadline is retried and, on repeated failure, reassigned to
    the next healthy worker (bookkeeping mirrors what a real multi-host
    data service does; on one host the "workers" are reader threads),
  * load-time accounting consumed by the online-learning benchmarks.

The prefetch (``prefetch_iter``) and retry (``read_with_retries``)
machinery is shared with the signature-cache replay path in
``repro_torch.train.online``.  Chunks are built in the prefetch thread and
copied to the loader's device there (pinned memory, ``non_blocking``), so
the copy of chunk i+1 overlaps the hashing of chunk i.  ``device_put_iter``
is the out-of-core index scan's host -> device window pipeline: a ring of
pinned staging buffers and a copy stream.  ``LoaderStats`` export through
``repro_torch.obs`` (``loader_collector``).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import random
import tempfile
import threading
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.sparse import SparseBatch, from_lists
from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Shard I/O
# ---------------------------------------------------------------------------

def write_shard_libsvm(path: str, sets: Sequence[np.ndarray], labels: np.ndarray) -> None:
    """LibSVM text: ``<label> <idx>:1 <idx>:1 ...`` (binary features)."""
    with open(path, "w") as f:
        for s, y in zip(sets, labels):
            feats = " ".join(f"{int(t)}:1" for t in s)
            f.write(f"{int(y)} {feats}\n")


def read_shard_libsvm(path: str):
    sets, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            labels.append(float(parts[0]))
            sets.append(np.array([int(p.split(":")[0]) for p in parts[1:]],
                                 np.int64))
    return sets, np.asarray(labels, np.float32)


def write_shard_binary(path: str, sets: Sequence[np.ndarray], labels: np.ndarray) -> None:
    """Binary .npz: concatenated indices + row offsets (true CSR)."""
    lens = np.array([len(s) for s in sets], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    flat = (np.concatenate(sets) if len(sets) else np.zeros((0,), np.int64))
    np.savez(path, indices=flat.astype(np.int64), offsets=offsets,
             labels=np.asarray(labels, np.float32))


def read_shard_binary(path: str):
    with np.load(path) as z:
        flat, offsets, labels = z["indices"], z["offsets"], z["labels"]
    sets = [flat[offsets[i]:offsets[i + 1]] for i in range(len(labels))]
    return sets, labels


def write_shards(batch_sets: Sequence[np.ndarray], labels: np.ndarray,
                 out_dir: str, n_shards: int, fmt: str = "binary") -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    per = (len(batch_sets) + n_shards - 1) // n_shards
    for i in range(n_shards):
        lo, hi = i * per, min((i + 1) * per, len(batch_sets))
        suffix = "npz" if fmt == "binary" else "txt"
        path = os.path.join(out_dir, f"shard_{i:05d}.{suffix}")
        writer = write_shard_binary if fmt == "binary" else write_shard_libsvm
        writer(path, batch_sets[lo:hi], labels[lo:hi])
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# Streaming loader with prefetch + straggler handling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoaderStats:
    load_seconds: float = 0.0
    chunks: int = 0
    bytes_read: int = 0
    straggler_retries: int = 0
    shard_reassignments: int = 0
    io_errors: int = 0


# LoaderStats field -> (metric name, help); every field is monotone, so
# they all export as counters through ``loader_collector``
_LOADER_METRICS = {
    "load_seconds": ("data_loader_seconds_total",
                     "wall clock spent reading shards"),
    "chunks": ("data_loader_chunks_total", "chunks yielded"),
    "bytes_read": ("data_loader_bytes_read_total", "shard bytes read"),
    "straggler_retries": ("data_loader_straggler_retries_total",
                          "reads retried for exceeding the deadline"),
    "shard_reassignments": ("data_loader_shard_reassignments_total",
                            "slow reads kept after exhausted retries"),
    "io_errors": ("data_loader_io_errors_total",
                  "OSErrors absorbed by the retry loop"),
}


def loader_collector(role: str):
    """Registry collector factory over one ``LoaderStats`` holder.

    ``role`` labels which pipeline the stats belong to (``"load"`` = raw
    shard reads, ``"replay"`` = cached signature-shard replay); several
    live loaders with the same role sum into one process total.  Used as
    ``get_registry().register_object(stats, loader_collector("load"))``.
    """
    from repro_torch.obs.metrics import Sample
    labels = (("role", role),)

    def collect(stats: LoaderStats):
        for field, (name, help) in _LOADER_METRICS.items():
            yield Sample(name, "counter", help, labels,
                         float(getattr(stats, field)))
    return collect


# process-wide jitter source for I/O retry backoff (callers needing
# determinism inject their own seeded ``random.Random``)
_default_backoff_rng = random.Random()


def read_with_retries(reader, path: str, stats: LoaderStats, *,
                      deadline: float, max_retries: int,
                      backoff_base_s: float = 0.05,
                      backoff_cap_s: float = 1.0,
                      rng=None, sleep=time.sleep):
    """Straggler/IO-aware shard read, shared by ``ChunkedLoader`` and the
    signature-cache replay path (``repro_torch.train.online.SignatureCache``).

    Every attempt is accounted: an ``OSError`` bumps ``stats.io_errors``
    and is retried after an exponential backoff with jitter -- attempt
    ``i`` sleeps ``min(backoff_cap_s, backoff_base_s * 2**i)`` scaled by
    a uniform [0.5, 1.0) jitter factor, so a flapping filesystem is not
    hammered in a tight loop and concurrent readers decorrelate.  A read
    slower than ``deadline`` bumps ``stats.straggler_retries`` and
    retries *immediately* (slow is not broken; the last slow attempt is
    kept and counted as a ``shard_reassignment``).  If all
    ``max_retries + 1`` attempts raise, the last ``OSError`` propagates
    after the final attempt with no trailing sleep -- there is no silent
    unaccounted re-read.  ``rng`` (a ``random.Random``) and ``sleep``
    are injectable so tests can pin the exact sleep schedule with a
    fake clock.
    """
    if rng is None:
        rng = _default_backoff_rng
    last_err: Optional[OSError] = None
    for attempt in range(max_retries + 1):
        t0 = time.perf_counter()
        try:
            out = reader(path)
        except OSError as e:
            stats.io_errors += 1
            last_err = e
            if attempt < max_retries:
                delay = min(backoff_cap_s, backoff_base_s * (2.0 ** attempt))
                sleep(delay * (0.5 + 0.5 * rng.random()))
            continue
        dt = time.perf_counter() - t0
        if dt > deadline:
            if attempt < max_retries:
                # too slow: count as straggler, retry (a real service
                # would hedge the read against a replica)
                stats.straggler_retries += 1
                continue
            # retries exhausted: shard is handed to the next worker
            stats.shard_reassignments += 1
        stats.load_seconds += dt
        stats.bytes_read += os.path.getsize(path)
        return out
    assert last_err is not None
    raise last_err


def prefetch_iter(make_iter, prefetch: int):
    """Double-buffered background prefetch over any chunk iterator.

    Runs ``make_iter()`` in a daemon thread, keeping up to ``prefetch``
    items ahead of the consumer (overlap load with compute).  Exceptions
    in the producer propagate to the consumer; abandoning the consumer
    mid-iteration (generator close) stops the producer thread instead of
    leaving it blocked on a full queue.  ``prefetch <= 0`` iterates
    inline.
    """
    if prefetch <= 0:
        yield from make_iter()
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in make_iter():
                if not put(item):
                    return
        except BaseException as e:   # propagate into consumer
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True,
                         name="prefetch-producer")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
            del item        # the consumer is done with it: drop it here too
        t.join()
        if err:
            raise err[0]
    finally:
        # also runs on generator close (abandoned consumer): joining here
        # guarantees the producer no longer touches shared loader stats
        stop.set()
        t.join()


@dataclasses.dataclass
class WindowStats:
    """Accounting of one ``device_put_iter`` pipeline.

    ``alive`` counts windows the pipeline has put on the device and the
    consumer has not yet handed back; ``high_water`` is its maximum over
    the run -- the device-window budget check of the streamed scan.
    ``h2d_ms`` sums the copies' device time (CUDA events on the copy
    stream; 0 on the CPU).
    """

    alive: int = 0
    high_water: int = 0
    windows: int = 0
    bytes: int = 0
    h2d_ms: float = 0.0

    def __post_init__(self):
        self._lock = threading.Lock()

    def acquire(self, nbytes: int) -> None:
        with self._lock:
            self.alive += 1
            self.high_water = max(self.high_water, self.alive)
            self.windows += 1
            self.bytes += nbytes

    def release(self, h2d_ms: float = 0.0) -> None:
        with self._lock:
            self.alive -= 1
            self.h2d_ms += h2d_ms


class PinnedRing:
    """Pinned host staging buffers for host -> device copies, reused round
    robin.

    A ``non_blocking`` copy out of pageable memory (the mmap'd ``.idx``
    payload) is not asynchronous, so every window is first copied on the
    host into one of these page-locked buffers.  A slot is refilled only
    after the event of the H2D copy that last read it has completed.
    Two slots let the host fill one while the other's copy runs.  A ring
    serves one pipeline at a time; callers that stream concurrently keep
    one ring each.
    """

    SLOTS = 2

    def __init__(self):
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0

    def stage(self, arr: np.ndarray):
        """Copy ``arr`` into the next free slot; returns (slot, pinned
        tensor view).  uint32 arrays come back as int32 bit patterns."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        nbytes = arr.nbytes
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(max(nbytes, 1),
                                              dtype=torch.uint8,
                                              pin_memory=True)
        host = buf[:nbytes]
        np.copyto(host.numpy().view(arr.dtype).reshape(arr.shape), arr)
        dtype = (torch.int32 if arr.dtype == np.uint32
                 else torch.from_numpy(np.empty(0, arr.dtype)).dtype)
        return i, host.view(dtype).view(arr.shape)

    def mark(self, slot: int, event: "torch.cuda.Event") -> None:
        """The copy out of ``slot`` completes with ``event``."""
        self._events[slot] = event


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32).copy())
    return torch.from_numpy(arr.copy())


def device_put_iter(make_host_iter, prefetch: int = 2, *,
                    device: DeviceLike = None,
                    ring: Optional[PinnedRing] = None,
                    stats: Optional[WindowStats] = None):
    """Double-buffered host -> device upload pipeline.

    ``make_host_iter()`` yields ``(key, ndarray)`` pairs; this yields
    ``(key, tensor on device)`` in order, ``prefetch`` items ahead of the
    consumer (``prefetch_iter``'s producer thread), so the H2D copy of
    item i+1 overlaps the consumer's work on item i.  On the card:

      * each array is staged through ``ring`` (``PinnedRing``: pinned
        memory, reused only once its last copy is done) and copied with
        ``non_blocking=True`` on a side copy stream, into a tensor that
        the copy stream allocates;
      * the consumer's current stream waits on the copy's event before
        the item is handed over, and the tensor is recorded on that
        stream (``record_stream``): the caching allocator would otherwise
        hand its memory to the next window, on the copy stream, while the
        consumer's kernels still read it.

    The consumer drops its reference to item i before it asks for item
    i+1; ``stats.alive`` counts the items between the producer's upload
    and that hand-back (at most ``prefetch + 2``: one being consumed,
    ``prefetch`` queued, one held by the producer while the queue is
    full), ``stats.high_water`` its maximum.  On the CPU the items are
    plain host tensors.
    """
    dev = resolve_device(device)
    stats = stats if stats is not None else WindowStats()
    if dev.type != "cuda":
        def produce_host():
            for key, arr in make_host_iter():
                stats.acquire(arr.nbytes)
                yield key, _host_tensor(arr)

        for key, win in prefetch_iter(produce_host, prefetch):
            yield key, win
            del win
            stats.release()
        return

    ring = ring if ring is not None else PinnedRing()
    copy_stream = torch.cuda.Stream(dev)

    def produce():
        for key, arr in make_host_iter():
            slot, host = ring.stage(arr)
            stats.acquire(arr.nbytes)
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(copy_stream):
                win = torch.empty(host.shape, dtype=host.dtype, device=dev)
                start.record(copy_stream)
                win.copy_(host, non_blocking=True)
                done.record(copy_stream)
            ring.mark(slot, done)
            yield key, win, start, done

    for key, win, start, done in prefetch_iter(produce, prefetch):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        win.record_stream(consumer)
        yield key, win
        del win
        done.synchronize()
        stats.release(start.elapsed_time(done))


class ChunkedLoader:
    """Iterate SparseBatch chunks over a list of shard files.

    ``n_workers`` reader threads each own a disjoint round-robin slice of
    shards.  A read exceeding ``straggler_deadline_s`` is retried
    (``max_retries``); persistent failure reassigns the shard to the next
    worker -- the multi-host straggler story, modeled faithfully enough to
    test the control logic.
    """

    def __init__(self, shard_paths: Sequence[str], chunk_size: int = 10_000,
                 fmt: str = "binary", max_nnz: Optional[int] = None,
                 prefetch: int = 2, n_workers: int = 1,
                 straggler_deadline_s: float = 30.0, max_retries: int = 2,
                 io_backoff_base_s: float = 0.05,
                 io_backoff_cap_s: float = 1.0,
                 lane_multiple: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.shard_paths = list(shard_paths)
        self.chunk_size = chunk_size
        self.fmt = fmt
        self.max_nnz = max_nnz
        self.prefetch = prefetch
        self.n_workers = n_workers
        self.deadline = straggler_deadline_s
        self.max_retries = max_retries
        self.io_backoff_base_s = io_backoff_base_s
        self.io_backoff_cap_s = io_backoff_cap_s
        self.lane_multiple = lane_multiple
        self.stats = LoaderStats()
        from repro_torch.obs.metrics import get_registry
        get_registry().register_object(self.stats, loader_collector("load"))
        # examples per shard index, recorded as shards are read; lets a
        # consumer resume mid-stream (``resume_point`` + ``iter_from``)
        self.shard_examples: dict = {}
        self._reader = read_shard_binary if fmt == "binary" else read_shard_libsvm

    # -- straggler-aware shard read ------------------------------------
    def _read_shard(self, path: str, worker: int):
        return read_with_retries(self._reader, path, self.stats,
                                 deadline=self.deadline,
                                 max_retries=self.max_retries,
                                 backoff_base_s=self.io_backoff_base_s,
                                 backoff_cap_s=self.io_backoff_cap_s)

    def _chunk_iter(self, start_shard: int = 0,
                    skip_examples: int = 0) -> Iterator[SparseBatch]:
        pending_sets: List[np.ndarray] = []
        pending_labels: List[float] = []
        # consume via a moving cursor instead of re-slicing the remainder
        # per chunk (pending = pending[chunk:] re-copied O(n) per yielded
        # chunk -- O(n^2) for many small chunks per shard); the buffers
        # compact once per shard, so each element moves at most twice
        start = 0
        skip = skip_examples
        for i in range(start_shard, len(self.shard_paths)):
            worker = i % self.n_workers
            sets, labels = self._read_shard(self.shard_paths[i], worker)
            self.shard_examples[i] = len(sets)
            if skip:
                take = min(skip, len(sets))
                sets, labels = sets[take:], labels[take:]
                skip -= take
            pending_sets.extend(sets)
            pending_labels.extend(labels.tolist())
            while len(pending_sets) - start >= self.chunk_size:
                stop = start + self.chunk_size
                yield self._make_batch(pending_sets[start:stop],
                                       pending_labels[start:stop])
                start = stop
            if start:
                del pending_sets[:start], pending_labels[:start]
                start = 0
        if pending_sets:
            yield self._make_batch(pending_sets, pending_labels)

    def _make_batch(self, sets, labels) -> SparseBatch:
        self.stats.chunks += 1
        return from_lists(sets, np.asarray(labels, np.float32),
                          max_nnz=self.max_nnz, lane_multiple=self.lane_multiple,
                          device=self.device)

    def resume_point(self, example_offset: int):
        """Map a stream example offset -> (shard index, in-shard skip).

        Needs per-shard example counts, i.e. a completed prior pass
        (``shard_examples``).  This is how the signature cache starts a
        budget-truncated replay at the first *uncached* chunk instead of
        re-reading the cached prefix's raw shards.
        """
        cum = 0
        for i in range(len(self.shard_paths)):
            n_i = self.shard_examples.get(i)
            if n_i is None:
                raise ValueError(
                    f"resume_point({example_offset}) needs shard {i}'s "
                    "example count; complete a full pass first")
            if cum + n_i > example_offset:
                return i, example_offset - cum
            cum += n_i
        return len(self.shard_paths), 0

    def iter_from(self, start_shard: int = 0,
                  skip_examples: int = 0) -> Iterator[SparseBatch]:
        """Iterate chunks starting at ``start_shard``, dropping the first
        ``skip_examples`` examples (same prefetch machinery as iteration
        from the top).  Chunk boundaries line up with a full pass when
        (start_shard, skip_examples) came from ``resume_point`` of a
        chunk-aligned offset."""
        yield from prefetch_iter(
            lambda: self._chunk_iter(start_shard, skip_examples),
            self.prefetch)

    def __iter__(self) -> Iterator[SparseBatch]:
        yield from self.iter_from()


class SignatureStream:
    """Stream (signatures, labels) chunks: loader -> hash kernel -> b bits.

    The online-learning front half of the §3 pipeline: ``family`` is a
    Hash2U/Hash4U (k-pass minwise hashing) or an ``OPH`` scheme, executed
    through ``repro_torch.kernels.SignatureEngine`` on the family's device
    (the loader copies chunks there).  With ``packed=True`` chunks are
    ``PackedSignatures`` -- the k*b-bit wire format.  Kernel time is taken
    around the engine call and a ``torch.cuda.synchronize``.
    """

    def __init__(self, shard_paths: Sequence[str], family, *, b: int = 8,
                 chunk_size: int = 10_000, packed: bool = False,
                 loader_kwargs: Optional[dict] = None):
        from repro_torch.kernels import SignatureEngine
        self.family = family
        self.b = b
        self.packed = packed
        self.engine = SignatureEngine(family, b=b, packed=packed)
        self.device = self.engine.device
        self.loader = ChunkedLoader(shard_paths, chunk_size=chunk_size,
                                    device=self.device,
                                    **(loader_kwargs or {}))
        self.kernel_seconds = 0.0
        self.examples = 0

    @property
    def cumulative_stats(self) -> dict:
        """Monotone counters for per-epoch delta accounting (the protocol
        ``repro_torch.train.online.OnlineTrainer`` reads from any source)."""
        return {"kernel_s": self.kernel_seconds,
                "bytes_read": self.loader.stats.bytes_read,
                "source": "hash"}

    def hash_chunk(self, chunk: SparseBatch):
        """Hash one SparseBatch chunk (with kernel-time accounting)."""
        t0 = time.perf_counter()
        sig = self.engine(chunk)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.kernel_seconds += time.perf_counter() - t0
        self.examples += chunk.n
        return sig, chunk.labels

    def __iter__(self):
        for chunk in self.loader:
            yield self.hash_chunk(chunk)


def batch_to_shards(batch: SparseBatch, out_dir: str, n_shards: int = 4,
                    fmt: str = "binary") -> List[str]:
    """Write a SparseBatch back out as raw disk shards; returns paths."""
    idx = batch.indices.cpu().numpy()
    msk = batch.mask.cpu().numpy()
    sets = [idx[i][msk[i]].astype(np.int64) for i in range(batch.n)]
    return write_shards(sets, batch.labels.cpu().numpy(), out_dir, n_shards,
                        fmt)


def make_sharded_dataset(spec, tmpdir: Optional[str] = None, n_shards: int = 4,
                         fmt: str = "binary", n: Optional[int] = None) -> List[str]:
    """Generate a synthetic dataset's training split and write it as
    shards (no device involved); returns paths."""
    from repro_torch.data.synthetic import generate_sets
    (sets, labels), _ = generate_sets(spec, n=n)
    out_dir = tmpdir or tempfile.mkdtemp(prefix=f"repro_{spec.name}_")
    return write_shards(sets, labels, out_dir, n_shards, fmt)
