"""Query paths over a loaded ``.idx``: exact top-k and LSH + rerank (port
of ``repro.index.query``).

One searcher, two serving paths sharing the scoring kernel and the
estimator rerank:

  * ``mode="exact"`` -- brute force over the device-resident packed
    corpus: a Python loop over blocks of ``corpus_block`` rows runs the
    packed-match kernel (``repro_torch.kernels.hamming.packed_match``),
    debiases the counts into resemblance estimates (Theorem 1) and merges
    them into a running top-k.  The launches are queued on the stream;
    only the harvest waits for them.

    Corpora larger than the device window (``max_device_bytes``) never
    become device-resident: windows of the mmap'd ``.idx`` payload stream
    through ``repro_torch.data.pipeline.device_put_iter`` (pinned staging
    ring, a copy stream), the H2D copy of window i+1 overlapping the scan
    of window i, sized by ``StreamPlan``; the running top-k threads across
    windows, so the result is bit-identical to the in-core scan.
  * ``mode="lsh"`` -- candidates from the banded bucket tables (one
    batched ``np.searchsorted`` per band, ``SigIndex.candidates_batch``),
    then one kernel launch over the batch's candidate union (padded to a
    power of two >= 128) with non-candidates masked out, then the same
    rerank.  With ``lsh_batch`` set a flush is split into sub-batches,
    each dispatched before any is harvested: host candidate work for
    sub-batch i+1 overlaps the device rerank of sub-batch i.

``exact_scan_ids`` / ``lsh_rerank_ids`` are the same two paths over a
corpus that carries explicit global doc ids -- one mesh position's
stacked shards, the bodies of the router's mesh dispatcher.

Top-k order is the reference's ``lax.top_k`` rule: descending score,
ties toward the earlier position (the lower doc id).  ``torch.topk``
promises no order among ties, so every top-k here is a stable descending
``torch.sort``.

``submit`` queues single queries and ``flush`` runs them as one batch --
the entry point of ``repro_torch.launch.serve --index``.  One searcher
serves several dispatch threads at once (``repro_torch.launch.server``),
each on its own CUDA stream: state built lazily (the corpus upload, the
set sizes) is built once under a lock, and shared device tensors are
recorded on every stream that reads them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.estimator import bbit_constants
from repro_torch.data.pipeline import PinnedRing, WindowStats, device_put_iter
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index.banding import band_keys_packed
from repro_torch.index.builder import SigIndex
from repro_torch.kernels.engine import PackedSignatures
from repro_torch.kernels.hamming import packed_match, resolve_tile
from repro_torch.kernels.pack import PackSpec
from repro_torch.obs.trace import get_tracer

Queries = Union[PackedSignatures, torch.Tensor, np.ndarray]


def resemblance_scores(matches: torch.Tensor,
                       both_empty: Optional[torch.Tensor], k: int, b: int, *,
                       query_sizes: Optional[torch.Tensor] = None,
                       doc_sizes: Optional[torch.Tensor] = None,
                       D: int = 0) -> torch.Tensor:
    """(Q, N) match counts -> (Q, N) float32 resemblance estimates.

    ``both_empty`` applies the Li-Owen-Zhang denominator for sentinel
    wires; the Theorem-1 debias uses exact (C1, C2) when set sizes and the
    universe size are known, the sparse-limit constants 2^-b otherwise.
    The operations and their order are the reference's, in float32
    (constant divisions as multiplies by the float32 reciprocal).
    """
    p = matches.to(torch.float32)
    if both_empty is not None:
        p = p / torch.clamp(k - both_empty.to(torch.float32), min=1.0)
    else:
        p = p * (1.0 / k)
    if query_sizes is not None and doc_sizes is not None and D:
        c = bbit_constants(query_sizes[:, None], doc_sizes[None, :], D, b)
        return (p - c.C1) / (1.0 - c.C2)
    c1 = 2.0 ** -b
    return (p - c1) * (1.0 / (1.0 - c1))


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Sizing of the out-of-core exact scan, honoring the device budget.

    ``inflight`` windows can be device-resident at once: the one being
    scanned, up to ``prefetch`` queued in the H2D pipeline, and one held
    by the producer thread while the queue is full -- so
    ``inflight * window_bytes <= max_device_bytes`` whenever the budget
    admits at least one corpus row per window (the hard floor).
    """

    window: int        # rows per streamed window (multiple of block)
    block: int         # scan block height (<= the searcher's corpus_block)
    prefetch: int      # H2D pipeline depth actually used
    row_bytes: int

    @property
    def inflight(self) -> int:
        return self.prefetch + 2

    @property
    def window_bytes(self) -> int:
        return self.window * self.row_bytes

    @property
    def resident_bytes(self) -> int:
        """Worst-case device bytes held by streamed corpus windows."""
        return self.inflight * self.window_bytes


@dataclasses.dataclass
class SearchResult:
    """Top-k per query: global doc ids (-1 past the candidate count) and
    their resemblance estimates (-inf where the id is -1).

    ``coverage`` / ``failed_shards`` carry the router's degraded-mode
    accounting (``on_shard_failure="partial"``): the fraction of corpus
    docs searched and the shard indices that failed.
    """

    indices: np.ndarray          # (Q, topk) int64
    scores: np.ndarray           # (Q, topk) float32
    n_candidates: Optional[np.ndarray] = None    # (Q,) for the LSH path
    coverage: float = 1.0        # docs searched / docs total
    failed_shards: Tuple[int, ...] = ()

    def __len__(self) -> int:
        return self.indices.shape[0]


def query_words(queries: Queries, spec: PackSpec,
                device: torch.device) -> torch.Tensor:
    """A query batch as (Q, words) int32 words on ``device``: a
    ``PackedSignatures`` batch in the index's wire format, an int32
    tensor of bit patterns, or a uint32 numpy array."""
    if isinstance(queries, PackedSignatures):
        if (queries.k, queries.b, queries.sentinel) != \
                (spec.k, spec.b, spec.sentinel):
            raise ValueError(
                f"query wire (k={queries.k}, b={queries.b}, "
                f"sentinel={queries.sentinel}) != index wire (k={spec.k}, "
                f"b={spec.b}, sentinel={spec.sentinel})")
        words = queries.data
    elif isinstance(queries, torch.Tensor):
        if queries.dtype != torch.int32:
            raise TypeError(f"query words must be int32 bit patterns, got "
                            f"{queries.dtype}")
        words = queries
    else:
        words = u32.from_numpy(np.asarray(queries), "cpu")
    if words.ndim != 2 or words.shape[1] != spec.words:
        raise ValueError(f"raw queries must be (Q, {spec.words}) packed "
                         f"words, got {tuple(words.shape)}")
    return words.to(device)


def topk_desc(scores: torch.Tensor, kk: int):
    """(values, positions) of the kk largest per row; ties toward the
    lower position, as ``lax.top_k``."""
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :kk], order[:, :kk]


def topk_merge(best_s, best_i, sc, ids):
    """Running top-k merge: [best so far || block scores] -> new best;
    ties go to the earlier concatenation position (the lower doc id)."""
    cat_s = torch.cat([best_s, sc], dim=1)
    cat_i = torch.cat([best_i, ids.expand(sc.shape[0], -1)], dim=1)
    new_s, sel = topk_desc(cat_s, best_s.shape[1])
    return new_s, torch.gather(cat_i, 1, sel)


def on_stream(t: torch.Tensor) -> torch.Tensor:
    """Record a device tensor that several streams share on the calling
    thread's current stream, so the caching allocator never hands its
    memory to another stream's allocation while work queued here still
    reads it (a corpus uploaded by one dispatch worker and freed by a
    refresh on another)."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t


def pad_result(best_i: torch.Tensor, best_s: torch.Tensor, q: int, topk: int,
               kk: int, n_candidates=None) -> SearchResult:
    """Pad to the requested width so every mode returns (Q, topk)."""
    out_i = np.full((q, topk), -1, np.int64)
    out_s = np.full((q, topk), -np.inf, np.float32)
    out_i[:, :kk] = best_i[:, :topk].cpu().numpy()
    out_s[:, :kk] = best_s[:, :topk].cpu().numpy()
    return SearchResult(out_i, out_s, n_candidates)


def match_scores(match: Callable, qwords: torch.Tensor, cwords: torch.Tensor,
                 meta, q_sizes: Optional[torch.Tensor] = None,
                 doc_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, N) resemblance estimates of ``cwords`` against ``qwords``:
    ``match`` (the packed-match contract) counts, ``resemblance_scores``
    debiases -- with the Theorem-1 constants when both set-size vectors
    are given, for an index of universe 2^``meta.s``."""
    out = match(qwords, cwords)
    matches, both_empty = out if meta.sentinel else (out, None)
    if q_sizes is None or doc_sizes is None:
        return resemblance_scores(matches, both_empty, meta.k, meta.b)
    return resemblance_scores(matches, both_empty, meta.k, meta.b,
                              query_sizes=q_sizes, doc_sizes=doc_sizes,
                              D=1 << meta.s)


def exact_scan_ids(qwords: torch.Tensor, corpus: torch.Tensor,
                   ids: torch.Tensor, q_sizes: Optional[torch.Tensor],
                   doc_sizes: Optional[torch.Tensor], *, meta,
                   match: Callable, block: int, topk: int):
    """Blocked exact scan over a corpus carrying *explicit* global doc ids
    (-1 marks a padding row, scored -inf): the per-position body of the
    mesh fan-out (``repro_torch.index.router``).

    ``corpus`` (rows, words) has a row count that is a multiple of
    ``block``, its rows in ascending global-id order, so the running
    top-k's tie rule resolves to the lowest global id within the
    position.  Returns (best scores, best ids), each (Q, topk), still on
    the device.
    """
    q = qwords.shape[0]
    dev = corpus.device
    best_s = torch.full((q, topk), -torch.inf, device=dev)
    best_i = torch.full((q, topk), -1, dtype=torch.int64, device=dev)
    for lo in range(0, corpus.shape[0], block):
        idblk = ids[lo:lo + block]
        sc = match_scores(match, qwords, corpus[lo:lo + block], meta,
                          q_sizes, None if doc_sizes is None
                          else doc_sizes[lo:lo + block])
        sc = torch.where(idblk >= 0, sc, -torch.inf)
        best_s, best_i = topk_merge(best_s, best_i, sc, idblk)
    return best_s, best_i


def lsh_rerank_ids(qwords: torch.Tensor, corpus: torch.Tensor,
                   ids: torch.Tensor, cand: torch.Tensor,
                   member: torch.Tensor, q_sizes: Optional[torch.Tensor],
                   doc_sizes: Optional[torch.Tensor], *, meta,
                   match: Callable, topk: int):
    """Candidate gather + kernel rerank over a corpus carrying explicit
    global doc ids: the per-position body of the mesh LSH fan-out.

    ``cand`` (C,) holds row indices into ``corpus`` in ascending global-id
    order; ``member`` (Q, C) says which are each query's candidates.
    Padding slots point at row 0 with ``member`` False: they score -inf
    and surface id -1.  The scores are ``IndexSearcher``'s, element for
    element.  Returns (top scores, top ids), each (Q, topk).
    """
    sc = match_scores(match, qwords, corpus.index_select(0, cand), meta,
                      q_sizes, None if doc_sizes is None else doc_sizes[cand])
    sc = torch.where(member, sc, -torch.inf)
    top_s, sel = topk_desc(sc, topk)
    top_i = torch.where(torch.isneginf(top_s), -1, ids[cand][sel])
    return top_s, top_i


class BatchedAdmission:
    """The submit/flush protocol shared by ``IndexSearcher`` and the
    sharded router: hosts provide ``spec``, ``device`` and ``search``."""

    def _admission_init(self) -> None:
        self._pending: List[Tuple[int, torch.Tensor, Optional[int]]] = []
        self._next_ticket = 0

    def submit(self, query: Queries, *,
               query_size: Optional[int] = None) -> int:
        """Queue one query (a single packed row); returns its ticket.
        Host rows stay on the host until ``flush`` copies the batch."""
        if isinstance(query, PackedSignatures):
            dev = query.data.device
        elif isinstance(query, torch.Tensor):
            query, dev = query.reshape(1, -1), query.device
        else:
            query, dev = np.asarray(query).reshape(1, -1), torch.device("cpu")
        words = query_words(query, self.spec, dev)
        if words.shape[0] != 1:
            raise ValueError("submit() takes exactly one query row")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append((ticket, words, query_size))
        return ticket

    def flush(self, topk: int = 10, *,
              mode: str = "exact") -> Dict[int, SearchResult]:
        """Run all queued queries as ONE batch; per-ticket results."""
        if not self._pending:
            return {}
        tickets = [t for t, _, _ in self._pending]
        rows = [w for _, w, _ in self._pending]
        sizes = [sz for _, _, sz in self._pending]
        self._pending = []
        if all(r.device.type == "cpu" for r in rows):
            batch = torch.cat(rows).to(self.device)       # one copy
        else:
            batch = torch.cat([r.to(self.device) for r in rows])
        qsizes = None
        if any(sz is not None for sz in sizes):
            if any(sz is None for sz in sizes):
                raise ValueError("either every submitted query carries a "
                                 "query_size or none does")
            qsizes = np.asarray(sizes, np.uint32)
        with get_tracer().span("search_dispatch",
                               args={"mode": mode, "batch": len(tickets)}):
            res = self.search(batch, topk, mode=mode, query_sizes=qsizes)
        return {t: SearchResult(res.indices[i:i + 1], res.scores[i:i + 1],
                                None if res.n_candidates is None
                                else res.n_candidates[i:i + 1],
                                coverage=res.coverage,
                                failed_shards=res.failed_shards)
                for i, t in enumerate(tickets)}


class IndexSearcher(BatchedAdmission):
    """Serving front end over one ``SigIndex`` on ``device`` (the card
    unless ``device="cpu"``; it must be the index's).  ``corpus_block`` is
    the exact scan's block height.

    ``max_device_bytes`` is the device window of the exact path: a packed
    corpus larger than it is never uploaded whole -- windows stream off
    the mmap'd payload (``StreamPlan``, ``stream_prefetch`` windows
    ahead).  ``lsh_batch`` splits an LSH flush into sub-batches that are
    all dispatched before any is harvested.

    Match counts come from ``match_counts``, the packed-match dispatcher;
    a subclass may score through another function of the same contract
    (``chip_smoke.py`` scores one through the plain version on the card).
    ``blocks`` is the kernel's output tile (``{"blk_q": q, "blk_n": n}``);
    without it the ``TuningTable``'s ``"hamming"`` entry for the index's
    wire, else the kernel's default.  It is resolved once, here, and every
    launch of the exact, streamed and LSH paths takes it.
    """

    def __init__(self, index: SigIndex, *, device: DeviceLike = None,
                 corpus_block: int = 4096,
                 max_device_bytes: Optional[int] = None,
                 stream_prefetch: int = 2,
                 lsh_batch: Optional[int] = None,
                 blocks: Optional[dict] = None):
        self.device = resolve_device(device)
        if self.device.type != index.device.type:
            raise ValueError(f"index lives on {index.device}, searcher on "
                             f"{self.device}; load it with device="
                             f"'{self.device.type}'")
        if corpus_block < 1:
            raise ValueError(f"corpus_block must be >= 1, got {corpus_block}")
        if max_device_bytes is not None and max_device_bytes < 1:
            raise ValueError(f"max_device_bytes must be >= 1, got "
                             f"{max_device_bytes}")
        if stream_prefetch < 0:
            raise ValueError(f"stream_prefetch must be >= 0, got "
                             f"{stream_prefetch}")
        if lsh_batch is not None and lsh_batch < 1:
            raise ValueError(f"lsh_batch must be >= 1, got {lsh_batch}")
        self.index = index
        self.blocks = resolve_tile(index.spec, self.device, blocks)
        self.corpus_block = min(corpus_block, max(index.n, 1))
        self.max_device_bytes = max_device_bytes
        self.stream_prefetch = stream_prefetch
        self.lsh_batch = lsh_batch
        self._lock = threading.Lock()     # lazily built shared state
        self._doc_sizes = None
        self._rings: List[PinnedRing] = []   # idle pinned staging rings
        self.last_window_stats: Optional[WindowStats] = None
        self._admission_init()

    @property
    def spec(self) -> PackSpec:
        return self.index.spec

    @property
    def streamed(self) -> bool:
        """True when the exact path streams windows instead of holding the
        whole packed corpus on the device."""
        return (self.max_device_bytes is not None
                and self.index.meta.payload_bytes > self.max_device_bytes)

    def match_counts(self, qwords: torch.Tensor, cwords: torch.Tensor):
        return packed_match(qwords, cwords, self.index.spec,
                            blocks=self.blocks)

    # -- scoring ---------------------------------------------------------
    def _rerank_sizes(self, q_sizes) -> Optional[torch.Tensor]:
        """Query sizes on the device for the Theorem-1 rerank, or None on
        indexes without set sizes (sparse-limit constants).  The document
        sizes upload once, under the lock, by a blocking copy."""
        meta = self.index.meta
        if self.index.set_sizes is None or not meta.s:
            return None
        if q_sizes is None:
            raise ValueError("index stores set sizes; pass query_sizes "
                             "to search() for the exact Theorem-1 rerank")
        if self._doc_sizes is None:
            with self._lock:
                if self._doc_sizes is None:
                    self._doc_sizes = torch.from_numpy(
                        self.index.set_sizes.astype(np.int64)).to(
                            self.device)
        on_stream(self._doc_sizes)
        return torch.from_numpy(
            np.asarray(q_sizes).astype(np.int64)).to(self.device)

    def _score(self, qwords, cwords, doc_ids, q_sizes):
        """Kernel match counts -> resemblance estimates for the docs
        ``doc_ids`` (a slice or an index tensor) of the corpus."""
        return match_scores(self.match_counts, qwords, cwords,
                            self.index.meta, q_sizes,
                            None if q_sizes is None
                            else self._doc_sizes[doc_ids])

    # -- exact brute force ------------------------------------------------
    def _exact(self, qwords, topk: int, q_sizes):
        if self.streamed:
            return self._exact_streamed(qwords, topk, q_sizes)
        n, q = self.index.n, qwords.shape[0]
        kk = min(topk, n)
        corpus = on_stream(self.index.corpus)
        best_s = torch.full((q, kk), -torch.inf, device=self.device)
        best_i = torch.full((q, kk), -1, dtype=torch.int64,
                            device=self.device)
        for start in range(0, n, self.corpus_block):
            stop = min(start + self.corpus_block, n)
            sc = self._score(qwords, corpus[start:stop], slice(start, stop),
                             q_sizes)
            ids = torch.arange(start, stop, device=self.device)
            best_s, best_i = topk_merge(best_s, best_i, sc, ids)
        return lambda: pad_result(best_i, best_s, q, topk, kk)

    def stream_plan(self) -> StreamPlan:
        """Size the streamed windows so the budget is actually honored
        (the reference's rule, rule for rule).

        ``inflight = prefetch + 2`` windows can be device-resident at once
        (scanned + queued + producer-held), so each window gets
        ``max_device_bytes // inflight`` bytes, floored to a ``block``
        multiple.  When that leaves less than one ``corpus_block`` of
        rows, the pipeline depth shrinks first (bigger windows beat deeper
        prefetch) and then the scan block itself shrinks below
        ``corpus_block`` -- down to the hard floor of one row per window,
        the only case where the stated budget is unsatisfiable.
        """
        row_bytes = 4 * self.index.meta.words
        budget = self.max_device_bytes or 0

        def plan(prefetch: int) -> StreamPlan:
            rows = budget // ((prefetch + 2) * row_bytes)
            block = min(self.corpus_block, max(1, rows))
            window = max(block, rows // block * block)
            return StreamPlan(window, block, prefetch, row_bytes)

        p = plan(self.stream_prefetch)
        while p.prefetch > 0 and p.block < self.corpus_block:
            p = plan(p.prefetch - 1)
        return p

    def _exact_streamed(self, qwords, topk: int, q_sizes):
        """Out-of-core exact scan: windows of the mmap'd packed payload
        stream through ``device_put_iter``; the running top-k threads
        across windows (bit-identical to the in-core scan, whose blocks
        score the same pairs and whose merge keeps the same order).

        Trouble on the card, handled here and in ``device_put_iter``:
        pageable mmap windows go through a pinned ring (reused only after
        its last copy's event), the copy runs on a side stream, this
        thread's stream waits on each window's event and the window is
        recorded on it.  Backpressure: this thread waits out window i's
        scan (an event on its stream) and drops the window before it takes
        window i+1, so no more than ``StreamPlan.inflight`` windows are
        ever alive (``last_window_stats.high_water``).
        """
        n, q = self.index.n, qwords.shape[0]
        kk = min(topk, n)
        words = self.index.words_host
        p = self.stream_plan()
        stats = WindowStats()
        self.last_window_stats = stats
        cuda = self.device.type == "cuda"

        def host_windows():
            for lo in range(0, n, p.window):
                yield lo, words[lo:min(lo + p.window, n)]

        best_s = torch.full((q, kk), -torch.inf, device=self.device)
        best_i = torch.full((q, kk), -1, dtype=torch.int64,
                            device=self.device)
        ring = self._take_ring() if cuda else None
        windows = device_put_iter(host_windows, p.prefetch,
                                  device=self.device, ring=ring, stats=stats)
        try:
            for lo, win in windows:
                rows = win.shape[0]
                for start in range(0, rows, p.block):
                    stop = min(start + p.block, rows)
                    sc = self._score(qwords, win[start:stop],
                                     slice(lo + start, lo + stop), q_sizes)
                    ids = torch.arange(lo + start, lo + stop,
                                       device=self.device)
                    best_s, best_i = topk_merge(best_s, best_i, sc, ids)
                if cuda:
                    scanned = torch.cuda.Event()
                    scanned.record()
                    scanned.synchronize()
                del win
        finally:
            windows.close()            # joins the producer thread
            if ring is not None:
                self._give_ring(ring)
        return lambda: pad_result(best_i, best_s, q, topk, kk)

    def _take_ring(self) -> PinnedRing:
        with self._lock:
            return self._rings.pop() if self._rings else PinnedRing()

    def _give_ring(self, ring: PinnedRing) -> None:
        with self._lock:
            self._rings.append(ring)

    # -- LSH candidates + rerank ------------------------------------------
    def _lsh_dispatch(self, qwords, topk: int, q_sizes, cand):
        """Queue one sub-batch's rerank; returns (top ids, top scores,
        candidate counts, kk) with the tensors still on the device."""
        q = qwords.shape[0]
        n_cand = np.array([c.size for c in cand], np.int64)
        if not n_cand.any():
            return None, None, n_cand, 0
        union = np.unique(np.concatenate(cand))
        # pad the union to a power of two >= 128, as the reference buckets
        # candidate widths; padding slots point at row 0, not members
        c_pad = max(128, 1 << int(union.size - 1).bit_length())
        ids = np.zeros(c_pad, np.int64)
        ids[:union.size] = union
        member = np.zeros((q, c_pad), bool)
        for i, c in enumerate(cand):
            member[i, np.searchsorted(union, c)] = True
        ids_dev = torch.from_numpy(ids).to(self.device)
        if self.streamed:
            # out-of-core corpus: gather only the candidate rows off the
            # mmap'd payload instead of uploading the whole matrix
            cwords = u32.from_numpy(self.index.words_host[ids], self.device)
        else:
            cwords = on_stream(self.index.corpus).index_select(0, ids_dev)
        sc = self._score(qwords, cwords, ids_dev, q_sizes)
        sc = torch.where(torch.from_numpy(member).to(self.device), sc,
                         -torch.inf)
        kk = min(topk, c_pad)
        top_s, sel = topk_desc(sc, kk)
        top_i = torch.where(torch.isneginf(top_s), -1, ids_dev[sel])
        return top_i, top_s, n_cand, kk

    def _lsh(self, qwords, topk: int, q_sizes, qkeys=None):
        q = qwords.shape[0]
        if qkeys is None:
            qkeys = u32.to_numpy(band_keys_packed(qwords, self.index.spec,
                                                  self.index.banding))
        cand = self.index.candidates_batch(qkeys)
        step = self.lsh_batch or q
        # every sub-batch is queued before any is harvested: the host
        # builds sub-batch i+1's union while the device reranks i
        inflight = []
        for lo in range(0, q, step):
            hi = min(lo + step, q)
            sizes = None if q_sizes is None else q_sizes[lo:hi]
            inflight.append(self._lsh_dispatch(qwords[lo:hi], topk, sizes,
                                               cand[lo:hi]))

        def harvest() -> SearchResult:
            out_i = np.full((q, topk), -1, np.int64)
            out_s = np.full((q, topk), -np.inf, np.float32)
            n_cand = np.zeros(q, np.int64)
            row = 0
            for top_i, top_s, nc, kk in inflight:
                m = nc.shape[0]
                if kk:
                    out_i[row:row + m, :kk] = top_i.cpu().numpy()
                    out_s[row:row + m, :kk] = top_s.cpu().numpy()
                n_cand[row:row + m] = nc
                row += m
            return SearchResult(out_i, out_s, n_cand)
        return harvest

    # -- public API -------------------------------------------------------
    def dispatch(self, queries: Queries, topk: int = 10, *,
                 mode: str = "exact",
                 query_sizes: Optional[np.ndarray] = None,
                 qkeys: Optional[np.ndarray] = None
                 ) -> Callable[[], SearchResult]:
        """Queue a batch's device work now on the current stream; the
        returned harvest callable waits for it and builds the
        ``SearchResult`` (call it on the same stream).  ``qkeys`` passes
        band keys the caller already computed (the router computes them
        once per batch, not once per shard)."""
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        qwords = query_words(queries, self.index.spec, self.device)
        q_sizes = self._rerank_sizes(query_sizes)
        if mode == "exact":
            return self._exact(qwords, topk, q_sizes)
        if mode == "lsh":
            return self._lsh(qwords, topk, q_sizes, qkeys)
        raise ValueError(f"mode must be 'exact' or 'lsh', got {mode!r}")

    def search(self, queries: Queries, topk: int = 10, *,
               mode: str = "exact",
               query_sizes: Optional[np.ndarray] = None) -> SearchResult:
        """Top-k most resembling documents for a batch of packed queries
        (``"exact"`` brute force or ``"lsh"`` banded candidates + rerank);
        ``query_sizes`` feeds the exact Theorem-1 debias when the index
        stores set sizes."""
        return self.dispatch(queries, topk, mode=mode,
                             query_sizes=query_sizes)()
