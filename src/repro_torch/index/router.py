"""Sharded-index router (port of ``repro.index.router``, the sequential
fan-out): fan a query batch across ``.idx`` shards and merge the
per-shard top-k bit-identically to a single-index search.

  * ``ShardedIndex`` -- per-shard ``IndexSearcher``s and the global doc-id
    offsets, reached through the ``ShardClient`` seam (in-process
    ``LocalShardClient``, or any ``client_factory``: the socket transport
    of ``repro_torch.index.transport``, the resilience wrappers of
    ``repro_torch.index.resilience``).  ``search`` dispatches every shard
    before it harvests any (each shard's kernel launches are queued on
    the caller's stream), then ``merge_topk`` folds the results; with
    ``on_shard_failure="partial"`` the surviving shards are served with
    ``coverage`` accounting.
  * ``merge_topk`` -- lexicographic (descending score, ascending global
    id) fold of per-shard (scores, local ids): ``lax.top_k``'s tie rule
    over the whole corpus, so the merged ids AND scores equal a
    single-index search, whatever the partition.
  * ``load_sharded`` -- read ``manifest.json`` + shards from a
    ``build_sharded`` output directory.

Live growth under readers: ``append`` extends the LAST shard
(``append_index``) under the directory's lock file (``sharded_lock``), or
with ``max_shard_docs`` spills into new tail shards (temp write +
``os.replace``, manifest last), rewrites the manifest with a bumped
``generation`` and swaps the router's state in one assignment under
``_swap_lock``.  A running ``search`` reads ONE snapshot (taken once at
entry), so it sees the pre- or post-append corpus, never a mix; it keeps
that snapshot -- and so every old shard's device corpus -- until its
harvest has synchronized its stream, and a device corpus is recorded on
every stream that reads it, so a swap never frees memory that queued work
still reads.  ``refresh`` is the reader side: re-read the manifest and
reload only the shards whose (name, doc count) changed.

The mesh dispatcher (``mesh=``, ``dispatch="mesh"``) is the reference's
``shard_map`` fan-out with one controlling process: shards are placed
round-robin on the positions of the mesh's ``"data"`` axis
(``repro_torch.sharding.rules.place_shards``; positions may share a
device), each position holds ONE stacked corpus of its shards
(``MeshLayout``, built once per router state), and a search launches one
scan (exact: ``exact_scan_ids``) or one candidate rerank (LSH:
``lsh_rerank_ids``) per position, each on the position's device and its
own CUDA stream, all before any is gathered; the gathered (D, Q, k)
partials fold through ``merge_topk`` -- ids and scores equal to the
sequential fan-out's.  No process group is involved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.data.sigshard import read_sig_meta
from repro_torch.index.banding import band_keys_packed
from repro_torch.index.builder import (MANIFEST_NAME, SigIndex, append_index,
                                       build_index, load_index, read_manifest,
                                       sharded_lock, write_manifest)
from repro_torch.index.query import (BatchedAdmission, IndexSearcher,
                                     Queries, SearchResult, exact_scan_ids,
                                     lsh_rerank_ids, on_stream, query_words)
from repro_torch.launch.mesh import Mesh
from repro_torch.obs.metrics import Sample, get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sharding.rules import data_axis_devices, place_shards

DISPATCHES = ("auto", "sequential", "mesh")


def _router_samples(router: "ShardedIndex"):
    """Registry collector over one live ``ShardedIndex`` (weakref'd): the
    per-instance mesh-dispatch counts roll up into process counters, plus
    the served manifest generation / corpus size as gauges."""
    state = router._state
    for mode, n in (("exact", router.mesh_exact_dispatches),
                    ("lsh", router.mesh_lsh_dispatches)):
        yield Sample("index_mesh_dispatches_total", "counter",
                     "shard_map collective dispatches taken",
                     (("mode", mode),), float(n))
    yield Sample("index_generation", "gauge",
                 "manifest generation currently served", (),
                 float(state.generation))
    yield Sample("index_docs", "gauge", "documents served", (),
                 float(state.n))
    yield Sample("index_shards", "gauge", "shards served", (),
                 float(len(state.searchers)))


def merge_topk(results: Sequence[SearchResult], offsets: Sequence[int],
               topk: int) -> SearchResult:
    """Fold per-shard top-k (local ids) into the global top-k.

    Every shard scores with the same kernel path, so sorting the
    concatenated entries by (descending score, ascending global id)
    reproduces ``lax.top_k`` over the unpartitioned corpus bit for bit.
    Padding entries (id -1) carry -inf scores and sort last.
    """
    if not results:
        raise ValueError("merge_topk needs at least one shard result")
    cat_s = np.concatenate([r.scores for r in results], axis=1)
    cat_i = np.concatenate(
        [np.where(r.indices >= 0, r.indices + off, np.int64(-1))
         for r, off in zip(results, offsets)], axis=1)
    order = np.lexsort((cat_i, -cat_s), axis=1)[:, :topk]
    out_s = np.take_along_axis(cat_s, order, axis=1)
    out_i = np.take_along_axis(cat_i, order, axis=1)
    pad = topk - out_s.shape[1]
    if pad > 0:
        out_s = np.pad(out_s, ((0, 0), (0, pad)), constant_values=-np.inf)
        out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
    n_cand = None
    if all(r.n_candidates is not None for r in results):
        n_cand = np.sum([r.n_candidates for r in results], axis=0)
    return SearchResult(out_i, out_s.astype(np.float32), n_cand)


class ShardClient:
    """Transport seam between the router and one shard's searcher:
    ``dispatch`` starts the shard's work and returns a zero-arg harvest
    callable producing its ``SearchResult`` (scores + LOCAL doc ids) --
    the entire wire contract, so the router's merge is
    transport-agnostic."""

    @property
    def n(self) -> int:
        """Documents served by this shard."""
        raise NotImplementedError

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        raise NotImplementedError


class LocalShardClient(ShardClient):
    """In-process ``ShardClient``: a direct ``IndexSearcher.dispatch``."""

    def __init__(self, searcher: IndexSearcher):
        self.searcher = searcher

    @property
    def n(self) -> int:
        return self.searcher.index.n

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        return self.searcher.dispatch(qwords, topk, mode=mode,
                                      query_sizes=query_sizes, qkeys=qkeys)


@dataclasses.dataclass(frozen=True)
class _RouterState:
    """One immutable, internally consistent view of the shard set.

    Mutations (``append``, ``refresh``) build a whole new state and swap
    it in with one attribute assignment; every ``search`` snapshots
    ``self._state`` exactly once, so a racing mutation can never hand a
    query old offsets with new searchers.  ``cache`` holds the mesh
    dispatcher's stacked corpus for this state; it dies with the state,
    so a swapped-in corpus is never served against stale offsets.
    """

    searchers: Tuple[IndexSearcher, ...]
    clients: Tuple[ShardClient, ...]
    offsets: np.ndarray            # global doc-id offset per shard
    paths: Optional[Tuple[str, ...]]
    generation: int
    cache: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(sum(s.index.n for s in self.searchers))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The mesh dispatcher's device corpus for one router state.

    Position d holds its round-robin shards stacked in ascending shard
    order (so its rows are in ascending global-id order), each shard
    padded to a ``block`` multiple and every position padded to the
    widest one's ``rows``; padding rows carry id -1 (scored -inf) and
    set size 0.  ``shard_pos[s]`` is shard s's (position, first row).
    """

    corpora: Tuple[torch.Tensor, ...]     # (rows, words) int32 each
    ids: Tuple[torch.Tensor, ...]         # (rows,) int64 global doc ids
    doc_sizes: Optional[Tuple[torch.Tensor, ...]]   # (rows,) int64
    shard_pos: Tuple[Tuple[int, int], ...]
    block: int
    rows: int

    @property
    def D(self) -> int:
        return len(self.corpora)

    @property
    def stacked_bytes(self) -> int:
        """Packed-corpus bytes one position holds."""
        return self.corpora[0].numel() * 4


def _plan_spill(last_n: int, counts: Sequence[int],
                budget: int) -> List[Tuple[bool, List[int]]]:
    """Greedy ``.sig``-file assignment for a budgeted append.

    Returns ``[(extend_last, [file indices]), ...]``: files keep landing
    in the current target shard while its doc count is below ``budget``
    (so a shard can overshoot by at most one file -- splits stay at
    ``.sig``-file granularity, like ``build_sharded``), then spill into a
    NEW shard.  The first group extends the last existing shard only if
    it still had headroom.
    """
    groups: List[Tuple[bool, List[int]]] = []
    cur: List[int] = []
    cur_n = last_n
    extend = True
    for i, c in enumerate(counts):
        if cur_n >= budget:
            if cur:
                groups.append((extend, cur))
            cur, cur_n, extend = [], 0, False
        cur.append(i)
        cur_n += c
    if cur:
        groups.append((extend, cur))
    return groups


class ShardedIndex(BatchedAdmission):
    """One logical index over S ``.idx`` shards with contiguous doc ranges.

    Mirrors the ``IndexSearcher`` API (``search`` and ``submit``/
    ``flush``) and returns global doc ids.  ``searcher_kwargs``
    (``device``, ``corpus_block``, ``max_device_bytes``, ``lsh_batch``,
    ``blocks``, ...) go to every per-shard searcher -- a device window
    applies per shard, and every shard's launches take the one tile
    ``blocks``.  ``max_shard_docs`` is the spill budget of ``append``;
    ``client_factory`` wraps each searcher in a ``ShardClient`` (default:
    in-process); ``on_shard_failure`` is ``"fail"`` or ``"partial"``.

    ``mesh`` (``repro_torch.launch.mesh.Mesh``) places shard s on
    position ``s % D`` of its ``"data"`` axis -- each shard's searcher is
    pinned to that position's device, which then replaces ``device`` --
    and enables the mesh dispatcher; ``dispatch`` picks the fan-out
    (``"auto"``: the mesh iff one was given; overridable per ``search``).
    """

    def __init__(self, indexes: Sequence[SigIndex], *,
                 paths: Optional[Sequence[str]] = None,
                 manifest_dir: Optional[str] = None,
                 generation: int = 0,
                 mesh: Optional[Mesh] = None,
                 dispatch: str = "auto",
                 max_shard_docs: Optional[int] = None,
                 client_factory: Optional[Callable[[IndexSearcher],
                                                   ShardClient]] = None,
                 on_shard_failure: str = "fail",
                 **searcher_kwargs):
        if not indexes:
            raise ValueError("ShardedIndex needs at least one shard")
        self._check_dispatch(dispatch, mesh)
        if on_shard_failure not in ("fail", "partial"):
            raise ValueError(f"on_shard_failure must be 'fail' or "
                             f"'partial', got {on_shard_failure!r}")
        if max_shard_docs is not None and max_shard_docs < 1:
            raise ValueError(f"max_shard_docs must be >= 1, got "
                             f"{max_shard_docs}")
        for i, idx in enumerate(indexes[1:], 1):
            if idx.spec != indexes[0].spec or \
                    idx.banding != indexes[0].banding:
                raise ValueError(
                    f"shard {i} wire/banding {idx.spec}/{idx.banding} != "
                    f"shard 0 {indexes[0].spec}/{indexes[0].banding}")
        # the mesh's data-parallel positions: placement and the mesh
        # dispatcher address positions along "data" only, whatever other
        # axes the caller's mesh has
        self._positions = _data_positions(mesh,
                                          searcher_kwargs.get("device"))
        self._data_mesh = None
        if self._positions is not None:
            self._data_mesh = Mesh(self._positions, ("data",))
            searcher_kwargs.pop("device", None)
        self._searcher_kwargs = dict(searcher_kwargs)
        self.manifest_dir = manifest_dir
        self.mesh = mesh
        self.max_shard_docs = max_shard_docs
        self._dispatch_default = dispatch
        self._client_factory = client_factory or LocalShardClient
        self.on_shard_failure = on_shard_failure
        # one stream per CUDA position, so positions sharing a card overlap
        self._streams = None
        if self._positions is not None:
            self._streams = tuple(
                torch.cuda.Stream(device=d) if d.type == "cuda" else None
                for d in self._positions)
        self._mesh_build_lock = threading.Lock()
        # collective dispatches taken (tests pin that the mesh path, not
        # the sequential loop, served); exported by ``_router_samples``
        self._count_lock = threading.Lock()
        self.mesh_exact_dispatches = 0
        self.mesh_lsh_dispatches = 0
        reg = get_registry()
        self._m_shard_failures = reg.counter(
            "index_shard_failures_total",
            "shard dispatches that failed past their client's own "
            "retry/breaker budget", labels=("shard",))
        self._m_partial = reg.counter(
            "index_partial_searches_total",
            "searches served from surviving shards only "
            "(on_shard_failure='partial')")
        reg.register_object(self, _router_samples)
        # serializes state swaps so a refresh that read an older manifest
        # can never overwrite a concurrent append's newer state
        self._swap_lock = threading.Lock()
        devices = self._shard_devices(len(indexes))
        self._state = self._build_state(
            [self._make_searcher(idx, i, devices)
             for i, idx in enumerate(indexes)], paths, generation)
        self._admission_init()

    @staticmethod
    def _check_dispatch(dispatch: str, mesh: Optional[Mesh]) -> None:
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'auto', 'sequential' or "
                             f"'mesh', got {dispatch!r}")
        if dispatch == "mesh" and mesh is None:
            raise ValueError("dispatch='mesh' needs a mesh (pass mesh= to "
                             "ShardedIndex / load_sharded)")

    # -- placement + state construction ----------------------------------
    def _shard_devices(self, n_shards: int):
        """Round-robin shard -> position device (None without a mesh);
        stable by shard index, so tail growth never moves a shard."""
        if self._data_mesh is None:
            return None
        return place_shards(n_shards, self._data_mesh)

    def _shard_device(self, state: _RouterState, shard_i: int, devices):
        """Where shard ``shard_i`` lives: its placed position's device,
        or the router's one device without a mesh."""
        if devices is None:
            return state.searchers[0].device
        return devices[shard_i]

    def _make_searcher(self, idx: SigIndex, shard_i: int,
                       devices) -> IndexSearcher:
        if devices is None:
            return IndexSearcher(idx, **self._searcher_kwargs)
        dev = devices[shard_i]
        if idx.device != dev:       # the corpus uploads to the placed device
            idx = dataclasses.replace(idx, device=dev, _corpus=None)
        return IndexSearcher(idx, device=dev, **self._searcher_kwargs)

    def _build_state(self, searchers: Sequence[IndexSearcher],
                     paths: Optional[Sequence[str]],
                     generation: int) -> _RouterState:
        offsets = np.cumsum([0] + [s.index.n for s in searchers])[:-1]
        return _RouterState(tuple(searchers),
                            tuple(self._client_factory(s) for s in searchers),
                            offsets, tuple(paths) if paths else None,
                            generation)

    # -- snapshot accessors (each reads self._state exactly once) --------
    @property
    def searchers(self) -> Tuple[IndexSearcher, ...]:
        return self._state.searchers

    @property
    def clients(self) -> Tuple[ShardClient, ...]:
        return self._state.clients

    @property
    def offsets(self) -> np.ndarray:
        return self._state.offsets

    @property
    def paths(self) -> Optional[Tuple[str, ...]]:
        return self._state.paths

    @property
    def generation(self) -> int:
        """The manifest generation this router currently serves."""
        return self._state.generation

    @property
    def n(self) -> int:
        return self._state.n

    @property
    def n_shards(self) -> int:
        return len(self._state.searchers)

    @property
    def spec(self):
        return self._state.searchers[0].index.spec

    @property
    def device(self):
        return self._state.searchers[0].device

    # -- fan-out ---------------------------------------------------------
    def _use_mesh(self, dispatch: Optional[str]) -> bool:
        d = dispatch or self._dispatch_default
        self._check_dispatch(d, self.mesh)
        return d == "mesh" or (d == "auto" and self.mesh is not None)

    def search(self, queries: Queries, topk: int = 10, *,
               mode: str = "exact",
               query_sizes: Optional[np.ndarray] = None,
               dispatch: Optional[str] = None,
               on_shard_failure: Optional[str] = None) -> SearchResult:
        """Global top-k: fan out to every shard, merge.  LSH band keys are
        computed once per batch, not once per shard.  The shard set is
        snapshotted ONCE here, so a concurrent ``append`` / ``refresh``
        never tears this call's view.

        On the mesh dispatcher, both modes run one scan (exact) or one
        candidate rerank (LSH) per mesh position, and ``merge_topk`` folds
        the gathered per-position partials -- ids and scores equal to the
        sequential fan-out and to a single index.

        ``on_shard_failure`` (default: the constructor's) applies to the
        sequential fan-out: ``"fail"`` re-raises a shard client's
        exception; ``"partial"`` serves the surviving shards --
        bit-identical to a healthy router over just those shards -- and
        the result carries ``coverage`` (surviving docs / total docs) and
        the failed shard indices.  The mesh dispatcher has no per-shard
        failure domain.
        """
        state = self._state
        policy = on_shard_failure or self.on_shard_failure
        if policy not in ("fail", "partial"):
            raise ValueError(f"on_shard_failure must be 'fail' or "
                             f"'partial', got {policy!r}")
        use_mesh = self._use_mesh(dispatch)
        idx0 = state.searchers[0].index
        qwords = query_words(queries, idx0.spec, state.searchers[0].device)
        if mode == "exact" and use_mesh:
            return self._mesh_exact(state, qwords, topk, query_sizes)
        qkeys = None
        if mode == "lsh":
            qkeys = u32.to_numpy(band_keys_packed(qwords, idx0.spec,
                                                  idx0.banding))
            if use_mesh:
                return self._mesh_lsh(state, qwords, topk, query_sizes,
                                      qkeys)
        tracer = get_tracer()
        if policy == "partial":
            return self._fanout_partial(state, qwords, topk, mode,
                                        query_sizes, qkeys, tracer)
        with tracer.phase("shard_dispatch",
                          args={"mode": mode, "shards": len(state.clients)}):
            pending = [c.dispatch(qwords, topk, mode=mode,
                                  query_sizes=query_sizes, qkeys=qkeys)
                       for c in state.clients]
        with tracer.phase("harvest"):
            results = [p() for p in pending]
        with tracer.phase("merge"):
            return merge_topk(results, state.offsets, topk)

    def _fanout_partial(self, state: _RouterState, qwords, topk: int,
                        mode: str, query_sizes, qkeys,
                        tracer) -> SearchResult:
        """Sequential fan-out that survives shard-client failures.

        A shard can fail at dispatch (its breaker is open) or at harvest
        (a transport fault past the retry budget); either way it drops
        out and the survivors merge **with their original offsets** --
        exactly what a healthy router over the surviving shards returns
        (``merge_topk`` is a pure function of (score, global id)).
        """
        failed: dict = {}
        with tracer.phase("shard_dispatch",
                          args={"mode": mode, "shards": len(state.clients)}):
            pending = []
            for si, c in enumerate(state.clients):
                try:
                    pending.append(c.dispatch(qwords, topk, mode=mode,
                                              query_sizes=query_sizes,
                                              qkeys=qkeys))
                except Exception as e:
                    pending.append(None)
                    failed[si] = e
        with tracer.phase("harvest"):
            results = []
            for si, p in enumerate(pending):
                if p is None:
                    results.append(None)
                    continue
                try:
                    results.append(p())
                except Exception as e:
                    results.append(None)
                    failed[si] = e
        if failed:
            for si in failed:
                self._m_shard_failures.labels(shard=str(si)).inc()
            if len(failed) == len(state.clients):
                last = failed[max(failed)]
                raise RuntimeError(
                    f"all {len(state.clients)} shards failed "
                    f"(last: {last!r})") from last
            self._m_partial.inc()
        with tracer.phase("merge"):
            if not failed:
                return merge_topk(results, state.offsets, topk)
            keep = [si for si in range(len(results)) if si not in failed]
            merged = merge_topk([results[si] for si in keep],
                                state.offsets[keep], topk)
        n_live = int(sum(state.searchers[si].index.n for si in keep))
        return dataclasses.replace(merged, coverage=n_live / state.n,
                                   failed_shards=tuple(sorted(failed)))

    # -- the mesh dispatcher ---------------------------------------------
    def mesh_layout(self) -> MeshLayout:
        """The stacked per-position corpus the mesh dispatcher scans for
        the current state (built on first use)."""
        if self.mesh is None:
            raise ValueError("mesh_layout needs a mesh (pass mesh= to "
                             "ShardedIndex / load_sharded)")
        return self._mesh_layout(self._state)

    def _mesh_layout(self, state: _RouterState) -> MeshLayout:
        """Build the state's ``MeshLayout`` once, under a lock; each
        position's tensors upload by blocking copies, so they are whole
        for every stream that reads them."""
        cached = state.cache.get("mesh")
        if cached is not None:
            return cached
        with self._mesh_build_lock:
            cached = state.cache.get("mesh")
            if cached is not None:
                return cached
            searchers = state.searchers
            D = len(self._positions)
            meta0 = searchers[0].index.meta
            block = max(s.corpus_block for s in searchers)
            heights = [-(-s.index.n // block) * block for s in searchers]
            groups = [range(d, len(searchers), D) for d in range(D)]
            rows = max(sum(heights[s] for s in g) or block for g in groups)
            has_sizes = (searchers[0].index.set_sizes is not None
                         and meta0.s > 0)
            corpora, ids, sizes = [], [], []
            shard_pos = [None] * len(searchers)
            for d, group in enumerate(groups):
                corpus = np.zeros((rows, meta0.words), np.uint32)
                gid = np.full(rows, -1, np.int64)
                dsz = np.zeros(rows, np.int64) if has_sizes else None
                pos = 0
                for s in group:
                    idx = searchers[s].index
                    shard_pos[s] = (d, pos)
                    corpus[pos:pos + idx.n] = idx.words_host
                    gid[pos:pos + idx.n] = (int(state.offsets[s])
                                            + np.arange(idx.n))
                    if has_sizes:
                        dsz[pos:pos + idx.n] = idx.set_sizes
                    pos += heights[s]
                dev = self._positions[d]
                corpora.append(torch.from_numpy(corpus.view(np.int32)).to(dev))
                ids.append(torch.from_numpy(gid).to(dev))
                if has_sizes:
                    sizes.append(torch.from_numpy(dsz).to(dev))
            layout = MeshLayout(tuple(corpora), tuple(ids),
                                tuple(sizes) if has_sizes else None,
                                tuple(shard_pos), block, rows)
            state.cache["mesh"] = layout
            return layout

    @staticmethod
    def _check_mesh_resident(state: _RouterState) -> None:
        streamed = [s for s in state.searchers if s.streamed]
        if streamed:
            raise ValueError(
                "mesh dispatch holds the stacked corpus device-resident "
                "and cannot honor max_device_bytes "
                f"({len(streamed)} shard(s) would stream); use "
                "dispatch='sequential' for out-of-core shards")

    @staticmethod
    def _check_sizes(layout: MeshLayout, query_sizes) -> None:
        if layout.doc_sizes is not None and query_sizes is None:
            raise ValueError("index stores set sizes; pass query_sizes "
                             "to search() for the exact Theorem-1 rerank")

    @contextlib.contextmanager
    def _on_position(self, d: int):
        """Position d's device and stream as the current ones."""
        stream = self._streams[d]
        if stream is None:
            yield
            return
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            yield

    def _per_position(self, layout: MeshLayout, qwords: torch.Tensor,
                      query_sizes, body) -> List[SearchResult]:
        """Run ``body(d, qwords, q_sizes)`` -> (scores, global ids) on
        every position, each launched on its own device and stream before
        any is gathered; then gather the (D, Q, k) partials to the host.
        Each position's stream first waits for the caller's, which wrote
        ``qwords``."""
        caller = (torch.cuda.current_stream(qwords.device)
                  if qwords.is_cuda else None)
        pending = []
        for d in range(layout.D):
            with self._on_position(d):
                stream = self._streams[d]
                if stream is not None and caller is not None:
                    stream.wait_stream(caller)
                dev = self._positions[d]
                qs = None
                if query_sizes is not None:
                    qs = torch.from_numpy(np.asarray(query_sizes).astype(
                        np.int64)).to(dev)
                pending.append(body(d, qwords.to(dev), qs))
        out = []
        for d, (sc, ids) in enumerate(pending):
            with self._on_position(d):
                out.append(SearchResult(ids.cpu().numpy(), sc.cpu().numpy()))
        return out

    @staticmethod
    def _resident(layout: MeshLayout, d: int):
        """Position d's corpus, ids and set sizes, recorded on the current
        stream."""
        sizes = layout.doc_sizes
        return (on_stream(layout.corpora[d]), on_stream(layout.ids[d]),
                None if sizes is None else on_stream(sizes[d]))

    def _count(self, mode: str) -> None:
        with self._count_lock:
            if mode == "exact":
                self.mesh_exact_dispatches += 1
            else:
                self.mesh_lsh_dispatches += 1

    def _mesh_exact(self, state: _RouterState, qwords, topk: int,
                    query_sizes) -> SearchResult:
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        self._check_mesh_resident(state)
        layout = self._mesh_layout(state)
        self._check_sizes(layout, query_sizes)
        kk = min(topk, state.n)
        s0 = state.searchers[0]

        def scan(d, q, qs):
            corpus, ids, sizes = self._resident(layout, d)
            return exact_scan_ids(q, corpus, ids, qs, sizes,
                                  meta=s0.index.meta, match=s0.match_counts,
                                  block=layout.block, topk=kk)

        tracer = get_tracer()
        with tracer.phase("mesh_dispatch", args={"mode": "exact",
                                                 "devices": layout.D}):
            parts = self._per_position(layout, qwords, query_sizes, scan)
            self._count("exact")
        with tracer.phase("merge"):
            return merge_topk(parts, [0] * layout.D, topk)

    def _mesh_lsh(self, state: _RouterState, qwords, topk: int,
                  query_sizes, qkeys: np.ndarray) -> SearchResult:
        """LSH candidates + rerank, one rerank per position.

        Candidate generation stays a host-side bucket probe per shard;
        shards are disjoint doc ranges, so a position's columns are the
        concatenation of its shards' candidate unions, in ascending
        global ids.  Every position is padded to one width, a power of
        two >= 128 (the single searcher's rule); padding slots point at
        row 0 with membership False.
        """
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        self._check_mesh_resident(state)
        layout = self._mesh_layout(state)
        self._check_sizes(layout, query_sizes)
        tracer = get_tracer()
        D, q = layout.D, qwords.shape[0]
        cand_cols: List[List[np.ndarray]] = [[] for _ in range(D)]
        mem_cols: List[List[np.ndarray]] = [[] for _ in range(D)]
        n_cand = np.zeros(q, np.int64)
        span = tracer.start_span("candidates",
                                 args={"shards": len(state.searchers)})
        for s, searcher in enumerate(state.searchers):
            d, pos = layout.shard_pos[s]
            per_q = searcher.index.candidates_batch(qkeys)
            n_cand += np.array([c.size for c in per_q], np.int64)
            if not any(c.size for c in per_q):
                continue
            union = np.unique(np.concatenate(per_q))
            member = np.zeros((q, union.size), bool)
            for i, c in enumerate(per_q):
                member[i, np.searchsorted(union, c)] = True
            cand_cols[d].append(pos + union)
            mem_cols[d].append(member)
        tracer.end_span(span)
        widths = [sum(a.size for a in cols) for cols in cand_cols]
        if max(widths) == 0:
            return SearchResult(np.full((q, topk), -1, np.int64),
                                np.full((q, topk), -np.inf, np.float32),
                                n_cand)
        c_pad = max(128, 1 << int(max(widths) - 1).bit_length())
        cand = np.zeros((D, c_pad), np.int64)
        member = np.zeros((D, q, c_pad), bool)
        for d in range(D):
            if cand_cols[d]:
                cand[d, :widths[d]] = np.concatenate(cand_cols[d])
                member[d, :, :widths[d]] = np.concatenate(mem_cols[d],
                                                          axis=1)
        kk = min(topk, c_pad)
        s0 = state.searchers[0]

        def rerank(d, qw, qs):
            corpus, ids, sizes = self._resident(layout, d)
            dev = self._positions[d]
            return lsh_rerank_ids(qw, corpus, ids,
                                  torch.from_numpy(cand[d]).to(dev),
                                  torch.from_numpy(member[d]).to(dev), qs,
                                  sizes, meta=s0.index.meta,
                                  match=s0.match_counts, topk=kk)

        with tracer.phase("mesh_dispatch", args={"mode": "lsh",
                                                 "devices": D}):
            parts = self._per_position(layout, qwords, query_sizes, rerank)
            self._count("lsh")
        with tracer.phase("merge"):
            merged = merge_topk(parts, [0] * D, topk)
        return SearchResult(merged.indices, merged.scores, n_cand)

    # -- live growth -----------------------------------------------------
    def append(self, sig_paths: Sequence[str], *,
               set_sizes: Optional[np.ndarray] = None
               ) -> List[Tuple[str, object]]:
        """Append new documents, concurrently safe with readers.

        Without ``max_shard_docs`` the LAST shard grows (``append_index``;
        earlier shards would shift global ids).  With a budget, ``.sig``
        files keep extending the last shard while it has headroom, then
        *spill* into NEW tail shards at file granularity, published
        atomically and visible only through the manifest rewrite at the
        end.  Holds the directory lock (two appenders serialize),
        refreshes first, rewrites the manifest with a bumped generation
        and swaps this router's state in one assignment.  Existing global
        ids are unchanged.  Returns ``[(shard_path, IndexMeta), ...]`` for
        every touched shard.  Requires a router from ``load_sharded``.
        """
        if not self.paths or not self.manifest_dir:
            raise ValueError("append needs shard paths and a manifest dir; "
                             "load this index via load_sharded()")
        with sharded_lock(self.manifest_dir):
            self.refresh()
            state = self._state
            meta0 = state.searchers[0].index.meta
            if set_sizes is not None:
                set_sizes = np.ascontiguousarray(set_sizes, np.uint32)
            if meta0.has_set_sizes and set_sizes is None:
                raise ValueError("index stores set sizes; append needs "
                                 "set_sizes for the new documents")
            if not meta0.has_set_sizes and set_sizes is not None:
                raise ValueError("index has no set sizes; cannot add them "
                                 "on append")
            counts = [read_sig_meta(p).n for p in sig_paths]
            if self.max_shard_docs is None:
                groups = [(True, list(range(len(sig_paths))))]
            else:
                groups = _plan_spill(state.searchers[-1].index.n, counts,
                                     self.max_shard_docs)
            paths = list(state.paths)
            searchers = list(state.searchers)
            devices = self._shard_devices(
                len(paths) + sum(1 for ext, _ in groups if not ext))
            touched: List[Tuple[str, object]] = []
            doc0 = 0
            for extend, file_idx in groups:
                files = [sig_paths[i] for i in file_idx]
                n_g = sum(counts[i] for i in file_idx)
                sizes_g = (None if set_sizes is None
                           else set_sizes[doc0:doc0 + n_g])
                i = len(paths) - 1 if extend else len(paths)
                dev = self._shard_device(state, i, devices)
                if extend:
                    last = paths[-1]
                    meta = append_index(last, files, set_sizes=sizes_g,
                                        device=dev)
                    searchers[-1] = self._make_searcher(
                        load_index(last, device=dev), i, devices)
                    touched.append((last, meta))
                else:
                    path = os.path.join(self.manifest_dir,
                                        f"shard_{len(paths):05d}.idx")
                    meta = build_index(files, path, meta0.banding,
                                       set_sizes=sizes_g, s=meta0.s,
                                       atomic=True, device=dev)
                    searchers.append(self._make_searcher(
                        load_index(path, device=dev), i, devices))
                    paths.append(path)
                    touched.append((path, meta))
                doc0 += n_g
            write_manifest(self.manifest_dir, paths,
                           [s.index.n for s in searchers],
                           generation=state.generation + 1)
            with self._swap_lock:
                self._state = self._build_state(searchers, paths,
                                                state.generation + 1)
        return touched

    def refresh(self, *, max_attempts: int = 5) -> bool:
        """Re-read the manifest; reload shards another router changed.

        Returns True when the served state moved.  Only shards whose
        (name, doc count) differ from the current snapshot reload;
        unchanged shards keep their searcher and device-resident corpus.
        If a writer replaces a shard file between the manifest read and
        the shard load (the loaded count disagrees with the manifest),
        the whole read retries -- the swapped-in state is always
        internally consistent.
        """
        if not self.manifest_dir:
            return False
        for _ in range(max_attempts):
            manifest = read_manifest(self.manifest_dir)
            state = self._state
            if manifest["generation"] == state.generation:
                return False
            names = manifest["shards"]
            counts = [int(b) - int(a) for a, b in
                      zip(manifest["offsets"],
                          list(manifest["offsets"][1:]) + [manifest["n"]])]
            paths = [os.path.join(self.manifest_dir, nm) for nm in names]
            old = {}
            if state.paths:
                old = {(p, s.index.n): s
                       for p, s in zip(state.paths, state.searchers)}
            devices = self._shard_devices(len(paths))
            searchers = []
            consistent = True
            for i, (path, count) in enumerate(zip(paths, counts)):
                keep = old.get((path, count))
                if keep is not None:
                    searchers.append(keep)
                    continue
                dev = self._shard_device(state, i, devices)
                loaded = self._make_searcher(load_index(path, device=dev),
                                             i, devices)
                if loaded.index.n != count:
                    consistent = False     # raced a writer; re-read
                    break
                searchers.append(loaded)
            if consistent:
                with self._swap_lock:
                    if manifest["generation"] <= self._state.generation:
                        return False   # a concurrent append moved further
                    self._state = self._build_state(searchers, paths,
                                                    manifest["generation"])
                return True
        raise RuntimeError(
            f"refresh({self.manifest_dir}) kept racing a writer: shard "
            f"doc counts never matched the manifest after "
            f"{max_attempts} attempts")


def _data_positions(mesh: Optional[Mesh], device) -> Optional[tuple]:
    """The devices of the mesh's ``"data"`` positions (None without a
    mesh); a ``device`` given beside a mesh must be of their type."""
    if mesh is None:
        return None
    positions = data_axis_devices(mesh)
    if device is not None and any(torch.device(device).type != p.type
                                  for p in positions):
        raise ValueError(f"device={device!r} disagrees with the mesh's "
                         f"positions {sorted({str(p) for p in positions})}")
    return positions


def load_sharded(shard_dir: str, *, mesh: Optional[Mesh] = None,
                 dispatch: str = "auto",
                 max_shard_docs: Optional[int] = None,
                 **searcher_kwargs) -> ShardedIndex:
    """Load a ``build_sharded`` output directory into a ``ShardedIndex``.

    ``searcher_kwargs`` go to the router (``client_factory``,
    ``on_shard_failure``) and to every per-shard ``IndexSearcher``
    (``device`` -- also to ``load_index`` --, ``corpus_block``,
    ``max_device_bytes``, ``lsh_batch``, ...); ``mesh`` / ``dispatch``
    configure the fan-out (with a mesh each shard loads onto its placed
    position's device), ``max_shard_docs`` is the append spill budget.
    """
    ShardedIndex._check_dispatch(dispatch, mesh)
    device = searcher_kwargs.get("device")
    _data_positions(mesh, device)
    manifest = read_manifest(shard_dir)
    paths = [os.path.join(shard_dir, name) for name in manifest["shards"]]
    placed = (place_shards(len(paths), mesh) if mesh is not None and paths
              else None)
    indexes = [load_index(p, device=placed[i] if placed else device)
               for i, p in enumerate(paths)]
    sharded = ShardedIndex(indexes, paths=paths, manifest_dir=shard_dir,
                           generation=manifest["generation"], mesh=mesh,
                           dispatch=dispatch, max_shard_docs=max_shard_docs,
                           **searcher_kwargs)
    if sharded.n != manifest["n"]:
        raise ValueError(f"{os.path.join(shard_dir, MANIFEST_NAME)}: "
                         f"manifest n={manifest['n']} != loaded {sharded.n}")
    return sharded
