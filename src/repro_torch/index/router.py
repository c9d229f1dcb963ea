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

The mesh (``shard_map``) dispatcher of the reference is not ported; the
``torch.distributed`` fan-out is ROADMAP.md queue 1, "The multi-GPU mesh
path".
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import u32
from repro_torch.data.sigshard import read_sig_meta
from repro_torch.index.banding import band_keys_packed
from repro_torch.index.builder import (MANIFEST_NAME, SigIndex, append_index,
                                       build_index, load_index, read_manifest,
                                       sharded_lock, write_manifest)
from repro_torch.index.query import (BatchedAdmission, IndexSearcher,
                                     Queries, SearchResult, query_words)
from repro_torch.obs.metrics import Sample, get_registry
from repro_torch.obs.trace import get_tracer

MESH_NOT_PORTED = ("dispatch='mesh' is not ported: the torch.distributed "
                   "fan-out is ROADMAP.md queue 1, 'The multi-GPU mesh "
                   "path'; use dispatch='sequential'")


def _router_samples(router: "ShardedIndex"):
    """Registry collector over one live ``ShardedIndex`` (weakref'd): the
    mesh-dispatch counters (always 0 here: no mesh dispatcher; kept so the
    exported families equal the reference's), plus the served manifest
    generation / corpus size as gauges."""
    state = router._state
    for mode in ("exact", "lsh"):
        yield Sample("index_mesh_dispatches_total", "counter",
                     "shard_map collective dispatches taken",
                     (("mode", mode),), 0.0)
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
    query old offsets with new searchers.
    """

    searchers: Tuple[IndexSearcher, ...]
    clients: Tuple[ShardClient, ...]
    offsets: np.ndarray            # global doc-id offset per shard
    paths: Optional[Tuple[str, ...]]
    generation: int

    @property
    def n(self) -> int:
        return int(sum(s.index.n for s in self.searchers))


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
    ...) go to every per-shard searcher -- a device window applies per
    shard.  ``max_shard_docs`` is the spill budget of ``append``;
    ``client_factory`` wraps each searcher in a ``ShardClient`` (default:
    in-process); ``on_shard_failure`` is ``"fail"`` or ``"partial"``.
    ``dispatch`` is ``"auto"`` or ``"sequential"`` (the one fan-out here);
    ``"mesh"`` raises.
    """

    def __init__(self, indexes: Sequence[SigIndex], *,
                 paths: Optional[Sequence[str]] = None,
                 manifest_dir: Optional[str] = None,
                 generation: int = 0,
                 dispatch: str = "auto",
                 max_shard_docs: Optional[int] = None,
                 client_factory: Optional[Callable[[IndexSearcher],
                                                   ShardClient]] = None,
                 on_shard_failure: str = "fail",
                 **searcher_kwargs):
        if not indexes:
            raise ValueError("ShardedIndex needs at least one shard")
        self._check_dispatch(dispatch)
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
        self._searcher_kwargs = dict(searcher_kwargs)
        self.manifest_dir = manifest_dir
        self.max_shard_docs = max_shard_docs
        self._client_factory = client_factory or LocalShardClient
        self.on_shard_failure = on_shard_failure
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
        self._state = self._build_state(
            [self._make_searcher(idx) for idx in indexes], paths, generation)
        self._admission_init()

    @staticmethod
    def _check_dispatch(dispatch: str) -> None:
        if dispatch == "mesh":
            raise NotImplementedError(MESH_NOT_PORTED)
        if dispatch not in ("auto", "sequential"):
            raise ValueError(f"dispatch must be 'auto', 'sequential' or "
                             f"'mesh', got {dispatch!r}")

    def _make_searcher(self, idx: SigIndex) -> IndexSearcher:
        return IndexSearcher(idx, **self._searcher_kwargs)

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
    def search(self, queries: Queries, topk: int = 10, *,
               mode: str = "exact",
               query_sizes: Optional[np.ndarray] = None,
               dispatch: Optional[str] = None,
               on_shard_failure: Optional[str] = None) -> SearchResult:
        """Global top-k: dispatch every shard, harvest, merge.  LSH band
        keys are computed once per batch, not once per shard.  The shard
        set is snapshotted ONCE here, so a concurrent ``append`` /
        ``refresh`` never tears this call's view.

        ``on_shard_failure`` (default: the constructor's): ``"fail"``
        re-raises a shard client's exception; ``"partial"`` serves the
        surviving shards -- bit-identical to a healthy router over just
        those shards -- and the result carries ``coverage`` (surviving
        docs / total docs) and the failed shard indices.
        """
        if dispatch is not None:
            self._check_dispatch(dispatch)
        state = self._state
        policy = on_shard_failure or self.on_shard_failure
        if policy not in ("fail", "partial"):
            raise ValueError(f"on_shard_failure must be 'fail' or "
                             f"'partial', got {policy!r}")
        idx0 = state.searchers[0].index
        qwords = query_words(queries, idx0.spec, state.searchers[0].device)
        qkeys = None
        if mode == "lsh":
            qkeys = u32.to_numpy(band_keys_packed(qwords, idx0.spec,
                                                  idx0.banding))
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
            dev = state.searchers[0].device
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
            touched: List[Tuple[str, object]] = []
            doc0 = 0
            for extend, file_idx in groups:
                files = [sig_paths[i] for i in file_idx]
                n_g = sum(counts[i] for i in file_idx)
                sizes_g = (None if set_sizes is None
                           else set_sizes[doc0:doc0 + n_g])
                if extend:
                    last = paths[-1]
                    meta = append_index(last, files, set_sizes=sizes_g,
                                        device=dev)
                    searchers[-1] = self._make_searcher(
                        load_index(last, device=dev))
                    touched.append((last, meta))
                else:
                    path = os.path.join(self.manifest_dir,
                                        f"shard_{len(paths):05d}.idx")
                    meta = build_index(files, path, meta0.banding,
                                       set_sizes=sizes_g, s=meta0.s,
                                       atomic=True, device=dev)
                    searchers.append(self._make_searcher(
                        load_index(path, device=dev)))
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
            dev = state.searchers[0].device
            searchers = []
            consistent = True
            for path, count in zip(paths, counts):
                keep = old.get((path, count))
                if keep is not None:
                    searchers.append(keep)
                    continue
                loaded = self._make_searcher(load_index(path, device=dev))
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


def load_sharded(shard_dir: str, *, dispatch: str = "auto",
                 max_shard_docs: Optional[int] = None,
                 **searcher_kwargs) -> ShardedIndex:
    """Load a ``build_sharded`` output directory into a ``ShardedIndex``.

    ``searcher_kwargs`` go to the router (``client_factory``,
    ``on_shard_failure``) and to every per-shard ``IndexSearcher``
    (``device`` -- also to ``load_index`` --, ``corpus_block``,
    ``max_device_bytes``, ``lsh_batch``, ...); ``max_shard_docs`` is the
    append spill budget.
    """
    ShardedIndex._check_dispatch(dispatch)
    manifest = read_manifest(shard_dir)
    paths = [os.path.join(shard_dir, name) for name in manifest["shards"]]
    indexes = [load_index(p, device=searcher_kwargs.get("device"))
               for p in paths]
    sharded = ShardedIndex(indexes, paths=paths, manifest_dir=shard_dir,
                           generation=manifest["generation"],
                           dispatch=dispatch, max_shard_docs=max_shard_docs,
                           **searcher_kwargs)
    if sharded.n != manifest["n"]:
        raise ValueError(f"{os.path.join(shard_dir, MANIFEST_NAME)}: "
                         f"manifest n={manifest['n']} != loaded {sharded.n}")
    return sharded
