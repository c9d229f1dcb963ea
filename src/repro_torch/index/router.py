"""Sharded-index router (port of ``repro.index.router``, the sequential
fan-out): fan a query batch across ``.idx`` shards and merge the
per-shard top-k bit-identically to a single-index search.

  * ``ShardedIndex`` -- per-shard ``IndexSearcher``s and the global doc-id
    offsets, reached through the ``ShardClient`` seam.  ``search``
    dispatches every shard before it harvests any (each shard's kernel
    launches are queued on the stream), then ``merge_topk`` folds the
    results.
  * ``merge_topk`` -- lexicographic (descending score, ascending global
    id) fold of per-shard (scores, local ids): ``lax.top_k``'s tie rule
    over the whole corpus, so the merged ids AND scores equal a
    single-index search, whatever the partition.
  * ``load_sharded`` -- read ``manifest.json`` + shards from a
    ``build_sharded`` output directory.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import u32
from repro_torch.index.banding import band_keys_packed
from repro_torch.index.builder import (MANIFEST_NAME, SigIndex, load_index,
                                       read_manifest)
from repro_torch.index.query import (BatchedAdmission, IndexSearcher,
                                     Queries, SearchResult, query_words)


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
    callable producing its ``SearchResult`` (scores + LOCAL doc ids)."""

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        raise NotImplementedError


class LocalShardClient(ShardClient):
    """In-process ``ShardClient``: a direct ``IndexSearcher.dispatch``."""

    def __init__(self, searcher: IndexSearcher):
        self.searcher = searcher

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        return self.searcher.dispatch(qwords, topk, mode=mode,
                                      query_sizes=query_sizes, qkeys=qkeys)


class ShardedIndex(BatchedAdmission):
    """One logical index over S ``.idx`` shards with contiguous doc ranges.

    Mirrors the ``IndexSearcher`` API (``search`` and ``submit``/
    ``flush``) and returns global doc ids.  ``searcher_kwargs``
    (``device``, ``corpus_block``) go to every per-shard searcher.
    """

    def __init__(self, indexes: Sequence[SigIndex], **searcher_kwargs):
        if not indexes:
            raise ValueError("ShardedIndex needs at least one shard")
        for i, idx in enumerate(indexes[1:], 1):
            if idx.spec != indexes[0].spec or \
                    idx.banding != indexes[0].banding:
                raise ValueError(
                    f"shard {i} wire/banding {idx.spec}/{idx.banding} != "
                    f"shard 0 {indexes[0].spec}/{indexes[0].banding}")
        self.searchers = tuple(IndexSearcher(idx, **searcher_kwargs)
                               for idx in indexes)
        self.clients = tuple(LocalShardClient(s) for s in self.searchers)
        self.offsets = np.cumsum([0] + [idx.n for idx in indexes])[:-1]
        self._admission_init()

    @property
    def n(self) -> int:
        return int(sum(s.index.n for s in self.searchers))

    @property
    def n_shards(self) -> int:
        return len(self.searchers)

    @property
    def spec(self):
        return self.searchers[0].index.spec

    @property
    def device(self):
        return self.searchers[0].device

    def search(self, queries: Queries, topk: int = 10, *,
               mode: str = "exact",
               query_sizes: Optional[np.ndarray] = None) -> SearchResult:
        """Global top-k: dispatch every shard, harvest, merge.  LSH band
        keys are computed once per batch, not once per shard."""
        qwords = query_words(queries, self.spec, self.device)
        qkeys = None
        if mode == "lsh":
            idx0 = self.searchers[0].index
            qkeys = u32.to_numpy(band_keys_packed(qwords, idx0.spec,
                                                  idx0.banding))
        pending = [c.dispatch(qwords, topk, mode=mode,
                              query_sizes=query_sizes, qkeys=qkeys)
                   for c in self.clients]
        return merge_topk([p() for p in pending], self.offsets, topk)


def load_sharded(shard_dir: str, **searcher_kwargs) -> ShardedIndex:
    """Load a ``build_sharded`` output directory into a ``ShardedIndex``;
    ``searcher_kwargs`` (``device``, ``corpus_block``) go to every shard
    (``device`` also to ``load_index``)."""
    manifest = read_manifest(shard_dir)
    paths = [os.path.join(shard_dir, name) for name in manifest["shards"]]
    indexes = [load_index(p, device=searcher_kwargs.get("device"))
               for p in paths]
    sharded = ShardedIndex(indexes, **searcher_kwargs)
    if sharded.n != manifest["n"]:
        raise ValueError(f"{os.path.join(shard_dir, MANIFEST_NAME)}: "
                         f"manifest n={manifest['n']} != loaded {sharded.n}")
    return sharded
