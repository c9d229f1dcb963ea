"""Similarity search over packed signatures (port of ``repro.index``).

  banding.py -- band keys from packed words (on the device), the S-curve
                and the ``choose_band_config`` tuner.
  builder.py -- ``build_index``: ``.sig`` shards -> one mmap-able ``.idx``
                (byte-identical to the reference's); ``load_index`` ->
                ``SigIndex`` with the packed corpus on the device;
                ``build_sharded`` -> S contiguous-range shards + manifest;
                ``append_index`` / ``merge_band_tables``: live growth.
  query.py   -- ``IndexSearcher``: exact top-k (blocked scan with a
                running top-k, in-core or streamed in ``StreamPlan``
                windows) and LSH candidates + kernel rerank (in
                ``lsh_batch`` sub-batches), with batched admission
                (``submit`` / ``flush``).
  router.py  -- ``ShardedIndex``: sequential fan-out over shard clients,
                or the mesh dispatcher (one stacked corpus and one scan or
                rerank per mesh position), and ``merge_topk``, bit-identical
                to a single index; live ``append`` / ``refresh``, partial
                results.
  transport.py  -- ``ShardService`` / ``SocketShardClient``: the ``bSHr``
                   loopback-TCP shard transport.
  resilience.py -- deadlines, retries, hedging, breakers, chaos.

The scoring hot path is ``repro_torch.kernels.hamming.packed_match``
(``csrc/hamming.cu`` on the card).
"""

from repro_torch.index.banding import (BandingConfig, band_keys_from_codes,
                                       band_keys_packed, choose_band_config,
                                       s_curve)
from repro_torch.index.builder import (IndexMeta, SigIndex, append_index,
                                       build_band_tables, build_index,
                                       build_sharded, load_index,
                                       merge_band_tables, read_index_meta,
                                       sharded_lock)
from repro_torch.index.query import (IndexSearcher, SearchResult, StreamPlan,
                                     resemblance_scores)
from repro_torch.index.router import (LocalShardClient, ShardClient,
                                      ShardedIndex, load_sharded, merge_topk)

__all__ = [
    "BandingConfig", "IndexMeta", "IndexSearcher", "LocalShardClient",
    "SearchResult", "ShardClient", "ShardedIndex", "SigIndex", "StreamPlan",
    "append_index", "band_keys_from_codes", "band_keys_packed",
    "build_band_tables", "build_index", "build_sharded",
    "choose_band_config", "load_index", "load_sharded", "merge_band_tables",
    "merge_topk", "read_index_meta", "resemblance_scores", "s_curve",
    "sharded_lock",
]
