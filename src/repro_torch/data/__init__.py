"""Data layer: sparse batches, synthetic data, shard I/O, the chunked
loader, ``.sig`` signature shards and §3 batch preprocessing."""
