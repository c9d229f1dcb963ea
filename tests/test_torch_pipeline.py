"""The port's loader and cache machinery on the CPU: shard formats (read
back by the JAX package's readers), retries, prefetch, and the
SignatureCache budget / TTL paths."""

import os
import random

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic import TINY, generate_sets
from repro_torch.train.online import SignatureCache, make_family


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K, B, S = 64, 8, 16


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    (sets, labels), _ = generate_sets(TINY)
    d = tmp_path_factory.mktemp("raw")
    return sets, labels, tpipe.write_shards(sets, labels, str(d), 3)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_shard_formats_read_by_reference(raw, tmp_path, fmt):
    sets, labels, _ = raw
    paths = tpipe.write_shards(sets[:50], labels[:50], str(tmp_path), 2, fmt)
    reader = jpipe.read_shard_binary if fmt == "binary" else jpipe.read_shard_libsvm
    got = [reader(p) for p in paths]
    flat = [s for g in got for s in g[0]]
    assert len(flat) == 50
    for a, b in zip(flat, sets[:50]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  labels[:50])


def test_chunked_loader_pads_like_reference(raw):
    sets, labels, paths = raw
    chunks = list(tpipe.ChunkedLoader(paths, chunk_size=64, device="cpu"))
    assert [c.n for c in chunks] == [64, 64, 64, len(sets) - 192]
    for c in chunks:
        assert c.max_nnz % 128 == 0 and c.indices.dtype == torch.int32
    first = chunks[0]
    for i in range(64):
        m = int(first.nnz_per_row()[i])
        np.testing.assert_array_equal(first.indices[i, :m].numpy(), sets[i])


def test_read_with_retries_accounts_every_attempt(tmp_path):
    path = tmp_path / "f"
    path.write_bytes(b"x" * 10)
    calls = []

    def flaky(p):
        calls.append(p)
        if len(calls) < 3:
            raise OSError("flap")
        return "ok"

    stats = tpipe.LoaderStats()
    sleeps = []
    out = tpipe.read_with_retries(flaky, str(path), stats, deadline=10.0,
                                  max_retries=3, rng=random.Random(0),
                                  sleep=sleeps.append)
    assert out == "ok" and stats.io_errors == 2 and len(sleeps) == 2
    assert stats.bytes_read == 10
    with pytest.raises(OSError):
        tpipe.read_with_retries(lambda p: (_ for _ in ()).throw(OSError("x")),
                                str(path), stats, deadline=10.0,
                                max_retries=1, sleep=lambda s: None)


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise ValueError("boom")

    it = tpipe.prefetch_iter(gen, 2)
    assert next(it) == 1
    with pytest.raises(ValueError):
        next(it)


def _words(chunks):
    return [c[0].data.clone() for c in chunks]


def test_cache_budget_tail_rehashes_and_matches(raw, tmp_path):
    _, _, paths = raw
    fam = make_family("oph", K, S, generator=torch.Generator().manual_seed(1),
                      device="cpu")
    fresh = _words(tpipe.SignatureStream(paths, fam, b=B, chunk_size=64,
                                         packed=True))
    cache = SignatureCache(tpipe.SignatureStream(paths, fam, b=B,
                                                 chunk_size=64, packed=True),
                           cache_dir=str(tmp_path / "c"), max_cache_bytes=1)
    epoch0 = _words(cache)
    assert cache.stats.shards == 1 and cache.stats.uncached_chunks == 3
    replay = _words(cache)
    for a, b, c in zip(fresh, epoch0, replay):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert len(replay) == len(fresh)
    cache.close()
    assert not [f for f in os.listdir(tmp_path / "c") if f.endswith(".sig")]


def test_cache_ttl_expiry_repopulates(raw, tmp_path):
    _, _, paths = raw
    fam = make_family("2u", K, S, generator=torch.Generator().manual_seed(2),
                      device="cpu")
    with SignatureCache(tpipe.SignatureStream(paths, fam, b=B, chunk_size=64),
                        ttl_s=3600.0) as cache:
        first = [s.clone() for s, _ in cache]
        assert cache.populated
        for p in cache.paths:
            os.utime(p, (0, 0))                 # make every shard stale
        again = [s.clone() for s, _ in cache]
        assert cache.ttl_dropped == len(first)
        assert cache.cumulative_stats["source"] == "cache"
        for a, b in zip(first, again):
            assert torch.equal(a, b)
        cache_dir = cache.cache_dir
    assert not os.path.exists(cache_dir)
