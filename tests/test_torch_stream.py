"""Port parity for the out-of-core scan, LSH sub-batches and live growth:

  * ``StreamPlan``: equal to the reference's plan over a grid of budgets,
    prefetch depths and block heights, including budgets that shrink the
    prefetch and then the block;
  * the streamed exact scan: bit-identical to the in-core scan and to the
    reference's streamed scan, on the sparse-limit and the sentinel wire;
    with set sizes (Theorem-1 rerank) bit-identical to the in-core scan,
    and ids equal / scores within 1e-6 of the reference (the stated
    tolerance of ``tests/test_torch_index.py``: XLA's float32 ``expm1``);
    the pipeline's high-water mark of live windows within
    ``StreamPlan.inflight``;
  * ``lsh_batch``: the same ids, scores and candidate counts as one batch;
  * ``device_put_iter`` on the CPU: order, contents, errors, accounting;
  * ``append_index`` / ``merge_band_tables`` and a spilling
    ``ShardedIndex.append``: ``.idx`` and ``manifest.json`` bytes equal to
    the reference's; ``refresh`` picks up another router's append (one of
    each package); a search racing an append is never torn.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import BandingConfig as JBanding
from repro.index import IndexSearcher as JSearcher
from repro.index import build_index as j_build_index
from repro.index import build_sharded as j_build_sharded
from repro.index import load_index as j_load_index
from repro.index import load_sharded as j_load_sharded
from repro.index.builder import append_index as j_append_index
from repro.index.builder import build_band_tables as j_build_band_tables
from repro.index.builder import merge_band_tables as j_merge_band_tables
from repro_torch.data.pipeline import WindowStats, device_put_iter
from repro_torch.index import (BandingConfig, IndexSearcher, ShardedIndex,
                               append_index, build_band_tables, build_index,
                               build_sharded, choose_band_config, load_index,
                               load_sharded, merge_band_tables)
from repro_torch.obs import get_registry, get_tracer

from test_torch_index import K, S, SCORE_ATOL, _sig_corpus

CFG = (32, 2, 8)       # bands, rows per band, code bits
BLOCK = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's plain-version compares would otherwise take every
    core from the timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_obs():
    yield
    get_registry().reset()
    get_tracer().reset(enabled=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    paths, words, sizes, held = _sig_corpus(str(tmp), n=300, seed=21,
                                            n_files=5)
    build_index(paths, str(tmp / "one.idx"), BandingConfig(*CFG),
                device="cpu")
    build_index(paths, str(tmp / "sizes.idx"), BandingConfig(*CFG),
                set_sizes=sizes, s=S, device="cpu")
    return dict(tmp=tmp, paths=paths, words=words, sizes=sizes, held=held)


@pytest.fixture(scope="module")
def sentinel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream_sentinel")
    paths, words, _, held = _sig_corpus(str(tmp), densify="sentinel", n=260,
                                        seed=22, n_files=3)
    cfg = choose_band_config(K, 8, code_bits=9, threshold=0.5)
    build_index(paths, str(tmp / "s.idx"), cfg, device="cpu")
    return dict(path=str(tmp / "s.idx"), words=words, held=held)


def _q(c):
    n = c["words"].shape[0]
    return np.concatenate([c["words"][[0, 5, n // 2, n - 1]], c["held"]])


# ---------------------------------------------------------------------------
# StreamPlan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 7, 64, 128])
def test_stream_plan_equals_reference(corpus, block):
    path = str(corpus["tmp"] / "one.idx")
    index, j_index = load_index(path, device="cpu"), j_load_index(path)
    row_bytes = 4 * index.meta.words
    payload = index.meta.payload_bytes
    budgets = [1, row_bytes, 2 * row_bytes, 3 * row_bytes, 5 * row_bytes,
               17 * row_bytes + 5, 64 * row_bytes, 200 * row_bytes,
               payload // 3, payload // 2, payload - 1]
    for budget in budgets:
        for prefetch in (0, 1, 2, 3, 5):
            got = IndexSearcher(index, device="cpu", corpus_block=block,
                                max_device_bytes=budget,
                                stream_prefetch=prefetch).stream_plan()
            want = JSearcher(j_index, backend="ref", corpus_block=block,
                             max_device_bytes=budget,
                             stream_prefetch=prefetch)._stream_plan()
            key = (budget, prefetch)
            assert (got.window, got.block, got.prefetch, got.row_bytes) == \
                (want.window, want.block, want.prefetch,
                 want.row_bytes), key
            assert (got.inflight, got.resident_bytes) == \
                (want.inflight, want.resident_bytes), key
            if block > 1 and budget >= 2 * row_bytes:
                # the reference's guarantee: within budget once it admits
                # one row per window (a 1-row block has nothing to shrink)
                assert got.resident_bytes <= budget, key


def test_stream_plan_shrinks_prefetch_then_block(corpus):
    index = load_index(str(corpus["tmp"] / "one.idx"), device="cpu")
    row_bytes = 4 * index.meta.words
    # 3 blocks of rows at depth 2 (4 in flight) -> depth shrinks to 1
    p = IndexSearcher(index, device="cpu", corpus_block=BLOCK,
                      max_device_bytes=3 * BLOCK * row_bytes).stream_plan()
    assert p.prefetch == 1 and p.block == BLOCK and p.window == BLOCK
    # under one block even at depth 0 -> the block shrinks
    p = IndexSearcher(index, device="cpu", corpus_block=BLOCK,
                      max_device_bytes=40 * row_bytes).stream_plan()
    assert p.prefetch == 0 and p.block == 20 and p.window == 20


# ---------------------------------------------------------------------------
# The streamed exact scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [2, 3, 7, 40])
def test_streamed_exact_bit_identical(corpus, frac):
    path = str(corpus["tmp"] / "one.idx")
    index = load_index(path, device="cpu")
    budget = index.meta.payload_bytes // frac
    q = _q(corpus)
    incore = IndexSearcher(index, device="cpu", corpus_block=BLOCK)
    streamed = IndexSearcher(index, device="cpu", corpus_block=BLOCK,
                             max_device_bytes=budget)
    j_streamed = JSearcher(j_load_index(path), backend="ref",
                           corpus_block=BLOCK, max_device_bytes=budget)
    assert streamed.streamed and not incore.streamed and j_streamed.streamed
    want = incore.search(q, 10, mode="exact")
    got = streamed.search(q, 10, mode="exact")
    ref = j_streamed.search(jnp.asarray(q), 10, mode="exact")
    for r in (got, ref):
        np.testing.assert_array_equal(r.indices, want.indices)
        np.testing.assert_array_equal(r.scores, want.scores)
    plan, stats = streamed.stream_plan(), streamed.last_window_stats
    assert stats.windows == -(-index.n // plan.window)
    assert stats.bytes == index.meta.payload_bytes
    assert 1 <= stats.high_water <= plan.inflight and stats.alive == 0
    # LSH on a streamed searcher gathers candidate rows off the mmap
    np.testing.assert_array_equal(
        streamed.search(q, 10, mode="lsh").indices,
        incore.search(q, 10, mode="lsh").indices)


def test_streamed_exact_sentinel_wire(sentinel):
    index = load_index(sentinel["path"], device="cpu")
    q = _q(sentinel)
    budget = index.meta.payload_bytes // 5
    want = IndexSearcher(index, device="cpu", corpus_block=BLOCK).search(
        q, 7, mode="exact")
    got = IndexSearcher(index, device="cpu", corpus_block=BLOCK,
                        max_device_bytes=budget).search(q, 7, mode="exact")
    ref = JSearcher(j_load_index(sentinel["path"]), backend="ref",
                    corpus_block=BLOCK, max_device_bytes=budget).search(
                        jnp.asarray(q), 7, mode="exact")
    for r in (got, ref):
        np.testing.assert_array_equal(r.indices, want.indices)
        np.testing.assert_array_equal(r.scores, want.scores)


def test_streamed_exact_with_set_sizes(corpus):
    path = str(corpus["tmp"] / "sizes.idx")
    index = load_index(path, device="cpu")
    q, qs = corpus["words"][:6], corpus["sizes"][:6]
    budget = index.meta.payload_bytes // 4
    want = IndexSearcher(index, device="cpu", corpus_block=BLOCK).search(
        q, 5, mode="exact", query_sizes=qs)
    got = IndexSearcher(index, device="cpu", corpus_block=BLOCK,
                        max_device_bytes=budget).search(
                            q, 5, mode="exact", query_sizes=qs)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
    ref = JSearcher(j_load_index(path), backend="ref", corpus_block=BLOCK,
                    max_device_bytes=budget).search(
                        jnp.asarray(q), 5, mode="exact", query_sizes=qs)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=0,
                               atol=SCORE_ATOL)


def test_searcher_argument_checks(corpus):
    index = load_index(str(corpus["tmp"] / "one.idx"), device="cpu")
    for kw in (dict(max_device_bytes=0), dict(stream_prefetch=-1),
               dict(lsh_batch=0), dict(corpus_block=0)):
        with pytest.raises(ValueError):
            IndexSearcher(index, device="cpu", **kw)


# ---------------------------------------------------------------------------
# LSH sub-batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lsh_batch", [1, 3, 4, 64])
def test_lsh_batch_does_not_change_the_result(corpus, lsh_batch):
    path = str(corpus["tmp"] / "one.idx")
    index = load_index(path, device="cpu")
    q = np.concatenate([_q(corpus), corpus["words"][10:19]])
    want = IndexSearcher(index, device="cpu").search(q, 10, mode="lsh")
    got = IndexSearcher(index, device="cpu", lsh_batch=lsh_batch).search(
        q, 10, mode="lsh")
    ref = JSearcher(j_load_index(path), backend="ref",
                    lsh_batch=lsh_batch).search(jnp.asarray(q), 10,
                                                mode="lsh")
    for r in (got, ref):
        np.testing.assert_array_equal(r.indices, want.indices)
        np.testing.assert_array_equal(r.scores, want.scores)
        np.testing.assert_array_equal(r.n_candidates, want.n_candidates)


def test_lsh_batch_through_the_router(corpus, tmp_path):
    shard_dir = str(tmp_path / "sh")
    build_sharded(corpus["paths"], shard_dir, BandingConfig(*CFG),
                  n_shards=3, device="cpu")
    q = _q(corpus)
    want = load_sharded(shard_dir, device="cpu").search(q, 10, mode="lsh")
    got = load_sharded(shard_dir, device="cpu", lsh_batch=2).search(
        q, 10, mode="lsh")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)


# ---------------------------------------------------------------------------
# device_put_iter on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1, 2, 4])
def test_device_put_iter_order_contents_and_high_water(prefetch):
    rng = np.random.default_rng(prefetch)
    items = [(i, rng.integers(0, 2**32, (5 + i, 3), dtype=np.uint32))
             for i in range(9)]
    stats = WindowStats()
    seen = []
    for key, win in device_put_iter(lambda: iter(items), prefetch,
                                    device="cpu", stats=stats):
        assert win.dtype == torch.int32
        seen.append((key, win.numpy().view(np.uint32).copy()))
        del win
    assert [k for k, _ in seen] == list(range(9))
    for (_, got), (_, want) in zip(seen, items):
        np.testing.assert_array_equal(got, want)
    assert stats.windows == 9 and stats.alive == 0
    assert stats.bytes == sum(a.nbytes for _, a in items)
    assert 1 <= stats.high_water <= prefetch + 2


def test_device_put_iter_propagates_producer_errors():
    def bad():
        yield 0, np.zeros((2, 2), np.uint32)
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        for _ in device_put_iter(bad, 2, device="cpu"):
            pass


# ---------------------------------------------------------------------------
# Live growth: append, spill, refresh
# ---------------------------------------------------------------------------

def test_merge_band_tables_equals_reference(corpus):
    rng = np.random.default_rng(5)
    old = rng.integers(0, 40, (90, 6)).astype(np.uint32)
    new = rng.integers(0, 40, (30, 6)).astype(np.uint32)
    got = merge_band_tables(build_band_tables(old), build_band_tables(new),
                            90)
    want = j_merge_band_tables(j_build_band_tables(old),
                               j_build_band_tables(new), 90)
    scratch = build_band_tables(np.concatenate([old, new]))
    for g, w, s in zip(got, want, scratch):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, s)
    with pytest.raises(ValueError, match="band count"):
        merge_band_tables(build_band_tables(old),
                          build_band_tables(new[:, :5]), 90)


@pytest.mark.parametrize("with_sizes", [False, True])
def test_append_index_byte_identical(corpus, tmp_path, with_sizes):
    paths, sizes = corpus["paths"], corpus["sizes"]
    cfg, j_cfg = BandingConfig(*CFG), JBanding(*CFG)
    n0 = _count(paths[:2])
    kw = dict(set_sizes=sizes, s=S) if with_sizes else {}
    kw0 = dict(set_sizes=sizes[:n0], s=S) if with_sizes else {}
    t_path, j_path = str(tmp_path / "t.idx"), str(tmp_path / "j.idx")
    build_index(paths[:2], t_path, cfg, device="cpu", **kw0)
    j_build_index(paths[:2], j_path, j_cfg, **kw0)
    extra = sizes[n0:] if with_sizes else None
    meta = append_index(t_path, paths[2:], set_sizes=extra, device="cpu")
    j_meta = j_append_index(j_path, paths[2:], set_sizes=extra)
    assert meta == load_index(t_path, device="cpu").meta
    assert meta.n == j_meta.n == corpus["words"].shape[0]
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    scratch = str(tmp_path / "scratch.idx")
    build_index(paths, scratch, cfg, device="cpu", **kw)
    with open(t_path, "rb") as a, open(scratch, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(t_path + ".lock")
    if with_sizes:
        with pytest.raises(ValueError, match="set_sizes"):
            append_index(t_path, paths[:1], device="cpu")
    else:
        with pytest.raises(ValueError, match="set sizes"):
            append_index(t_path, paths[:1], set_sizes=sizes[:60],
                         device="cpu")


def _count(paths):
    from repro_torch.data.sigshard import read_sig_meta
    return sum(read_sig_meta(p).n for p in paths)


@pytest.mark.parametrize("budget", [None, 1, 100])
def test_sharded_append_spill_byte_identical(corpus, tmp_path, budget):
    paths = corpus["paths"]
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    build_sharded(paths[:3], t_dir, BandingConfig(*CFG), n_shards=2,
                  device="cpu")
    j_build_sharded(paths[:3], j_dir, JBanding(*CFG), n_shards=2)
    router = load_sharded(t_dir, device="cpu", corpus_block=BLOCK,
                          max_shard_docs=budget)
    j_router = j_load_sharded(j_dir, backend="ref", corpus_block=BLOCK,
                              max_shard_docs=budget)
    touched = router.append(paths[3:])
    j_touched = j_router.append(paths[3:])
    assert [os.path.basename(p) for p, _ in touched] == \
        [os.path.basename(p) for p, _ in j_touched]
    assert router.generation == j_router.generation == 1
    assert router.n_shards == j_router.n_shards
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
    for name in os.listdir(t_dir):
        with open(os.path.join(t_dir, name), "rb") as a, \
                open(os.path.join(j_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    # global ids: the grown router equals one index over all the files
    single = IndexSearcher(load_index(str(corpus["tmp"] / "one.idx"),
                                      device="cpu"), device="cpu")
    q = _q(corpus)
    for mode in ("exact", "lsh"):
        got, want = router.search(q, 10, mode=mode), single.search(
            q, 10, mode=mode)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)


def test_refresh_picks_up_another_routers_append(corpus, tmp_path):
    paths = corpus["paths"]
    shard_dir = str(tmp_path / "grow")
    build_sharded(paths[:3], shard_dir, BandingConfig(*CFG), n_shards=2,
                  device="cpu")
    reader = load_sharded(shard_dir, device="cpu", corpus_block=BLOCK)
    writer = load_sharded(shard_dir, device="cpu", corpus_block=BLOCK,
                          max_shard_docs=1)
    j_writer = j_load_sharded(shard_dir, backend="ref", corpus_block=BLOCK)
    writer.append(paths[3:4])                  # a port router appends
    assert reader.n < writer.n and reader.generation == 0
    assert reader.refresh() is True and reader.refresh() is False
    assert (reader.n, reader.generation, reader.n_shards) == \
        (writer.n, 1, 3)
    assert j_writer.refresh() is True          # the reference reads it too
    j_writer.append(paths[4:])                 # ... and appends
    assert reader.refresh() is True and reader.generation == 2
    assert reader.n == corpus["words"].shape[0]
    q = _q(corpus)
    got = reader.search(q, 10, mode="exact")
    want = j_writer.search(jnp.asarray(q), 10, mode="exact")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_search_racing_append_never_torn(corpus, tmp_path):
    paths = corpus["paths"]
    shard_dir = str(tmp_path / "race")
    build_sharded(paths[:3], shard_dir, BandingConfig(*CFG), n_shards=2,
                  device="cpu")
    router = load_sharded(shard_dir, device="cpu", corpus_block=BLOCK)
    q = np.ascontiguousarray(corpus["words"][[0, 3, 9, 17]])
    pre = router.search(q, 5, mode="exact")
    results, errors = [], []
    started = threading.Event()

    def reader():
        try:
            for _ in range(6):
                results.append(router.search(q, 5, mode="exact"))
                started.set()
        except Exception as e:               # pragma: no cover
            errors.append(e)
            started.set()

    t = threading.Thread(target=reader)
    t.start()
    started.wait(timeout=60)
    router.append(paths[3:])
    t.join(timeout=120)
    assert not t.is_alive() and not errors
    post = router.search(q, 5, mode="exact")
    for res in results:
        assert (np.array_equal(res.indices, pre.indices)
                and np.array_equal(res.scores, pre.scores)) or \
            (np.array_equal(res.indices, post.indices)
             and np.array_equal(res.scores, post.scores))


def test_append_needs_a_loaded_router_and_mesh_is_not_ported(corpus):
    index = load_index(str(corpus["tmp"] / "one.idx"), device="cpu")
    plain = ShardedIndex([index], device="cpu")
    with pytest.raises(ValueError, match="load_sharded"):
        plain.append(corpus["paths"][:1])
    assert plain.refresh() is False
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedIndex([index], device="cpu", dispatch="mesh")
    with pytest.raises(ValueError, match="needs a mesh"):
        plain.search(corpus["words"][:1], 3, dispatch="mesh")
    with pytest.raises(ValueError, match="max_shard_docs"):
        ShardedIndex([index], device="cpu", max_shard_docs=0)
