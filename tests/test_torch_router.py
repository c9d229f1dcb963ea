"""Port parity for the sharded router and the serving launcher:

  * ``merge_topk``: the reference's tie cases (lowest global id first
    across shard boundaries, padding, empty shards, topk past the corpus)
    and a property test against ``lax.top_k`` over random partitions;
  * ``build_sharded``: ``.idx`` shards and ``manifest.json`` byte-identical
    to the JAX package's;
  * the sequential ``ShardedIndex``: exact and LSH ids and scores
    bit-identical to a single index and to the JAX router, the Theorem-1
    rerank included, through ``search`` and ``submit`` / ``flush``;
  * ``python -m repro_torch.launch.serve --index --device cpu`` runs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import BandingConfig as JBanding
from repro.index import IndexSearcher as JSearcher
from repro.index import build_sharded as j_build_sharded
from repro.index import load_index as j_load_index
from repro.index import load_sharded as j_load_sharded
from repro_torch.index import (BandingConfig, IndexSearcher, ShardedIndex,
                               build_index, build_sharded, load_index,
                               load_sharded, merge_topk)
from repro_torch.index.query import SearchResult
from repro_torch.launch import serve

from test_torch_index import S, _sig_corpus

CFG = (32, 2, 8)       # bands, rows per band, code bits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's plain-version compares would otherwise take every
    core from the timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    paths, words, sizes, held = _sig_corpus(str(tmp), n=300, seed=8,
                                            n_files=5)
    build_index(paths, str(tmp / "one.idx"), BandingConfig(*CFG),
                device="cpu")
    return tmp, paths, words, sizes, held


# ---------------------------------------------------------------------------
# merge_topk
# ---------------------------------------------------------------------------

def test_merge_topk_tie_break_and_padding():
    r0 = SearchResult(np.array([[1, 0, -1]]),
                      np.array([[0.5, 0.5, -np.inf]], np.float32))
    r1 = SearchResult(np.array([[0, 2, -1]]),
                      np.array([[0.7, 0.5, -np.inf]], np.float32))
    out = merge_topk([r0, r1], [0, 10], 3)
    np.testing.assert_array_equal(out.indices, [[10, 0, 1]])
    np.testing.assert_array_equal(out.scores,
                                  np.array([[0.7, 0.5, 0.5]], np.float32))
    out = merge_topk([r0], [0], 5)               # fewer docs than topk
    np.testing.assert_array_equal(out.indices, [[0, 1, -1, -1, -1]])
    with pytest.raises(ValueError):
        merge_topk([], [], 3)


def test_merge_topk_all_empty_shards():
    empty = SearchResult(np.full((2, 3), -1),
                         np.full((2, 3), -np.inf, np.float32))
    out = merge_topk([empty, empty, empty], [0, 10, 20], 3)
    np.testing.assert_array_equal(out.indices, np.full((2, 3), -1))
    assert np.all(np.isneginf(out.scores))


def test_merge_topk_topk_exceeds_total_docs():
    r0 = SearchResult(np.array([[1, 0, -1]]),
                      np.array([[0.9, 0.4, -np.inf]], np.float32))
    r1 = SearchResult(np.array([[0, -1, -1]]),
                      np.array([[0.6, -np.inf, -np.inf]], np.float32))
    out = merge_topk([r0, r1], [0, 10], 8)
    np.testing.assert_array_equal(out.indices,
                                  [[1, 10, 0, -1, -1, -1, -1, -1]])
    np.testing.assert_array_equal(
        out.scores[0, :3], np.array([0.9, 0.6, 0.4], np.float32))
    assert np.all(np.isneginf(out.scores[0, 3:]))


def test_merge_topk_tie_run_spans_three_shards():
    tie = np.float32(0.5)
    r0 = SearchResult(np.array([[0, 2]]), np.array([[tie, tie]], np.float32))
    r1 = SearchResult(np.array([[1, 3]]), np.array([[tie, tie]], np.float32))
    r2 = SearchResult(np.array([[0, 4]]), np.array([[tie, tie]], np.float32))
    out = merge_topk([r0, r1, r2], [0, 10, 20], 6)
    np.testing.assert_array_equal(out.indices, [[0, 2, 11, 13, 20, 24]])
    assert np.all(out.scores == tie)


@pytest.mark.parametrize("seed", range(4))
def test_merge_topk_any_partition_matches_lax_topk(seed):
    """Partition tie-heavy scores into 1..8 shards, take each shard's top-k
    with the port's stable sort, merge in a shuffled order: ids and scores
    equal ``lax.top_k`` over the whole corpus."""
    from repro_torch.index.query import topk_desc
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 200))
    topk = int(rng.integers(1, 13))
    scores = (rng.integers(0, 6, (3, n)) / 4.0).astype(np.float32)
    kk = min(topk, n)
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), kk)
    n_shards = int(rng.integers(1, 9))
    cuts = (np.sort(rng.choice(np.arange(1, n), size=n_shards - 1,
                               replace=False)) if n_shards > 1 else [])
    bounds = [0, *np.asarray(cuts, int).tolist(), n]
    results, offsets = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        s_i, i_i = topk_desc(torch.from_numpy(scores[:, lo:hi]),
                             min(topk, hi - lo))
        results.append(SearchResult(i_i.numpy(), s_i.numpy()))
        offsets.append(lo)
    perm = rng.permutation(len(results))
    out = merge_topk([results[p] for p in perm],
                     [offsets[p] for p in perm], topk)
    np.testing.assert_array_equal(out.indices[:, :kk], np.asarray(want_i))
    np.testing.assert_array_equal(out.scores[:, :kk], np.asarray(want_s))
    assert np.all(out.indices[:, kk:] == -1)
    assert np.all(np.isneginf(out.scores[:, kk:]))


# ---------------------------------------------------------------------------
# Sharded build and fan-out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_build_sharded_byte_identical(corpus, tmp_path, n_shards):
    _, paths, _, _, _ = corpus
    j_built = j_build_sharded(paths, str(tmp_path / "j"), JBanding(*CFG),
                              n_shards=n_shards)
    built = build_sharded(paths, str(tmp_path / "t"), BandingConfig(*CFG),
                          n_shards=n_shards, device="cpu")
    assert [m.n for _, m in built] == [m.n for _, m in j_built]
    for name in ["manifest.json"] + [os.path.basename(p) for p, _ in built]:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    with pytest.raises(ValueError):
        build_sharded(paths, str(tmp_path / "x"), BandingConfig(*CFG),
                      n_shards=len(paths) + 1, device="cpu")


@pytest.mark.parametrize("n_shards", [2, 3])
def test_router_bit_identical_to_single_index_and_reference(corpus, tmp_path,
                                                            n_shards):
    tmp, paths, words, _, held = corpus
    single = IndexSearcher(load_index(str(tmp / "one.idx"), device="cpu"),
                           device="cpu", corpus_block=64)
    shard_dir = str(tmp_path / "shards")
    build_sharded(paths, shard_dir, BandingConfig(*CFG), n_shards=n_shards,
                  device="cpu")
    router = load_sharded(shard_dir, device="cpu", corpus_block=64)
    j_router = j_load_sharded(shard_dir, backend="ref", corpus_block=64)
    assert router.n == single.index.n == words.shape[0]
    assert router.n_shards == n_shards
    n = router.n
    q = np.concatenate([words[[0, 7, n // 3, n // 2, n - 2, n - 1]], held])
    for mode in ("exact", "lsh"):
        want = single.search(q, 10, mode=mode)
        got = router.search(q, 10, mode=mode)
        ref = j_router.search(jnp.asarray(q), 10, mode=mode)
        for r in (got, ref):
            np.testing.assert_array_equal(r.indices, want.indices)
            np.testing.assert_array_equal(r.scores, want.scores)
        if mode == "lsh":
            np.testing.assert_array_equal(got.n_candidates,
                                          want.n_candidates)
        tickets = [router.submit(row) for row in q[:3]]
        out = router.flush(10, mode=mode)
        np.testing.assert_array_equal(
            np.concatenate([out[t].indices for t in tickets]),
            want.indices[:3])


def test_router_with_set_sizes_rerank(corpus, tmp_path):
    _, paths, words, sizes, _ = corpus
    cfg = BandingConfig(*CFG)
    build_index(paths, str(tmp_path / "one.idx"), cfg, set_sizes=sizes, s=S,
                device="cpu")
    build_sharded(paths, str(tmp_path / "sh"), cfg, n_shards=3,
                  set_sizes=sizes, s=S, device="cpu")
    single = IndexSearcher(load_index(str(tmp_path / "one.idx"),
                                      device="cpu"), device="cpu",
                           corpus_block=64)
    router = load_sharded(str(tmp_path / "sh"), device="cpu",
                          corpus_block=64)
    j_single = JSearcher(j_load_index(str(tmp_path / "one.idx")),
                         backend="ref", corpus_block=64)
    q, qs = words[:5], sizes[:5]
    for mode in ("exact", "lsh"):
        want = single.search(q, 5, mode=mode, query_sizes=qs)
        got = router.search(q, 5, mode=mode, query_sizes=qs)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)
        ref = j_single.search(jnp.asarray(q), 5, mode=mode, query_sizes=qs)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="query_sizes"):
        router.search(q, 5, mode="exact")


def test_router_rejects_mixed_shards(corpus, tmp_path):
    tmp, paths, _, _, _ = corpus
    build_index(paths[:2], str(tmp_path / "a.idx"), BandingConfig(16, 2, 8),
                device="cpu")
    a = load_index(str(tmp_path / "a.idx"), device="cpu")
    b = load_index(str(tmp / "one.idx"), device="cpu")
    with pytest.raises(ValueError, match="banding"):
        ShardedIndex([a, b], device="cpu")
    with pytest.raises(ValueError):
        ShardedIndex([], device="cpu")
    with pytest.raises(OSError):
        load_sharded(str(tmp_path), device="cpu")     # no manifest.json


@pytest.mark.parametrize("mode,shards", [("exact", 1), ("lsh", 2)])
def test_serve_index_runs_on_cpu(capsys, mode, shards):
    serve.main(["--index", "--device", "cpu", "--docs", "256", "--mode",
                mode, "--shards", str(shards), "--requests", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("indexed 204 docs into ")
    assert f"({mode}): p50=" in out[1] and "self-hit@1=1.00" in out[1]
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])               # --index is required


def test_router_and_serve_need_cuda_unless_cpu(corpus, tmp_path,
                                               monkeypatch):
    _, paths, _, _, _ = corpus
    build_sharded(paths, str(tmp_path / "sh"), BandingConfig(*CFG),
                  n_shards=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_sharded(str(tmp_path / "sh"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--index", "--docs", "256"])      # --device cuda
    assert load_sharded(str(tmp_path / "sh"), device="cpu").n_shards == 2
