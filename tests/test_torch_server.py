"""Port parity for the continuous-batching ``SearchServer`` and its
launcher:

  * served results equal the reference's ``search()`` on the same rows,
    for 1 and 3 dispatch workers, exact and LSH, over a sharded router
    and over a streamed single index (flushes triggered by full batches
    and the drain on stop, never by the clock);
  * the admission policies' shed / degraded accounting equals the
    reference server's in deterministic scenarios (a gated searcher holds
    the first flush while the queue fills);
  * a worker whose flush crashes is restarted and the server keeps
    serving; a malformed row fails only itself;
  * a served router picks up a live append (with a spill) through the
    per-flush refresh;
  * ``ZipfianTraffic`` ids and arrivals equal the reference's;
  * the kernel wrappers' launch counters lose no increment under many
    threads;
  * ``python -m repro_torch.launch.serve --index --serve --device cpu``
    runs, and the new entry points refuse to run without CUDA unless
    asked for the CPU.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import load_sharded as j_load_sharded
from repro.launch import server as jsrv
from repro_torch.index import (BandingConfig, IndexSearcher, append_index,
                               build_index, build_sharded, load_index,
                               load_sharded)
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.hamming import packed_match_cuda
from repro_torch.launch import serve
from repro_torch.launch import server as tsrv
from repro_torch.obs import get_registry, get_tracer

from test_torch_index import _sig_corpus

CFG = (32, 2, 8)


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
    tmp = tmp_path_factory.mktemp("server")
    paths, words, _, held = _sig_corpus(str(tmp), n=280, seed=61,
                                        n_files=5)
    build_sharded(paths, str(tmp / "sh"), BandingConfig(*CFG), n_shards=3,
                  device="cpu")
    build_index(paths, str(tmp / "one.idx"), BandingConfig(*CFG),
                device="cpu")
    rng = np.random.default_rng(6)
    rows = np.concatenate([words[rng.integers(0, 280, 14)], held])
    return dict(tmp=tmp, paths=paths, words=words, rows=rows)


def _serve_rows(server, rows):
    """Full batches flush as they fill; the rest on the drain at stop."""
    with server as srv:
        handles = [srv.submit(r) for r in rows]
    return srv, handles, [h.result(timeout=60.0) for h in handles]


# ---------------------------------------------------------------------------
# Served results against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "lsh"])
@pytest.mark.parametrize("workers", [1, 3])
def test_server_equals_reference_search(corpus, mode, workers):
    shard_dir = str(corpus["tmp"] / "sh")
    rows = corpus["rows"]
    router = load_sharded(shard_dir, device="cpu", corpus_block=64)
    want = j_load_sharded(shard_dir, backend="ref", corpus_block=64).search(
        jnp.asarray(rows), 5, mode=mode)
    srv, handles, results = _serve_rows(
        tsrv.SearchServer(router, max_batch=4, max_delay_s=30.0, topk=5,
                          mode=mode, num_workers=workers), rows)
    for j, res in enumerate(results):
        np.testing.assert_array_equal(res.indices[0], want.indices[j])
        np.testing.assert_array_equal(res.scores[0], want.scores[j])
    snap = srv.stats.snapshot()
    assert snap["workers"] == workers and snap["requests"] == len(rows)
    assert snap["errors"] == 0 and sum(snap["worker_flushes"]) == \
        snap["batches"]
    assert snap["flush_aged"] == snap["flush_deadline"] == 0
    assert all(h.outcome == "served" for h in handles)


def test_server_over_a_streamed_index(corpus):
    index = load_index(str(corpus["tmp"] / "one.idx"), device="cpu")
    searcher = IndexSearcher(index, device="cpu", corpus_block=64,
                             max_device_bytes=index.meta.payload_bytes // 5)
    rows = corpus["rows"]
    want = IndexSearcher(index, device="cpu").search(rows, 5)
    _, _, results = _serve_rows(
        tsrv.SearchServer(searcher, max_batch=8, max_delay_s=30.0, topk=5,
                          num_workers=2), rows)
    for j, res in enumerate(results):
        np.testing.assert_array_equal(res.indices[0], want.indices[j])
        np.testing.assert_array_equal(res.scores[0], want.scores[j])
    assert searcher.last_window_stats.high_water <= \
        searcher.stream_plan().inflight


# ---------------------------------------------------------------------------
# Admission policies, deterministically
# ---------------------------------------------------------------------------

class _Gated:
    """Holds every flush until ``gate`` opens; ``entered`` tells the test
    the first flush has started (the queue then only grows)."""

    def __init__(self, inner):
        self.inner = inner
        self.gate = threading.Event()
        self.entered = threading.Event()

    @property
    def spec(self):
        return self.inner.spec

    @property
    def device(self):
        return self.inner.device

    def search(self, queries, topk=10, *, mode="exact", query_sizes=None):
        self.entered.set()
        assert self.gate.wait(60.0)
        return self.inner.search(queries, topk, mode=mode,
                                 query_sizes=query_sizes)


def _admission_story(server_mod, searcher, rows, **kw):
    gated = _Gated(searcher)
    srv = server_mod.SearchServer(gated, max_batch=4, max_delay_s=0.0,
                                  topk=3, **kw).start()
    try:
        handles = [srv.submit(rows[0])]
        assert gated.entered.wait(60.0)
        handles += [srv.submit(r) for r in rows[1:]]
        early = [h.outcome for h in handles]
        gated.gate.set()
        for h in handles:
            if h.outcome != "shed":
                h.result(timeout=60.0)
    finally:
        gated.gate.set()
        srv.stop()
    st = srv.stats
    return (early, [h.outcome for h in handles],
            (st.requests, st.shed, st.degraded, st.errors)), handles


@pytest.mark.parametrize("policy,kw", [
    ("reject", dict(max_queue=3)),
    ("shed-oldest", dict(max_queue=3)),
    ("degrade-to-lsh", dict(deadline_budget_s=1e-9)),
    ("none", dict(max_queue=3))])
def test_admission_accounting_equals_reference(corpus, policy, kw):
    shard_dir = str(corpus["tmp"] / "sh")
    rows = corpus["rows"][:9]
    got, handles = _admission_story(
        tsrv, load_sharded(shard_dir, device="cpu", corpus_block=64), rows,
        admission=policy, **kw)
    want, _ = _admission_story(
        jsrv, j_load_sharded(shard_dir, backend="ref", corpus_block=64),
        rows, admission=policy, **kw)
    assert got == want
    outcomes = got[1]
    if policy == "reject":
        assert outcomes.count("shed") == 5 and outcomes[-1] == "shed"
    elif policy == "shed-oldest":
        assert outcomes[1:5] == ["shed"] * 4 and outcomes[-1] == "served"
    elif policy == "degrade-to-lsh":
        assert set(outcomes) == {"degraded"}
        want_lsh = load_sharded(shard_dir, device="cpu").search(
            rows, 3, mode="lsh")
        for j, h in enumerate(handles):
            np.testing.assert_array_equal(h.result(0).indices[0],
                                          want_lsh.indices[j])
    else:
        assert set(outcomes) == {"served"}
    shed = [h for h in handles if h.outcome == "shed"]
    if shed:
        with pytest.raises(tsrv.RequestShed):
            shed[0].result(timeout=0)


def test_admission_validation(corpus):
    router = load_sharded(str(corpus["tmp"] / "sh"), device="cpu")
    for kw, match in ((dict(admission="drop-everything"), "admission"),
                      (dict(admission="degrade-to-lsh", mode="lsh"),
                       "degrade-to-lsh"),
                      (dict(max_queue=0), "max_queue"),
                      (dict(num_workers=0), "num_workers"),
                      (dict(max_batch=0), "max_batch"),
                      (dict(on_shard_failure="maybe"), "on_shard_failure")):
        with pytest.raises(ValueError, match=match):
            tsrv.SearchServer(router, **kw)
    assert tsrv.SearchServer(router).num_workers == 1
    with pytest.raises(RuntimeError, match="not started"):
        tsrv.SearchServer(router).submit(corpus["rows"][0])


# ---------------------------------------------------------------------------
# Crashes, bad rows, drain, live append
# ---------------------------------------------------------------------------

def test_worker_crash_restarts_the_worker(corpus):
    router = load_sharded(str(corpus["tmp"] / "sh"), device="cpu",
                          corpus_block=64)
    rows = [corpus["words"][i] for i in range(16)]
    srv = tsrv.SearchServer(router, max_batch=4, max_delay_s=30.0, topk=3,
                            num_workers=2)
    real = srv._flush_batch
    crashes = [2]
    lock = threading.Lock()

    def flaky(batch, trigger, wi, handle):
        with lock:
            crash = crashes[0] > 0
            crashes[0] -= crash
        if crash:
            raise RuntimeError("injected flush crash")
        return real(batch, trigger, wi, handle)

    srv._flush_batch = flaky
    with srv:
        handles = [srv.submit(r) for r in rows]
        outcomes = []
        for h in handles:
            try:
                assert h.result(timeout=60.0).indices.shape == (1, 3)
                outcomes.append("served")
            except RuntimeError as e:
                assert "injected flush crash" in str(e)
                outcomes.append("error")
    snap = srv.stats.snapshot()
    assert snap["worker_restarts"] == 2 and crashes[0] == 0
    assert outcomes.count("error") == 8 and outcomes.count("served") == 8
    assert snap["requests"] == 8 and srv.stats.errors == 2
    assert get_registry().values()["serve_worker_restarts_total"] == 2.0


def test_bad_row_fails_only_itself_and_drain_on_stop(corpus):
    router = load_sharded(str(corpus["tmp"] / "sh"), device="cpu")
    good = corpus["words"][5]
    want = router.search(good[None, :], 3)
    srv = tsrv.SearchServer(router, max_batch=64, max_delay_s=30.0,
                            topk=3).start()
    h_bad = srv.submit(np.zeros(3, np.uint32))
    h_good = srv.submit(good)
    srv.stop()                                   # drains both
    assert h_good.done() and h_bad.done()
    np.testing.assert_array_equal(h_good.result(0).indices, want.indices)
    with pytest.raises(ValueError):
        h_bad.result(0)
    assert srv.stats.flush_drain == 1 and srv.stats.errors == 1
    with pytest.raises(RuntimeError):
        srv.submit(good)


def test_served_router_picks_up_a_spilling_append(corpus, tmp_path):
    paths = corpus["paths"]
    shard_dir = str(tmp_path / "grow")
    build_sharded(paths[:3], shard_dir, BandingConfig(*CFG), n_shards=2,
                  device="cpu")
    router = load_sharded(shard_dir, device="cpu", corpus_block=64)
    writer = load_sharded(shard_dir, device="cpu", max_shard_docs=1)
    q = corpus["words"][[1, 6, 250, 279]]
    single = IndexSearcher(load_index(str(corpus["tmp"] / "one.idx"),
                                      device="cpu"), device="cpu")
    with tsrv.SearchServer(router, max_batch=len(q), max_delay_s=30.0,
                           topk=5) as srv:
        pre = [srv.submit(r) for r in q]
        pre = [h.result(timeout=60.0) for h in pre]
        writer.append(paths[3:])            # another router appends
        assert srv.generation == 0
        post = [srv.submit(r) for r in q]
        post = [h.result(timeout=60.0) for h in post]
    assert srv.generation == 1 and router.n_shards == 4
    assert srv.stats.refreshes == 1
    want = single.search(q, 5)
    for j, res in enumerate(post):
        np.testing.assert_array_equal(res.indices[0], want.indices[j])
        np.testing.assert_array_equal(res.scores[0], want.scores[j])
    assert pre[2].indices[0, 0] == -1 or pre[2].indices[0, 0] < 250


# ---------------------------------------------------------------------------
# Traffic model, counters, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha,seed", [(500, 1.2, 7), (677_399, 1.1, 1),
                                          (1, 0.8, 3)])
def test_zipfian_traffic_equals_reference(n, alpha, seed):
    a = tsrv.ZipfianTraffic(n, alpha=alpha, seed=seed)
    b = jsrv.ZipfianTraffic(n, alpha=alpha, seed=seed)
    for m in (1, 64, 300):
        np.testing.assert_array_equal(a.ids(m), b.ids(m))
        np.testing.assert_array_equal(a.arrival_offsets(m, 4000.0),
                                      b.arrival_offsets(m, 4000.0))
    with pytest.raises(ValueError):
        a.arrival_offsets(5, rate_qps=0.0)
    with pytest.raises(ValueError):
        tsrv.ZipfianTraffic(0)


def test_launch_counter_loses_no_increment():
    """More threads than cores, a short switch interval: every increment
    lands (a bare ``+= 1`` on the attribute can lose them)."""
    before = packed_match_cuda.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [kbuild.count_launch(packed_match_cuda)
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert packed_match_cuda.launches - before == 16 * 2000
    packed_match_cuda.launches = before


def test_serve_cli_serves_on_cpu(capsys, tmp_path):
    trace = tmp_path / "trace.json"
    serve.main(["--index", "--serve", "--device", "cpu", "--docs", "256",
                "--requests", "4", "--queries", "8", "--rate", "5000",
                "--mode", "exact", "--shards", "2", "--workers", "2",
                "--device-window", "4096", "--metrics-port", "0",
                "--trace-out", str(trace)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("indexed 204 docs into 2 shards")
    assert "streamed (window 4,096 B)" in out[0]
    assert out[1].startswith("metrics: http://127.0.0.1:")
    assert any(line.startswith("served 32 requests in ") for line in out)
    assert any(line.startswith("latency p50=") for line in out)
    assert any("worker occupancy [" in line for line in out)
    assert trace.exists()
    args = serve.build_parser().parse_args(
        ["--index", "--serve", "--admission", "shed-oldest",
         "--max-queue", "64", "--deadline-budget-ms", "20",
         "--on-shard-failure", "partial", "--zipf-alpha", "1.3"])
    assert (args.admission, args.max_queue, args.deadline_budget_ms,
            args.on_shard_failure, args.zipf_alpha) == \
        ("shed-oldest", 64, 20.0, "partial", 1.3)
    assert serve.build_parser().parse_args([]).workers is None
    assert serve.build_parser().parse_args(["--mesh", "4"]).mesh == 4
    with pytest.raises(SystemExit):          # a mesh needs --shards S > 1
        serve.main(["--index", "--mesh", "2", "--device", "cpu"])


def test_new_entry_points_need_cuda_unless_cpu(corpus, monkeypatch):
    from repro_torch.data.pipeline import device_put_iter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = load_index(str(corpus["tmp"] / "one.idx"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexSearcher(index, max_device_bytes=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(device_put_iter(lambda: iter([]), 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        append_index(str(corpus["tmp"] / "one.idx"), corpus["paths"][:1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_sharded(str(corpus["tmp"] / "sh"), max_shard_docs=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--index", "--serve", "--docs", "256"])
