"""Port parity for ``repro_torch.index.resilience``:

  * breaker transitions under an injected clock, the breaker gauge and
    the error each dispatch raises: equal to the reference's, step by
    step;
  * chaos draws under a seed (``fault_log``, what each fault does) and
    the seeded retry backoff: equal to the reference's;
  * deadlines and hedging, driven by events instead of wall-clock
    asserts;
  * ``on_shard_failure="partial"``: a dead shard's survivors equal a
    healthy router restricted to them, with their coverage; every shard
    dead raises; a server over a chaotic router serves every request.
"""

import threading

import numpy as np
import pytest
import torch

from repro.index import resilience as jres
from repro.obs import metrics as jm
from repro.obs import trace as jt
from repro_torch.index import (BandingConfig, IndexSearcher, ShardedIndex,
                               build_sharded, load_index, load_sharded)
from repro_torch.index import resilience as tres
from repro_torch.index.router import LocalShardClient
from repro_torch.launch.server import SearchServer
from repro_torch.obs import get_registry, get_tracer
from repro_torch.obs import metrics as tm
from repro_torch.obs import trace as tt

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


PACKAGES = {"port": (tres, tm, tt), "reference": (jres, jm, jt)}


class FakeClient:
    """Package-agnostic ``ShardClient``: each call follows ``plan``
    (``"err"`` raises at dispatch, ``"drop"`` at harvest, ``"block"``
    waits on ``gate`` in its harvest, else it returns ``("ok", call)``)."""

    def __init__(self, plan=(), gate=None):
        self.plan = list(plan)
        self.calls = 0
        self.gate = gate
        self._lock = threading.Lock()

    @property
    def n(self):
        return 7

    def dispatch(self, qwords, topk, *, mode="exact", query_sizes=None,
                 qkeys=None):
        with self._lock:
            i = self.calls
            self.calls += 1
        step = self.plan[i] if i < len(self.plan) else None
        if step == "err":
            raise OSError(f"scripted dispatch failure {i}")

        def harvest():
            if step == "drop":
                raise ConnectionResetError(f"scripted drop {i}")
            if step == "block":
                self.gate.wait(30.0)
            return ("ok", i)
        return harvest


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_story(pkg):
    res, metrics, trace = PACKAGES[pkg]
    reg, tr, clock = metrics.MetricsRegistry(), trace.Tracer(enabled=True), \
        FakeClock()
    inner = FakeClient(["err", "drop", "err", 0, "drop", "drop", "err"])
    client = res.ResilientShardClient(
        inner, res.ResiliencePolicy(max_retries=0, breaker_failures=2,
                                    breaker_reset_s=1.0),
        registry=reg, tracer=tr, clock=clock, sleep=lambda s: None)
    story = []
    for advance in (0, 0, 0, 0.5, 0.6, 0, 1.5, 0, 0, 0, 2.0, 0, 0):
        clock.t += advance
        try:
            out = repr(client.dispatch(None, 5)())
        except Exception as e:
            out = type(e).__name__
        story.append((out, client.breaker.state,
                      reg.values()['shard_breaker_state{shard="0"}'],
                      inner.calls))
    trans = [(e["args"]["from"], e["args"]["to"]) for e in tr.events()
             if e["name"] == "breaker"]
    return story, trans


def test_breaker_transitions_equal_reference():
    got, want = _breaker_story("port"), _breaker_story("reference")
    assert got == want
    story, trans = got
    assert ("closed", "open") in trans and ("half_open", "closed") in trans
    assert any(out == "CircuitOpenError" for out, *_ in story)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_chaos_draws_equal_reference(seed):
    def run(pkg):
        res = PACKAGES[pkg][0]
        sleeps = []
        chaos = res.ChaosShardClient(
            FakeClient(), res.ChaosSchedule(seed=seed, fault_rate=0.4),
            sleep=sleeps.append)
        outcomes = []
        for _ in range(40):
            try:
                outcomes.append(repr(chaos.dispatch(None, 3)()))
            except Exception as e:
                outcomes.append(type(e).__name__)
        return chaos.fault_log, outcomes, sleeps
    got, want = run("port"), run("reference")
    assert got == want
    kinds = {k for _, k in got[0]}
    assert None in kinds and len(kinds) > 2


@pytest.mark.parametrize("seed", [1, 5])
def test_seeded_retry_backoff_equals_reference(seed):
    def run(pkg):
        res, metrics, _ = PACKAGES[pkg]
        sleeps = []
        fac = res.resilient_client_factory(
            res.ResiliencePolicy(max_retries=3, backoff_base_s=0.001,
                                 backoff_cap_s=0.05),
            inner_factory=lambda s: FakeClient(["err", "drop", "err"]),
            registry=metrics.MetricsRegistry(), sleep=sleeps.append,
            seed=seed)
        clients = [fac(None), fac(None)]
        return [repr(c.dispatch(None, 5)()) for c in clients], sleeps
    got, want = run("port"), run("reference")
    assert got == want
    assert len(got[1]) == 6 and all(0.001 <= s <= 0.05 for s in got[1])


def test_deadline_abandons_a_hung_attempt():
    gate = threading.Event()
    reg = tm.MetricsRegistry()
    client = tres.ResilientShardClient(
        FakeClient(["block", "block"], gate=gate),
        tres.ResiliencePolicy(deadline_s=0.05, max_retries=1,
                              backoff_base_s=0.0, backoff_cap_s=0.0),
        registry=reg)
    try:
        with pytest.raises(tres.ShardDispatchTimeout):
            client.dispatch(None, 5)()
    finally:
        gate.set()
    v = reg.values()
    assert v['shard_dispatch_timeouts_total{shard="0"}'] == 2.0
    assert v['shard_dispatch_retries_total{shard="0"}'] == 1.0


def test_hedge_wins_against_a_blocked_primary():
    gate = threading.Event()
    reg, tr = tm.MetricsRegistry(), tt.Tracer(enabled=True)
    inner = FakeClient(["block", None], gate=gate)
    client = tres.ResilientShardClient(
        inner, tres.ResiliencePolicy(hedge=True, hedge_min_s=0.01,
                                     hedge_max_s=0.01),
        registry=reg, tracer=tr)
    try:
        assert client.dispatch(None, 5)() == ("ok", 1)   # the hedge's
    finally:
        gate.set()
    assert reg.values()['shard_hedges_total{outcome="win",shard="0"}'] \
        == 1.0
    spans = [e for e in tr.events() if e["name"] == "hedge"]
    assert len(spans) == 1 and spans[0]["args"]["outcome"] == "win"


# ---------------------------------------------------------------------------
# Partial results over real shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resilience")
    paths, words, _, _ = _sig_corpus(str(tmp), n=240, seed=51, n_files=4)
    build_sharded(paths, str(tmp / "sh"), BandingConfig(*CFG), n_shards=3,
                  device="cpu")
    return str(tmp / "sh"), words


def _dead_router(shard_dir, dead, **kw):
    fac = tres.resilient_client_factory(
        tres.ResiliencePolicy(max_retries=0, backoff_base_s=0.0),
        chaos=lambda i: (tres.ChaosSchedule(seed=7, fault_rate=1.0,
                                            faults=("oserror",))
                         if i in dead else None))
    return load_sharded(shard_dir, device="cpu", corpus_block=64,
                        client_factory=fac, **kw)


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_partial_serves_survivors_bit_identically(shard_dir, mode):
    sdir, words = shard_dir
    router = _dead_router(sdir, {1}, on_shard_failure="partial")
    healthy = load_sharded(sdir, device="cpu", corpus_block=64)
    q = words[[0, 50, 100, 239]]
    got = router.search(q, 10, mode=mode)
    keep = [0, 2]
    survivors = ShardedIndex([healthy.searchers[i].index for i in keep],
                             device="cpu", corpus_block=64)
    want = survivors.search(q, 10, mode=mode)
    offs = healthy.offsets
    # survivors keep their global ids: map the restricted router's ids
    gid = np.concatenate([np.arange(s.index.n) + offs[i]
                          for i, s in zip(keep, survivors.searchers)])
    want_ids = np.where(want.indices >= 0, gid[want.indices], -1)
    np.testing.assert_array_equal(got.indices, want_ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.failed_shards == (1,)
    assert got.coverage == pytest.approx(
        1 - healthy.searchers[1].index.n / healthy.n)
    vals = get_registry().values()
    assert vals["index_partial_searches_total"] >= 1.0
    assert vals['index_shard_failures_total{shard="1"}'] >= 1.0


def test_partial_not_requested_fails_and_all_dead_raises(shard_dir):
    sdir, words = shard_dir
    with pytest.raises(OSError, match="chaos"):
        _dead_router(sdir, {0}).search(words[:2], 5)
    with pytest.raises(RuntimeError, match="all 3 shards failed"):
        _dead_router(sdir, {0, 1, 2}, on_shard_failure="partial").search(
            words[:2], 5)
    with pytest.raises(ValueError, match="on_shard_failure"):
        load_sharded(sdir, device="cpu", on_shard_failure="maybe")


def test_server_over_a_chaotic_router_serves_every_request(shard_dir):
    sdir, words = shard_dir
    fac = tres.resilient_client_factory(
        tres.ResiliencePolicy(max_retries=3, backoff_base_s=0.0,
                              backoff_cap_s=0.0),
        chaos=tres.ChaosSchedule(seed=3, fault_rate=0.3,
                                 faults=("oserror", "drop", "latency"),
                                 latency_s=0.001),
        sleep=lambda s: None, seed=11)
    router = load_sharded(sdir, device="cpu", corpus_block=64,
                          client_factory=fac)
    healthy = load_sharded(sdir, device="cpu", corpus_block=64)
    rows = [words[i] for i in range(0, 240, 20)]
    want = healthy.search(np.stack(rows), 5)
    with SearchServer(router, max_batch=4, max_delay_s=30.0, topk=5,
                      on_shard_failure="partial") as srv:
        handles = [srv.submit(r) for r in rows]
        results = [h.result(timeout=60.0) for h in handles]
    assert sum(len(c.fault_log) for c in fac.chaos_clients) > 0
    for j, (h, res) in enumerate(zip(handles, results)):
        if h.outcome == "served":
            np.testing.assert_array_equal(res.indices[0], want.indices[j])
            np.testing.assert_array_equal(res.scores[0], want.scores[j])
        else:
            assert h.outcome == "partial" and res.coverage < 1.0
    assert srv.stats.requests == len(rows) and srv.stats.errors == 0


def test_local_client_passes_through(shard_dir):
    sdir, words = shard_dir
    s = IndexSearcher(load_index(sdir + "/shard_00000.idx", device="cpu"),
                      device="cpu")
    client = tres.ResilientShardClient(LocalShardClient(s),
                                       registry=tm.MetricsRegistry())
    assert client.n == s.index.n
    got = client.dispatch(words[:3], 5)()
    want = s.search(words[:3], 5)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
