"""Port parity for ``repro_torch.obs``, ``repro_torch.roofline`` and the
collectors of the loader and the signature cache:

  * the same sequence of registry operations gives the same Prometheus
    text and the same snapshot in both packages, the validation errors
    included;
  * the same sequence of tracer operations gives the same span trees
    (names, ids, parents, trace ids, kinds, args), timestamps aside;
  * ``device_annotation`` is an opt-in ``torch.profiler`` range that works
    on CPU-only torch;
  * the HTTP exporter (port 0, closed by its context);
  * a served ``ShardedIndex`` exports the same ``serve_*`` / ``index_*``
    families as the reference's (less the jit-retrace counter, which has
    no meaning without jit), and request span trees of the same shape;
  * ``ChunkedLoader`` and ``SignatureCache`` export the reference's
    ``data_loader_*`` and ``sigcache_*`` series, with equal counts;
  * the roofline terms equal the reference's, at the H100's bandwidth.
"""

import collections
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.data.pipeline import ChunkedLoader as JLoader
from repro.index import load_sharded as j_load_sharded
from repro.launch.server import SearchServer as JServer
from repro.obs import metrics as jm
from repro.obs import trace as jt
from repro.roofline import search as jroof
from repro_torch.data.pipeline import ChunkedLoader, make_sharded_dataset
from repro_torch.data.synthetic import DatasetSpec
from repro_torch.index import BandingConfig, build_sharded, load_sharded
from repro_torch.launch.server import SearchServer
from repro_torch.obs import export as te
from repro_torch.obs import metrics as tm
from repro_torch.obs import trace as tt
from repro_torch.roofline import hardware, search as troof

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
    tm.get_registry().reset()
    tt.get_tracer().reset(enabled=False)


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

class _Holder:
    def __init__(self, value):
        self.value = value


def _drive_registry(mod, seed):
    """One sequence of registry operations, numpy-seeded values."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("obs_test_total", "a counter")
    for v in rng.random(5):
        c.inc(float(v))
    lab = reg.counter("obs_shard_total", "per shard", labels=("shard",))
    for s in rng.integers(0, 3, 12):
        lab.labels(shard=str(s)).inc()
    g = reg.gauge("obs_depth", 'a "gauge"\nwith escapes')
    g.set(7)
    g.dec(2.5)
    g.inc(0.25)
    h = reg.histogram("obs_lat_seconds", "a histogram")
    for v in rng.exponential(0.01, 200):
        h.observe(float(v))
    reg.histogram("obs_empty_seconds", "no samples yet")
    hl = reg.histogram("obs_phase_seconds", "labeled", labels=("phase",))
    for v in rng.random(9):
        hl.labels(phase="a\\b").observe(float(v))
    holders = [_Holder(float(v)) for v in rng.random(3)]

    def collect(holder):
        yield mod.Sample("obs_held", "gauge", "held values",
                         (("kind", "x"),), holder.value)
        yield mod.Sample("obs_held_total", "counter", "summed", (),
                         holder.value * 2)
    for hd in holders:
        reg.register_object(hd, collect)
    special = reg.gauge("obs_special", "special values", labels=("v",))
    for name, v in (("nan", "nan"), ("inf", "inf"), ("ninf", "-inf")):
        special.labels(v=name).set(float(v))
    return reg, holders


@pytest.mark.parametrize("seed", range(3))
def test_registry_text_and_snapshot_identical(seed):
    got, keep_t = _drive_registry(tm, seed)
    want, keep_j = _drive_registry(jm, seed)
    assert got.prometheus_text() == want.prometheus_text()
    assert json.dumps(got.snapshot(), sort_keys=True) == \
        json.dumps(want.snapshot(), sort_keys=True)
    assert json.dumps(got.values(), sort_keys=True) == \
        json.dumps(want.values(), sort_keys=True)
    # dead holders drop out, reset keeps live collectors -- in both
    del keep_t[0], keep_j[0]
    got.reset()
    want.reset()
    assert got.prometheus_text() == want.prometheus_text()


@pytest.mark.parametrize("case", ["negative", "type", "labels", "name",
                                  "label_name", "unlabeled_use",
                                  "wrong_labels"])
def test_registry_errors_identical(case):
    def run(mod):
        reg = mod.MetricsRegistry()
        reg.counter("obs_c_total", "c", labels=("shard",))
        try:
            if case == "negative":
                reg.counter("obs_plain_total").inc(-1)
            elif case == "type":
                reg.gauge("obs_c_total")
            elif case == "labels":
                reg.counter("obs_c_total", labels=("other",))
            elif case == "name":
                reg.counter("0bad name")
            elif case == "label_name":
                reg.counter("obs_x_total", labels=("bad-label",))
            elif case == "unlabeled_use":
                reg.counter("obs_c_total", labels=("shard",)).inc()
            else:
                reg.counter("obs_c_total", labels=("shard",)).labels(x="1")
        except ValueError as e:
            return str(e)
        return None
    got, want = run(tm), run(jm)
    assert got is not None and got == want


def test_default_registry_swap():
    mine = tm.MetricsRegistry()
    prev = tm.set_registry(mine)
    try:
        assert tm.get_registry() is mine
    finally:
        assert tm.set_registry(prev) is mine


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

_TIME_KEYS = ("ts", "dur", "pid", "tid")


def _drive_tracer(mod):
    tr = mod.Tracer(enabled=True, max_events=40)
    with tr.span("outer", args={"k": 1}) as outer:
        with tr.span("inner"):
            pass
        with tr.phase("shard_dispatch", args={"shards": 4}):
            pass
        with tr.phase("merge"):
            pass
    phases = [p[0] for p in tr.take_phases()]
    root = tr.start_span("request", t0=0.5, kind="async",
                         args={"deadline_s": None})
    root.trace_id = root.span_id
    tr.add_span("admission", 0.5, 0.6, parent=root, kind="async",
                args={"policy": "none"})
    tr.add_span("queue", 0.6, 0.7, parent=root, kind="async")
    fl = tr.start_span("flush", parent=root, t0=0.7, kind="async")
    tr.add_span("merge", 0.71, 0.72, parent=fl, kind="async")
    tr.end_span(fl, t1=0.8)
    tr.end_span(root, t1=0.8, args={"outcome": "served"})
    sp = tr.start_span("worker_flush", parent=outer,
                       args={"worker": 0})
    tr.end_span(sp)
    for i in range(30):                        # overflow the bound
        tr.add_span(f"s{i}", 1.0, 1.5)
    evs = [{k: v for k, v in e.items() if k not in _TIME_KEYS}
           for e in tr.events()]
    return evs, phases, tr.dropped


def test_tracer_span_trees_identical_timestamps_aside():
    got, want = _drive_tracer(tt), _drive_tracer(jt)
    assert got == want
    evs, phases, dropped = got
    assert phases == ["shard_dispatch", "merge"] and dropped > 0
    assert tt.request_tree(evs).keys() == jt.request_tree(evs).keys()
    assert collections.Counter(e["ph"] for e in evs)["b"] == 5


def test_disabled_tracer_is_a_no_op_and_export(tmp_path):
    tr = tt.Tracer(enabled=False)
    with tr.span("outer"), tr.device_annotation("flush:w0"):
        tr.end_span(tr.start_span("inner"))
    tr.add_span("retro", 0.0, 1.0)
    assert tr.events() == [] and tr.take_phases() == []
    tr.reset(enabled=True)
    tr.add_span("x", 0.0, 0.001)
    assert tr.export(str(tmp_path / "t.json")) == 1
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["traceEvents"][0]["name"] == "x"


def test_device_annotation_records_a_profiler_range_on_cpu():
    tr = tt.Tracer(enabled=True, device_annotations=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.device_annotation("flush:w3"):
            torch.ones(4).sum()
    assert any(e.key == "flush:w3" for e in prof.key_averages())
    # off unless both switches are on
    with tt.Tracer(enabled=True).device_annotation("x"):
        pass


# ---------------------------------------------------------------------------
# HTTP exporter
# ---------------------------------------------------------------------------

def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.read()


def test_exporter_serves_metrics_json_trace_and_health():
    reg = tm.MetricsRegistry()
    reg.counter("obs_http_total", "served").inc(2)
    tr = tt.Tracer(enabled=True)
    tr.add_span("hello", 0.0, 0.001)
    with te.start_http_exporter(port=0, registry=reg, tracer=tr) as exp:
        assert exp.port > 0
        assert _get(exp.url + "/healthz") == b"ok"
        assert _get(exp.url + "/metrics").decode() == reg.prometheus_text()
        snap = json.loads(_get(exp.url + "/metrics.json"))
        assert snap["obs_http_total"]["samples"][0]["value"] == 2.0
        doc = json.loads(_get(exp.url + "/trace"))
        assert doc["traceEvents"][0]["name"] == "hello"
        with pytest.raises(urllib.error.HTTPError):
            _get(exp.url + "/nope")
    assert not exp._thread.is_alive()


# ---------------------------------------------------------------------------
# Serving families and span trees, against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_shards")
    paths, words, _, _ = _sig_corpus(str(tmp), n=200, seed=31, n_files=4)
    build_sharded(paths, str(tmp / "sh"), BandingConfig(*CFG), n_shards=2,
                  device="cpu")
    return str(tmp / "sh"), words


def _serve(server_cls, router, words, reg, tr):
    with server_cls(router, max_batch=4, max_delay_s=30.0, topk=5,
                    registry=reg, tracer=tr) as srv:
        handles = [srv.submit(words[i]) for i in range(8)]
        for h in handles:
            h.result(timeout=60.0)
    return srv


def _families(text):
    return {line for line in text.splitlines() if line.startswith("# ")}


def test_served_router_exports_the_reference_families(shards):
    shard_dir, words = shards
    j_reg, t_reg = jm.MetricsRegistry(), tm.MetricsRegistry()
    j_tr, t_tr = jt.Tracer(enabled=True), tt.Tracer(enabled=True)
    prev_j, prev_t = jm.set_registry(j_reg), tm.set_registry(t_reg)
    try:
        j_router = j_load_sharded(shard_dir, backend="ref", corpus_block=64)
        t_router = load_sharded(shard_dir, device="cpu", corpus_block=64)
        j_srv = _serve(JServer, j_router, words, j_reg, j_tr)
        t_srv = _serve(SearchServer, t_router, words, t_reg, t_tr)
        j_text, t_text = j_reg.prometheus_text(), t_reg.prometheus_text()
    finally:
        jm.set_registry(prev_j)
        tm.set_registry(prev_t)
    left_out = {"# HELP index_exact_scan_retraces_total jit retraces of "
                "the fused exact scan (0 on a cache hit)",
                "# TYPE index_exact_scan_retraces_total counter"}
    assert _families(t_text) == _families(j_text) - left_out
    assert any(f.startswith("# TYPE serve_") for f in _families(t_text))
    assert "# TYPE index_generation gauge" in _families(t_text)
    # the counters that do not depend on timing are equal
    jv, tv = j_reg.values(), t_reg.values()
    for key in ("serve_requests_total", "serve_batches_total",
                'serve_flushes_total{trigger="full"}', "index_docs",
                "index_shards", "index_generation",
                "serve_batch_size_count", "serve_batch_size_sum"):
        assert tv[key] == jv[key], key
    assert tv["serve_roofline_predicted_bytes"] == \
        jv["serve_roofline_predicted_bytes"]
    # request span trees: the same names, parents and counts
    def shape(tr):
        trees = jt.request_tree(tr.events())
        batch = sorted(e["name"] for e in trees.pop(0, []))
        reqs = sorted(tuple(sorted(e["name"] for e in evs if e["ph"] == "b"))
                      for evs in trees.values())
        return batch, reqs
    assert shape(t_tr) == shape(j_tr)
    assert "worker_flush" in shape(t_tr)[0]
    assert t_srv.stats.requests == j_srv.stats.requests == 8


def test_roofline_gauge_reads_h100_bandwidth(shards):
    shard_dir, words = shards
    reg = tm.MetricsRegistry()
    router = load_sharded(shard_dir, device="cpu", corpus_block=64)
    _serve(SearchServer, router, words, reg, tt.Tracer())
    v = reg.values()
    assert v["serve_roofline_predicted_seconds"] == pytest.approx(
        v["serve_roofline_predicted_bytes"] / 3.35e12)
    assert v["serve_roofline_gap"] == pytest.approx(
        v["serve_roofline_measured_seconds"]
        / v["serve_roofline_predicted_seconds"])


def test_roofline_terms_equal_reference():
    assert hardware.HBM_BW == 3.35e12
    for args in ((10_000, 32, 8), (677_399, 128, 256), (1, 1, 1)):
        assert troof.exact_scan_cost(*args, topk=10) == \
            jroof.exact_scan_cost(*args, topk=10)
    got = troof.roofline_gap(3.35e12, 2.0)
    assert got == jroof.roofline_gap(3.35e12, 2.0, bw=3.35e12)
    assert got["gap"] == pytest.approx(2.0)
    for bad in ((0, 32, 8), (8, 0, 8)):
        with pytest.raises(ValueError):
            troof.exact_scan_cost(*bad)
    with pytest.raises(ValueError):
        troof.roofline_gap(0.0, 1.0)


# ---------------------------------------------------------------------------
# Loader and signature-cache collectors
# ---------------------------------------------------------------------------

def test_loader_collector_matches_reference(tmp_path):
    spec = DatasetSpec("obs_loader", n=120, D=1 << 12, avg_nnz=20,
                       n_prototypes=3, overlap=0.5, seed=2)
    raw = make_sharded_dataset(spec, str(tmp_path / "raw"), n_shards=3)
    j_reg, t_reg = jm.MetricsRegistry(), tm.MetricsRegistry()
    prev_j, prev_t = jm.set_registry(j_reg), tm.set_registry(t_reg)
    try:
        t_loader = ChunkedLoader(raw, chunk_size=32, device="cpu",
                                 lane_multiple=8)
        j_loader = JLoader(raw, chunk_size=32, lane_multiple=8)
        assert len(list(t_loader)) == len(list(j_loader))
        tv, jv = t_reg.values(), j_reg.values()
    finally:
        jm.set_registry(prev_j)
        tm.set_registry(prev_t)
    names = {k for k in jv if k.startswith("data_loader_")}
    assert names == {k for k in tv if k.startswith("data_loader_")}
    for key in names:
        if not key.startswith("data_loader_seconds"):
            assert tv[key] == jv[key], key
    assert tv['data_loader_chunks_total{role="load"}'] == 3.0


def test_signature_cache_registers_its_collectors(tmp_path):
    from repro_torch.data.pipeline import SignatureStream
    from repro_torch.train.online import SignatureCache, make_family
    spec = DatasetSpec("obs_cache", n=100, D=1 << 12, avg_nnz=20,
                       n_prototypes=3, overlap=0.5, seed=3)
    raw = make_sharded_dataset(spec, str(tmp_path / "raw"), n_shards=2)
    reg = tm.MetricsRegistry()
    prev = tm.set_registry(reg)
    try:
        fam = make_family("oph", 64, 12, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        stream = SignatureStream(raw, fam, b=8, chunk_size=40,
                                 loader_kwargs={"lane_multiple": 8})
        with SignatureCache(stream, cache_dir=str(tmp_path / "c")) as cache:
            list(cache)                     # populate
            list(cache)                     # replay
            v = reg.values()
    finally:
        tm.set_registry(prev)
    assert v["sigcache_examples"] == 80.0 and v["sigcache_shards"] == 2.0
    assert v["sigcache_bytes_cached"] > 0
    assert v['data_loader_chunks_total{role="replay"}'] == 0.0
    assert v['data_loader_bytes_read_total{role="replay"}'] > 0
    assert v['data_loader_chunks_total{role="load"}'] == 2.0
    assert os.path.isdir(str(tmp_path / "c"))
