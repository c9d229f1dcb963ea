"""Port parity for retrieval on a device mesh (``ShardedIndex(mesh=...)``,
``dispatch="mesh"``) against the port's sequential fan-out and the JAX
package.

The corpus is the reference's mesh corpus (``tests/test_mesh_router.py``:
420 docs, K = 128, S = 16, b = 8, OPH 2U rotation), hashed to ``.sig``
shards by both packages with the JAX family's coefficients handed over
through numpy (``family_from_jax``), the bytes checked equal.  Mesh
positions are CPU positions (``make_debug_mesh(n, devices=[cpu] * n)``),
the counterpart of the reference's forced host devices.

  * exact and LSH: the mesh result == the port's sequential result == the
    JAX package's sequential router (Pallas interpret mode) on the same
    bytes, ids and scores bit for bit, candidate counts too, for (shards,
    positions) in (2, 2), (3, 8), (5, 4), (6, 8); at (5, 4) also == the
    JAX mesh dispatcher on the forced host devices;
  * the Theorem-1 rerank with set sizes: mesh == sequential == a single
    index bit for bit; against the reference ids equal and scores within
    an absolute 1e-6 (XLA's float32 ``expm1``, ``test_torch_index.py``);
    a missing ``query_sizes`` raises;
  * ``submit`` / ``flush`` through the mesh; a streamed shard refused;
    placement by position; the counters and the ``mesh_dispatch`` phase;
    spill-appends racing mesh searches, never torn;
  * ``serve --index --shards 4 --mesh 2 --device cpu`` and its ``--serve``
    default of one worker per position.
"""

import glob
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.oph import OPH as JOPH
from repro.data.pipeline import make_sharded_dataset as j_make_sharded
from repro.data.preprocess import preprocess_shards as j_preprocess
from repro.data.sigshard import write_sig_shard as j_write_sig_shard
from repro.data.sparse import from_lists as j_from_lists
from repro.data.synthetic import DatasetSpec as JDatasetSpec
from repro.index import IndexSearcher as JSearcher
from repro.index import load_index as j_load_index
from repro.index import load_sharded as j_load_sharded
from repro.kernels import SignatureEngine as JEngine
from repro.launch.mesh import make_debug_mesh as j_make_debug_mesh
from repro_torch.convert import family_from_jax
from repro_torch.data.preprocess import preprocess_shards as t_preprocess
from repro_torch.index import (BandingConfig, IndexSearcher, build_index,
                               build_sharded, choose_band_config,
                               load_index, load_sharded)
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.server import SearchServer
from repro_torch.obs import get_registry, get_tracer

K, S, B = 128, 16, 8
SCORE_ATOL = 1e-6          # Theorem-1 scores against the reference
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's plain-version scans would otherwise take every core
    from the timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_port_obs():
    yield
    get_registry().reset()
    get_tracer().reset(enabled=False)


def _mesh(n):
    return make_debug_mesh(n, axes=("data",), devices=[CPU] * n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The reference's mesh corpus as ``.sig`` shards (written by both
    packages, byte-identical) + one single ``.idx``."""
    tmp = tmp_path_factory.mktemp("mesh_corpus")
    spec = JDatasetSpec("meshtest", n=420, D=1 << S, avg_nnz=48,
                        n_prototypes=8, overlap=0.8, seed=11)
    raw = j_make_sharded(spec, str(tmp / "raw"), n_shards=5)
    jfam = JOPH.create(jax.random.PRNGKey(1), K, S, "2u", "rotation")
    sig = {}
    for who, prep, fam in (("j", j_preprocess, jfam),
                           ("t", t_preprocess, family_from_jax(jfam, "cpu"))):
        prep(raw, str(tmp / f"sig_{who}"), fam, b=B, chunk_size=64,
             loader_kwargs={"lane_multiple": 8})
        sig[who] = sorted(glob.glob(str(tmp / f"sig_{who}" / "*.sig")))
    assert [open(p, "rb").read() for p in sig["t"]] == \
        [open(p, "rb").read() for p in sig["j"]]
    cfg = choose_band_config(K, B, threshold=0.5)
    build_index(sig["t"], str(tmp / "single.idx"), cfg, device="cpu")
    single = IndexSearcher(load_index(str(tmp / "single.idx"), device="cpu"),
                           device="cpu", corpus_block=128)
    return dict(tmp=tmp, paths=sig["t"], cfg=cfg, single=single)


def _queries(index, picks):
    return np.ascontiguousarray(index.words_host[picks])


def _same(a, b, what):
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    np.testing.assert_array_equal(a.scores, b.scores, err_msg=what)


@pytest.mark.parametrize("n_shards,n_pos", [(2, 2), (3, 8), (5, 4), (6, 8)])
def test_mesh_dispatch_bit_identical(corpus, tmp_path, host_devices,
                                     n_shards, n_pos):
    """Mesh == sequential == single index == the JAX router, exact and
    LSH, with more shards than positions (5 on 4 stacks two shards on
    position 0) and more positions than shards (3 on 8)."""
    single = corpus["single"]
    shard_dir = str(tmp_path / "shards")
    build_sharded(corpus["paths"], shard_dir, corpus["cfg"],
                  n_shards=n_shards, device="cpu")
    router = load_sharded(shard_dir, mesh=_mesh(n_pos), device="cpu",
                          corpus_block=128)
    j_router = j_load_sharded(shard_dir, dispatch="sequential",
                              backend="interpret", corpus_block=128)
    j_mesh = None
    if (n_shards, n_pos) == (5, 4):
        j_mesh = j_load_sharded(shard_dir,
                                mesh=j_make_debug_mesh(n_pos, axes=("data",)),
                                backend="interpret", corpus_block=128)
    n = single.index.n
    q = _queries(single.index, [0, 7, n // 3, n // 2, n - 2, n - 1])
    for mode in ("exact", "lsh"):
        want = single.search(q, 10, mode=mode)
        got = router.search(q, 10, mode=mode)                # auto -> mesh
        seq = router.search(q, 10, mode=mode, dispatch="sequential")
        refs = [j_router.search(jnp.asarray(q), 10, mode=mode)]
        if j_mesh is not None:
            refs.append(j_mesh.search(jnp.asarray(q), 10, mode=mode))
        for name, r in [("mesh", got), ("sequential", seq),
                        *[(f"reference {i}", r) for i, r in enumerate(refs)]]:
            _same(r, want, f"{mode} {name}")
        assert np.all(got.indices[:, 0] >= 0)
        if mode == "lsh":
            for r in (got, seq, *refs):
                np.testing.assert_array_equal(r.n_candidates,
                                              want.n_candidates)
    assert router.mesh_exact_dispatches == 1
    assert router.mesh_lsh_dispatches == 1
    if j_mesh is not None:
        assert j_mesh.mesh_exact_dispatches == 1
        assert j_mesh.mesh_lsh_dispatches == 1


def test_mesh_with_set_sizes_rerank(tmp_path):
    """The Theorem-1 rerank (stored set sizes + query_sizes) through the
    mesh: == the sequential fan-out and a single index bit for bit; the
    reference's ids, its scores within ``SCORE_ATOL``."""
    rng = np.random.default_rng(9)
    sets = [rng.choice(1 << S, rng.integers(30, 90), replace=False)
            for _ in range(96)]
    fam = JOPH.create(jax.random.PRNGKey(2), K, S, "2u", "rotation")
    wire = np.asarray(JEngine(fam, b=B, packed=True).packed_signatures(
        j_from_lists(sets, max_nnz=128)).data)
    sizes = np.array([len(s) for s in sets], np.uint32)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.sig")
        j_write_sig_shard(p, wire[i * 32:(i + 1) * 32],
                          np.zeros(32, np.float32), k=K, b=B, code_bits=B)
        paths.append(p)
    cfg = BandingConfig(16, 2, B)
    build_index(paths, str(tmp_path / "one.idx"), cfg, set_sizes=sizes, s=S,
                device="cpu")
    build_sharded(paths, str(tmp_path / "sh"), cfg, n_shards=3,
                  set_sizes=sizes, s=S, device="cpu")
    single = IndexSearcher(load_index(str(tmp_path / "one.idx"),
                                      device="cpu"), device="cpu",
                           corpus_block=32)
    router = load_sharded(str(tmp_path / "sh"), mesh=_mesh(8), device="cpu",
                          corpus_block=32)
    j_single = JSearcher(j_load_index(str(tmp_path / "one.idx")),
                         backend="interpret", corpus_block=32)
    q, qs = wire[:5], sizes[:5]
    for mode in ("exact", "lsh"):
        want = single.search(q, 8, mode=mode, query_sizes=qs)
        got = router.search(q, 8, mode=mode, query_sizes=qs)
        seq = router.search(q, 8, mode=mode, query_sizes=qs,
                            dispatch="sequential")
        _same(got, want, mode)
        _same(seq, want, mode)
        ref = j_single.search(jnp.asarray(q), 8, mode=mode, query_sizes=qs)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0,
                                   atol=SCORE_ATOL)
    assert router.mesh_exact_dispatches == router.mesh_lsh_dispatches == 1
    # forgetting query_sizes fails loudly on the mesh path too
    with pytest.raises(ValueError, match="query_sizes"):
        router.search(q, 8)
    with pytest.raises(ValueError, match="query_sizes"):
        router.search(q, 8, mode="lsh")
    assert router.mesh_exact_dispatches == router.mesh_lsh_dispatches == 1


def test_mesh_submit_flush_admission(corpus, tmp_path):
    """Batched admission drains through the mesh dispatcher: per-ticket
    rows equal the single index's batch rows."""
    single = corpus["single"]
    shard_dir = str(tmp_path / "shards")
    build_sharded(corpus["paths"], shard_dir, corpus["cfg"], n_shards=3,
                  device="cpu")
    router = load_sharded(shard_dir, mesh=_mesh(8), device="cpu",
                          corpus_block=128)
    n = single.index.n
    rows = [np.asarray(single.index.words_host[i])
            for i in (3, n // 2 + 1, n - 5)]
    for mode in ("exact", "lsh"):
        tickets = [router.submit(r) for r in rows]
        out = router.flush(5, mode=mode)
        want = single.search(np.stack(rows), 5, mode=mode)
        for i, t in enumerate(tickets):
            np.testing.assert_array_equal(out[t].indices[0], want.indices[i])
            np.testing.assert_array_equal(out[t].scores[0], want.scores[i])
    assert router.mesh_exact_dispatches == router.mesh_lsh_dispatches == 1


def test_mesh_refusals(corpus, tmp_path):
    """No silent fallback: a streamed shard, a missing mesh, a device that
    disagrees with the mesh and an unknown dispatch all raise."""
    shard_dir = str(tmp_path / "shards")
    build_sharded(corpus["paths"], shard_dir, corpus["cfg"], n_shards=2,
                  device="cpu")
    router = load_sharded(shard_dir, mesh=_mesh(4), device="cpu",
                          corpus_block=64, max_device_bytes=4096)
    assert any(s.streamed for s in router.searchers)
    q = _queries(router.searchers[0].index, [0, 1])
    for mode in ("exact", "lsh"):
        with pytest.raises(ValueError, match="max_device_bytes"):
            router.search(q, 5, mode=mode)
    assert router.mesh_exact_dispatches == router.mesh_lsh_dispatches == 0
    # the sequential fan-out still streams, on the placed positions
    plain = load_sharded(shard_dir, device="cpu", corpus_block=64,
                         max_device_bytes=4096)
    _same(router.search(q, 5, dispatch="sequential"), plain.search(q, 5),
          "streamed sequential")
    with pytest.raises(ValueError, match="needs a mesh"):
        load_sharded(shard_dir, device="cpu", dispatch="mesh")
    with pytest.raises(ValueError, match="needs a mesh"):
        plain.search(q, 5, dispatch="mesh")
    with pytest.raises(ValueError, match="needs a mesh"):
        plain.mesh_layout()
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        load_sharded(shard_dir, mesh=_mesh(2), device="cuda")
    with pytest.raises(ValueError, match="dispatch must be"):
        load_sharded(shard_dir, mesh=_mesh(2), device="cpu",
                     dispatch="shard_map")


def test_mesh_placement_by_position(corpus, tmp_path):
    """Placement keys by position along "data", not by device: 8
    positions on one CPU get 8 stacked corpora; 5 shards on 4 positions
    stack shards 0 and 4 on position 0, in ascending global ids."""
    shard_dir = str(tmp_path / "shards")
    build_sharded(corpus["paths"], shard_dir, corpus["cfg"], n_shards=5,
                  device="cpu")
    router = load_sharded(shard_dir, mesh=_mesh(4), device="cpu",
                          corpus_block=64)
    lay = router.mesh_layout()
    assert lay.D == 4 and lay.block == 64
    assert [s.device for s in router.searchers] == [CPU] * 5
    h0 = -(-router.searchers[0].index.n // 64) * 64
    assert lay.shard_pos == ((0, 0), (1, 0), (2, 0), (3, 0), (0, h0))
    assert lay.rows == max(h0 + -(-router.searchers[4].index.n // 64) * 64,
                           *(-(-s.index.n // 64) * 64
                             for s in router.searchers[1:4]))
    ids0 = lay.ids[0].numpy()
    real = ids0[ids0 >= 0]
    assert np.all(np.diff(real) > 0)
    off = router.offsets
    assert set(real) == set(range(off[0], off[1])) | \
        set(range(off[4], router.n))
    assert lay.stacked_bytes == lay.rows * router.spec.words * 4
    assert router.mesh_layout() is lay              # built once per state

    wide = load_sharded(shard_dir, mesh=_mesh(8), device="cpu",
                        corpus_block=64)
    lay8 = wide.mesh_layout()
    assert lay8.D == 8 and len({id(c) for c in lay8.corpora}) == 8
    for d in range(5, 8):                           # positions with no shard
        assert np.all(lay8.ids[d].numpy() == -1)
    q = _queries(corpus["single"].index, [0, 99, 300])
    _same(wide.search(q, 7), router.search(q, 7), "8 vs 4 positions")


def test_mesh_counters_phase_and_metrics(corpus, tmp_path):
    shard_dir = str(tmp_path / "shards")
    build_sharded(corpus["paths"], shard_dir, corpus["cfg"], n_shards=3,
                  device="cpu")
    router = load_sharded(shard_dir, mesh=_mesh(2), device="cpu",
                          corpus_block=128)
    tracer = get_tracer()
    tracer.reset(enabled=True)
    q = _queries(router.searchers[0].index, [0, 5])
    router.search(q, 4)
    router.search(q, 4, mode="lsh")
    router.search(q, 4, mode="lsh")
    router.search(q, 4, dispatch="sequential")
    assert (router.mesh_exact_dispatches, router.mesh_lsh_dispatches) == \
        (1, 2)
    phases = [e for e in tracer.events() if e["name"] == "mesh_dispatch"]
    assert [{k: e["args"][k] for k in ("mode", "devices")}
            for e in phases] == \
        [{"mode": "exact", "devices": 2}] + [{"mode": "lsh", "devices": 2}] * 2
    assert sum(e["name"] == "shard_dispatch" for e in tracer.events()) == 1
    vals = get_registry().values()
    assert vals['index_mesh_dispatches_total{mode="exact"}'] == 1.0
    assert vals['index_mesh_dispatches_total{mode="lsh"}'] == 2.0
    # the server's default: one dispatch worker per position
    assert SearchServer._default_workers(router) == 2
    assert SearchServer._default_workers(
        load_sharded(shard_dir, device="cpu")) == 1


def test_mesh_search_racing_spill_append_never_torn(corpus, tmp_path):
    """Spill-appends (new shards materialize mid-run) while the mesh
    dispatcher serves: every mesh result == a sequential search of the
    same generation, never a torn mix; the spilled shards take their
    round-robin positions and the end state == a single index."""
    paths, cfg = corpus["paths"], corpus["cfg"]
    shard_dir = str(tmp_path / "shards")
    build_sharded(paths[:3], shard_dir, cfg, n_shards=2, device="cpu")
    writer = load_sharded(shard_dir, device="cpu", corpus_block=128,
                          max_shard_docs=80)
    reader = load_sharded(shard_dir, mesh=_mesh(8), device="cpu",
                          corpus_block=128)
    q = _queries(reader.searchers[0].index, [0, 5, 11])
    stop = threading.Event()
    failures = []

    def appender():
        try:
            for sig in paths[3:]:
                writer.append([sig])
        except Exception as e:                     # pragma: no cover
            failures.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=appender)
    t.start()
    seen = set()
    try:
        while not stop.is_set():
            reader.refresh()
            seen.add(reader.generation)
            got = reader.search(q, 10)                       # mesh
            want = reader.search(q, 10, dispatch="sequential")
            _same(got, want, f"generation {reader.generation}")
    finally:
        t.join(timeout=120)
    assert not t.is_alive() and not failures
    reader.refresh()
    assert reader.n_shards > 2
    assert [d for d, _ in reader.mesh_layout().shard_pos] == \
        [s % 8 for s in range(reader.n_shards)]
    _same(reader.search(q, 10), corpus["single"].search(q, 10), "converged")
    assert len(seen) >= 1 and reader.mesh_exact_dispatches >= len(seen)


def test_serve_index_on_a_mesh_cpu(capsys):
    """The launcher: the reference's line shape ("{S} shards on {n}
    device(s) (... exact dispatch)"), and ``--serve`` defaults to one
    worker per position."""
    base = ["--index", "--device", "cpu", "--docs", "256", "--shards", "4",
            "--mesh", "2", "--queries", "8"]
    serve.main(base + ["--mode", "exact", "--requests", "2"])
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"indexed 204 docs into 4 shards on 2 device\(s\) "
                    r"\(mesh exact dispatch, positions on the CPU\) "
                    r"\(k=128 b=8 bands=", out[0]), out[0]
    assert "(exact): p50=" in out[1] and "self-hit@1=1.00" in out[1]
    serve.main(base + ["--serve", "--requests", "4", "--rate", "2000"])
    out = capsys.readouterr().out.splitlines()
    assert "over 2 worker(s)" in out[1], out[1]
