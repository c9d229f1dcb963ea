"""Port parity for the engine's tuning loop (``repro_torch.kernels.engine``
``TuningTable`` / ``default_tuning_table`` / ``tune``) against the JAX
package, and the launch shapes it hands to the minhash, OPH and
packed-match launchers.

  * Saved tables: the same entries recorded by both packages give
    byte-identical JSON files, and each package loads the other's.
  * Lookup: nnz buckets, scheme separation, and the order explicit
    ``blocks`` > table entry > default, as ``tests/test_engine.py``
    checks them in the reference.  The port's schemes are the kernels'
    names (``minhash2u``, ``minhash4u``, ``oph2u``, ``oph4u``) and
    ``hamming``; its backends ``cuda`` and ``torch``.
  * ``tune()`` on CPU tensors (the plain versions, so the times say
    nothing about a launch shape) records its pick under ``torch/...``;
    the engine, ``packed_match`` and ``IndexSearcher`` then take it, and
    every output equals the reference's bit for bit.
  * A launch shape the build lacks raises ``ValueError`` on CPU tensors,
    from the launchers, the engine and a table entry alike.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hashing import Hash2U as JHash2U
from repro.core.hashing import Hash4U as JHash4U
from repro.core.oph import OPH as JOPH
from repro.data.sigshard import write_sig_shard as j_write_sig_shard
from repro.data.sparse import from_lists as j_from_lists
from repro.index import IndexSearcher as JSearcher
from repro.index import load_index as j_load_index
from repro.index import build_index as j_build_index
from repro.index import choose_band_config as j_choose_band_config
from repro.kernels import SignatureEngine as JEngine
from repro.kernels import TuningTable as JTuningTable
from repro.kernels import batch_signatures as j_batch_signatures
from repro.kernels.hamming import packed_match as j_packed_match
from repro.kernels.pack import PackSpec as JPackSpec
from repro_torch.convert import family_from_jax
from repro_torch.core.u32 import from_numpy, to_numpy
from repro_torch.data.sparse import from_lists
from repro_torch.index import IndexSearcher, ShardedIndex, load_index
from repro_torch.kernels import (PackSpec, SignatureEngine, TuningTable,
                                 default_tuning_table, tune)
from repro_torch.kernels import engine
from repro_torch.kernels import hamming as kham
from repro_torch.kernels import minhash as kmin
from repro_torch.kernels import oph as koph

S, NNZ = 16, 256
CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                    "repro_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's torch work would otherwise take every core from the
    timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_default(monkeypatch):
    """The process-wide table reloaded on first use, its variable unset."""
    monkeypatch.setattr(engine, "_DEFAULT_TABLE", None)
    monkeypatch.delenv(engine.TABLE_ENV, raising=False)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(27)
    sets = [rng.choice(1 << S, rng.integers(1, 220), replace=False)
            for _ in range(13)]
    sets = sets[:5] + [np.zeros(0, np.int64)] + sets[5:]
    return (j_from_lists(sets, max_nnz=NNZ),
            from_lists(sets, max_nnz=NNZ, device="cpu"))


def _family(kind, k, seed):
    key = jax.random.PRNGKey(seed)
    if kind == "2u":
        return JHash2U.create(key, k, S)
    if kind == "4u":
        return JHash4U.create(key, k, S)
    return JOPH.create(key, k, S, kind.split("-")[1], "rotation")


# ---------------------------------------------------------------------------
# The saved table
# ---------------------------------------------------------------------------

ENTRY_SETS = {
    "port": [("cuda", "minhash2u", 200, 3_840, {"threads": 64}),
             ("cuda", "oph4u", 512, 3_840, {"threads": 128}),
             ("cuda", "hamming", 512, 128, {"blk_q": 32, "blk_n": 64}),
             ("torch", "minhash4u", 500, 100, {"threads": 256})],
    "reference": [("tpu", "minhash", 128, 300,
                   {"blk_n": 16, "blk_t": 512, "blk_k": 128}),
                  ("interpret", "hamming", 128, 32,
                   {"blk_q": 8, "blk_n": 128, "blk_k": 128})],
}


@pytest.mark.parametrize("entries", sorted(ENTRY_SETS))
def test_saved_tables_byte_identical_and_cross_load(tmp_path, entries):
    j_table, t_table = JTuningTable(), TuningTable()
    for backend, scheme, k, nnz, blocks in ENTRY_SETS[entries]:
        j_table.record(backend, scheme, k, nnz, blocks)
        t_table.record(backend, scheme, k, nnz, blocks)
    j_path = j_table.save(str(tmp_path / "j.json"))
    t_path = t_table.save(str(tmp_path / "t.json"))
    with open(j_path, "rb") as fj, open(t_path, "rb") as ft:
        assert fj.read() == ft.read()
    with open(t_path) as f:
        assert json.load(f)["version"] == 1
    assert JTuningTable.load(t_path).entries == t_table.entries
    assert TuningTable.load(j_path).entries == j_table.entries
    for backend, scheme, k, nnz, blocks in ENTRY_SETS[entries]:
        assert TuningTable.load(j_path).lookup(backend, scheme, k,
                                               nnz) == blocks
        assert (TuningTable.key(backend, scheme, k, engine.nnz_bucket(nnz))
                == JTuningTable.key(backend, scheme, k,
                                    engine.nnz_bucket(nnz)))
    with pytest.raises(ValueError, match="no path"):
        TuningTable().save()


# ---------------------------------------------------------------------------
# Lookup: buckets, schemes, explicit > table > default
# ---------------------------------------------------------------------------

def test_buckets_and_scheme_separation():
    table = TuningTable()
    table.record("cuda", "minhash2u", 128, 300, {"threads": 64})
    assert table.lookup("cuda", "minhash2u", 128, 260) == {"threads": 64}
    assert table.lookup("cuda", "minhash2u", 128, 1_000) is None
    assert table.lookup("cuda", "minhash4u", 128, 300) is None
    assert table.lookup("cuda", "oph2u", 128, 300) is None
    assert table.lookup("torch", "minhash2u", 128, 300) is None
    assert table.lookup("cuda", "minhash2u", 64, 300) is None
    assert [engine.nnz_bucket(n) for n in (0, 1, 128, 129, 3_840)] == \
        [128, 128, 128, 256, 4_096]


def test_blocks_explicit_over_table_over_default(batches, fresh_default):
    _, tb = batches
    nnz = tb.indices.shape[1]
    fam = family_from_jax(_family("2u", 128, 1), "cpu")
    oph = family_from_jax(_family("oph-2u", 128, 2), "cpu")
    tuned = TuningTable()
    tuned.record("torch", "minhash2u", 128, nnz, {"threads": 64})
    eng = SignatureEngine(fam, tuning=tuned)
    assert eng.scheme == "minhash2u" and eng.backend == "torch"
    assert eng.plan_for(nnz).threads == 64
    assert eng.plan_for(nnz).blocks == {"threads": 64}
    # another bucket, and another kernel's scheme: the default
    assert eng.plan_for(4 * nnz).threads == kmin.MINHASH_BLK_K
    assert SignatureEngine(oph, tuning=tuned).plan_for(nnz).threads == \
        koph.OPH_THREADS
    assert SignatureEngine(family_from_jax(_family("4u", 128, 3), "cpu"),
                           tuning=tuned).plan_for(nnz).threads == \
        kmin.MINHASH_BLK_K
    explicit = SignatureEngine(fam, blocks={"threads": 256}, tuning=tuned)
    assert explicit.plan_for(nnz).threads == 256
    # no table given: the process-wide one (empty here) and the default
    assert SignatureEngine(fam).plan_for(nnz).threads == kmin.MINHASH_BLK_K
    default_tuning_table().record("torch", "minhash2u", 128, nnz,
                                  {"threads": 32})
    assert SignatureEngine(fam).plan_for(nnz).threads == 32


@pytest.mark.parametrize("family,k", [("2u", 64), ("2u", 128), ("4u", 128),
                                      ("2u", 100), ("4u", 100), ("2u", 500)])
def test_engine_passes_threads_and_picks_fused_pack(batches, monkeypatch,
                                                    family, k):
    """The engine launches with the plan's ``threads`` and asks the kernel
    for its fused pack at every k and launch shape where the code width
    divides 32 (b = 8; a ragged last warp packs too); the packed words
    equal the reference's."""
    jb, tb = batches
    jfam = _family(family, k, 4)
    fam = family_from_jax(jfam, "cpu")
    name = f"minhash{family}"
    real = getattr(kmin, name)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(kmin, name, spy)
    want = np.asarray(j_batch_signatures(jb, jfam, b=8, backend="ref",
                                         packed=True).data)
    for threads in (32, 64, 128, 256):
        calls.clear()
        got = SignatureEngine(fam, b=8, packed=True,
                              blocks={"threads": threads})(tb)
        np.testing.assert_array_equal(to_numpy(got.data), want)
        assert calls == [dict(s=S, b=8, threads=threads, pack=True,
                              **({"variant": "high"} if family == "2u"
                                 else {}))]


# ---------------------------------------------------------------------------
# tune() on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,packed", [("2u", False), ("2u", True),
                                         ("4u", True), ("oph-2u", True)])
def test_tune_records_and_engine_takes_it(batches, kind, packed):
    jb, tb = batches
    k = 128
    jfam = _family(kind, k, 5)
    fam = family_from_jax(jfam, "cpu")
    eng = SignatureEngine(fam, b=8, packed=packed)
    scheme = "oph2u" if kind == "oph-2u" else f"minhash{kind}"
    cands = ([{"threads": t} for t in (64, 128, 256, 512)]
             if kind.startswith("oph") else
             [{"threads": t} for t in (32, 64, 128, 256)])
    table = TuningTable()
    best = tune(eng, tb, cands, iters=2, table=table)
    assert best in cands
    nnz = tb.indices.shape[1]
    key = TuningTable.key("torch", scheme, k, engine.nnz_bucket(nnz))
    assert table.entries == {key: best}
    fresh = SignatureEngine(fam, b=8, packed=packed, tuning=table)
    assert fresh.plan_for(nnz).blocks == best
    got = fresh(tb)
    want = j_batch_signatures(jb, jfam, b=8, backend="ref", packed=packed)
    np.testing.assert_array_equal(
        to_numpy(got.data if packed else got),
        np.asarray(want.data if packed else want))


def test_tune_records_into_engine_table_or_default(batches, fresh_default):
    _, tb = batches
    fam = family_from_jax(_family("2u", 64, 6), "cpu")
    own = TuningTable()
    best = tune(SignatureEngine(fam, tuning=own), tb, [{"threads": 64}],
                iters=1)
    assert list(own.entries.values()) == [best]
    best = tune(SignatureEngine(fam), tb, [{"threads": 32}], iters=1)
    key = TuningTable.key("torch", "minhash2u", 64,
                          engine.nnz_bucket(tb.indices.shape[1]))
    assert default_tuning_table().entries[key] == best
    with pytest.raises(ValueError, match="at least one"):
        tune(SignatureEngine(fam), tb, [], table=TuningTable())
    with pytest.raises(ValueError, match="iters"):
        tune(SignatureEngine(fam), tb, [{"threads": 32}], iters=0,
             table=TuningTable())


@pytest.mark.parametrize("b,sentinel", [(8, False), (8, True), (4, False)])
def test_tune_packed_match(b, sentinel):
    rng = np.random.default_rng(b + sentinel)
    k = 100
    spec = PackSpec(k, b, sentinel)
    top = 1 << spec.code_bits
    qc = rng.integers(0, min(top, 6), (9, k))
    cc = rng.integers(0, min(top, 6), (70, k))
    cc[:9] = qc
    from repro_torch.core.bbit import pack_codes
    q = pack_codes(from_numpy(qc, "cpu"), spec.code_bits)
    c = pack_codes(from_numpy(cc, "cpu"), spec.code_bits)
    tiles = [{"blk_q": tq, "blk_n": tn} for tq, tn in
             kham.HAMMING_TILES[kham.tile_kernel(spec.code_bits)]]
    table = TuningTable()
    best = tune(spec, (q, c), tiles, iters=2, table=table)
    assert best in tiles
    assert table.entries == {TuningTable.key(
        "torch", "hamming", k, engine.nnz_bucket(spec.words)): best}
    assert kham.resolve_tile(spec, torch.device("cpu"), tuning=table) == best
    got = kham.packed_match(q, c, spec, tuning=table)
    want = j_packed_match(jnp.asarray(to_numpy(q)), jnp.asarray(to_numpy(c)),
                          JPackSpec(k, b, sentinel), backend="ref")
    if sentinel:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Launch shapes the build lacks
# ---------------------------------------------------------------------------

def _oph_args(tb):
    fam = family_from_jax(_family("oph-2u", 128, 7), "cpu").base
    return (tb.indices, tb.nnz_per_row(), fam.a1, fam.a2)


@pytest.mark.parametrize("case", ["oph threads 96", "oph threads 1088",
                                  "oph4u threads 32", "minhash threads 0",
                                  "minhash threads 2048",
                                  "minhash4u threads 48",
                                  "minhash threads True"])
def test_bad_threads_raise_on_cpu(batches, case):
    _, tb = batches
    threads = {"True": True}.get(case.split()[-1]) or int(case.split()[-1])
    if case.startswith("oph4u"):
        a = from_numpy(np.ones((4, 1), np.int64), "cpu")
        call = lambda: koph.oph4u(tb.indices, tb.nnz_per_row(), a, s=S,
                                  bin_bits=7, threads=threads)
    elif case.startswith("oph"):
        call = lambda: koph.oph2u(*_oph_args(tb), s=S, bin_bits=7,
                                  threads=threads)
    elif case.startswith("minhash4u"):
        fam = family_from_jax(_family("4u", 64, 8), "cpu")
        call = lambda: kmin.minhash4u(tb.indices, tb.nnz_per_row(), fam.a,
                                      s=S, threads=threads)
    else:
        fam = family_from_jax(_family("2u", 64, 8), "cpu")
        call = lambda: kmin.minhash2u(tb.indices, tb.nnz_per_row(), fam.a1,
                                      fam.a2, s=S, threads=threads)
    with pytest.raises(ValueError, match="threads must be a multiple"):
        call()


@pytest.mark.parametrize("blocks", [{"threads": 96}, {"threads": 2048},
                                    {"blk_n": 8, "blk_t": 128, "blk_k": 128},
                                    {"threads": 64, "blk_k": 0}])
def test_bad_table_entries_raise_in_the_engine(batches, blocks):
    """A table entry (or explicit ``blocks``) that names a shape the
    launchers do not take -- a TPU tile dict included -- raises before any
    launch, on CPU tensors."""
    _, tb = batches
    nnz = tb.indices.shape[1]
    for kind, scheme in (("2u", "minhash2u"), ("oph-2u", "oph2u")):
        fam = family_from_jax(_family(kind, 128, 9), "cpu")
        table = TuningTable()
        table.record("torch", scheme, 128, nnz, blocks)
        eng = SignatureEngine(fam, b=8, tuning=table)
        if blocks == {"threads": 96} and scheme == "minhash2u":
            eng(tb)       # 96 is a multiple of 32: a minhash shape
            continue
        with pytest.raises(ValueError):
            eng(tb)
        with pytest.raises(ValueError):
            SignatureEngine(fam, blocks=blocks)


@pytest.mark.parametrize("code_bits,tile", [(8, (16, 64)), (8, (32, 16)),
                                            (9, (64, 64)), (9, (16, 16)),
                                            (4, (128, 128))])
def test_uninstantiated_tile_raises_on_cpu(code_bits, tile):
    k = 64
    spec = (PackSpec(k, code_bits - 1, True) if code_bits == 9
            else PackSpec(k, code_bits))
    q = torch.zeros((3, spec.words), dtype=torch.int32)
    blocks = {"blk_q": tile[0], "blk_n": tile[1]}
    with pytest.raises(ValueError, match="is built for tiles"):
        kham.packed_match(q, q, spec, blocks=blocks)
    table = TuningTable()
    table.record("torch", "hamming", k, spec.words, blocks)
    with pytest.raises(ValueError, match="is built for tiles"):
        kham.packed_match(q, q, spec, tuning=table)
    with pytest.raises(ValueError, match="a tile is"):
        kham.packed_match(q, q, spec, blocks={"blk_q": 64})


def test_hamming_tiles_are_the_sources():
    """``HAMMING_TILES`` lists what csrc/hamming.cu instantiates, the
    default first; every tile keeps per-thread pairs at or under the
    default's (4 x 8 in swar_kernel's 16 x 8 threads, 2 x 4 in
    straddle_kernel's 16 x 16)."""
    with open(os.path.join(CSRC, "hamming.cu")) as f:
        src = f.read()
    for kernel, macro in (("swar", "SWAR_TILES"),
                          ("straddle", "STRADDLE_TILES")):
        line = re.search(rf"#define {macro}\(X\) (.*)", src).group(1)
        tiles = tuple((int(a), int(b))
                      for a, b in re.findall(r"X\((\d+), (\d+)\)", line))
        assert tiles == kham.HAMMING_TILES[kernel]
        per = (16, 8) if kernel == "swar" else (16, 16)
        q0, n0 = tiles[0]
        for q, n in tiles:
            assert q % per[0] == 0 and n % per[1] == 0
            assert (q // per[0]) * (n // per[1]) <= \
                (q0 // per[0]) * (n0 // per[1])
    assert kham.default_tile(8) == {"blk_q": 64, "blk_n": 64}
    assert kham.default_tile(9) == {"blk_q": 32, "blk_n": 64}
    assert kmin.MINHASH_BLK_K in kmin.MINHASH_THREADS
    assert koph.OPH_THREADS in koph.OPH_THREAD_CHOICES
    assert set(engine.DEFAULT_BLOCKS) == {"minhash2u", "minhash4u",
                                          "oph2u", "oph4u"}


# ---------------------------------------------------------------------------
# The process-wide table
# ---------------------------------------------------------------------------

def test_env_table_is_honoured(batches, tmp_path, monkeypatch,
                               fresh_default):
    _, tb = batches
    nnz = tb.indices.shape[1]
    table = TuningTable()
    table.record("torch", "minhash2u", 64, nnz, {"threads": 256})
    path = table.save(str(tmp_path / "tab.json"))
    # the reference's variable is not the port's
    monkeypatch.setenv("REPRO_TUNING_TABLE", path)
    assert default_tuning_table().entries == (
        TuningTable.load(str(engine.PACKAGED_TABLE)).entries
        if engine.PACKAGED_TABLE.exists() else {})
    monkeypatch.setattr(engine, "_DEFAULT_TABLE", None)
    monkeypatch.setenv(engine.TABLE_ENV, path)
    assert default_tuning_table().entries == table.entries
    assert default_tuning_table() is default_tuning_table()
    fam = family_from_jax(_family("2u", 64, 10), "cpu")
    assert SignatureEngine(fam).plan_for(nnz).threads == 256
    monkeypatch.setattr(engine, "_DEFAULT_TABLE", None)
    monkeypatch.setenv(engine.TABLE_ENV, str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        default_tuning_table()


def test_packaged_table_holds_only_card_entries(fresh_default):
    """A packaged ``tuning_table.json`` (shipped only with entries measured
    on the card) has no key outside ``cuda/``, and every entry is a shape
    the launchers take; without one the process-wide table is empty."""
    if not engine.PACKAGED_TABLE.exists():
        assert default_tuning_table().entries == {}
        return
    table = default_tuning_table()
    assert table.entries
    for key, blocks in table.entries.items():
        backend, scheme, k, bucket = key.split("/")
        assert backend == "cuda"
        assert re.fullmatch(r"k=\d+", k) and re.fullmatch(r"nnz<=\d+", bucket)
        if scheme == "hamming":
            assert set(blocks) == {"blk_q", "blk_n"}
            assert any((blocks["blk_q"], blocks["blk_n"]) in tiles
                       for tiles in kham.HAMMING_TILES.values())
        else:
            assert scheme in engine.DEFAULT_BLOCKS
            engine.check_blocks(scheme, blocks)


# ---------------------------------------------------------------------------
# IndexSearcher and ShardedIndex
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def index_pair(tmp_path_factory):
    """A JAX-written .sig corpus, built into a .idx by the reference."""
    tmp = str(tmp_path_factory.mktemp("tuning_idx"))
    rng = np.random.default_rng(11)
    sets = [rng.choice(1 << S, int(rng.integers(20, 90)), replace=False)
            for _ in range(208)]
    fam = JOPH.create(jax.random.PRNGKey(12), 128, S, "2u", "rotation")
    words = np.asarray(JEngine(fam, b=8, packed=True).packed_signatures(
        j_from_lists(sets, max_nnz=128)).data)
    paths = []
    for i, (lo, hi) in enumerate(((0, 100), (100, 200))):
        p = os.path.join(tmp, f"c{i}.sig")
        j_write_sig_shard(p, words[lo:hi], np.ones(hi - lo), k=128, b=8,
                          code_bits=8, sentinel=False)
        paths.append(p)
    j_path = os.path.join(tmp, "j.idx")
    j_build_index(paths, j_path, j_choose_band_config(128, 8, threshold=0.5))
    return j_path, words[:200], words[200:]


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_index_searcher_blocks_same_ids(index_pair, mode, fresh_default):
    j_path, words, held = index_pair
    q = np.concatenate([words[[0, 5, 99, 150]], held])
    index = load_index(j_path, device="cpu")
    plain = IndexSearcher(index, device="cpu", corpus_block=64)
    assert plain.blocks == kham.default_tile(8)
    want = JSearcher(j_load_index(j_path), backend="ref",
                     corpus_block=64).search(jnp.asarray(q), 10, mode=mode)
    base = plain.search(q, 10, mode=mode)
    for tq, tn in kham.HAMMING_TILES["swar"]:
        tile = {"blk_q": tq, "blk_n": tn}
        for extra in ({}, {"max_device_bytes": 8 * 1024}):
            got = IndexSearcher(index, device="cpu", corpus_block=64,
                                blocks=tile, **extra)
            assert got.blocks == tile and got.streamed == bool(extra)
            res = got.search(q, 10, mode=mode)
            np.testing.assert_array_equal(res.indices, base.indices)
            np.testing.assert_array_equal(res.scores, base.scores)
            np.testing.assert_array_equal(res.indices, want.indices)
            np.testing.assert_array_equal(res.scores, want.scores)
    with pytest.raises(ValueError, match="is built for tiles"):
        IndexSearcher(index, device="cpu", blocks={"blk_q": 16, "blk_n": 16})
    # the table's entry, resolved once at construction
    default_tuning_table().record("torch", "hamming", 128, index.spec.words,
                                  {"blk_q": 32, "blk_n": 32})
    assert IndexSearcher(index, device="cpu").blocks == \
        {"blk_q": 32, "blk_n": 32}


def test_sharded_index_passes_blocks(index_pair, fresh_default):
    j_path, words, _ = index_pair
    index = load_index(j_path, device="cpu")
    tile = {"blk_q": 32, "blk_n": 64}
    router = ShardedIndex([index, index], device="cpu", corpus_block=64,
                          blocks=tile)
    assert all(s.blocks == tile for s in router.searchers)
    got = router.search(words[:6], 5, mode="exact")
    want = ShardedIndex([index, index], device="cpu",
                        corpus_block=64).search(words[:6], 5, mode="exact")
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
