"""Port parity for retrieval (``repro_torch.index``, ``core/estimator``):
the JAX package against the port on the same JAX-written ``.sig`` shards.

  * Theorem-1 constants: within a relative 1e-5 of the reference.  Both
    compute in float32 with the same operations, but ``log1p`` / ``exp``
    / ``expm1`` come from different math libraries: XLA's float32
    ``expm1`` on the CPU is up to 4 ulps from the correctly rounded value
    (PyTorch's is within 1), and the powers (1 - r)^(2^b) and the
    differences of the formula magnify that to ~8e-6 relative at worst
    (measured over b = 1..16, D = 2^16..2^30).
  * band keys, ``choose_band_config``: bit-identical, sentinel included.
  * ``.idx`` files: byte-identical; a JAX-built ``.idx`` loads in the
    port and searches the same; raw shards through each package's
    preprocess -> build -> search (coefficients handed over with
    ``family_from_jax``) give the same bytes and results.
  * ``IndexSearcher``: exact and LSH ids and scores bit-identical on
    sparse-limit and sentinel wires and on tie-heavy corpora (duplicated
    rows).  With set sizes (Theorem-1 rerank) scores agree to an absolute
    1e-6 (the constants' error, at most ~2e-8 here, passed through
    (p - C1) / (1 - C2)), and ids are equal wherever neighbouring scores
    are further apart than 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core.oph import OPH as JOPH
from repro.data.pipeline import make_sharded_dataset as j_make_sharded
from repro.data.preprocess import preprocess_shards as j_preprocess
from repro.data.synthetic import DatasetSpec as JDatasetSpec
from repro.data.sigshard import write_sig_shard as j_write_sig_shard
from repro.data.sparse import from_lists as j_from_lists
from repro.index import IndexSearcher as JSearcher
from repro.index import band_keys_from_codes as j_band_keys_from_codes
from repro.index import band_keys_packed as j_band_keys_packed
from repro.index import build_index as j_build_index
from repro.index import choose_band_config as j_choose_band_config
from repro.index import load_index as j_load_index
from repro.index import s_curve as j_s_curve
from repro.kernels import SignatureEngine as JEngine
from repro.kernels.pack import PackSpec as JPackSpec
from repro_torch.convert import family_from_jax
from repro_torch.core import estimator as test
from repro_torch.data.preprocess import preprocess_shards as t_preprocess
from repro_torch.core.u32 import from_numpy, to_numpy
from repro_torch.index import (BandingConfig, IndexSearcher,
                               band_keys_from_codes, band_keys_packed,
                               build_index, build_sharded,
                               choose_band_config, load_index,
                               read_index_meta, s_curve)
from repro_torch.kernels import PackedSignatures
from repro_torch.kernels.pack import PackSpec

K, S = 128, 16
RTOL_C = 1e-5             # Theorem-1 constants: math-library rounding
SCORE_ATOL = 1e-6         # scores of the Theorem-1 rerank


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and this module's plain-version compares would otherwise take every
    core from the timing-sensitive tests running beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sets(rng, n, dup):
    sets = [rng.choice(1 << S, int(rng.integers(20, 90)), replace=False)
            for _ in range(n)]
    if dup:                              # tie-heavy: 17 distinct rows
        sets = [sets[i % 17] for i in range(n)]
    return sets


def _wire(sets, densify, b, seed):
    fam = JOPH.create(jax.random.PRNGKey(seed), K, S, "2u", densify)
    return JEngine(fam, b=b, packed=True).packed_signatures(
        j_from_lists(sets, max_nnz=128))


def _sig_corpus(tmp, *, densify="rotation", b=8, n=240, dup=False, seed=0,
                n_files=3):
    """JAX-written ``.sig`` shards of a synthetic corpus, the packed
    words, the set sizes and held-out query words."""
    rng = np.random.default_rng(seed)
    sets = _sets(rng, n, dup)
    wire = _wire(sets + _sets(rng, 8, False), densify, b, seed)
    words = np.asarray(wire.data)
    spec = wire.spec
    cut = np.linspace(0, n, n_files + 1).astype(int)
    paths = []
    for i, (lo, hi) in enumerate(zip(cut[:-1], cut[1:])):
        p = os.path.join(tmp, f"c{i}.sig")
        j_write_sig_shard(p, words[lo:hi], np.sign(rng.random(hi - lo) - .5),
                          k=K, b=b, code_bits=spec.code_bits,
                          sentinel=spec.sentinel)
        paths.append(p)
    sizes = np.array([len(s) for s in sets], np.uint32)
    return paths, words[:n], sizes, words[n:]


CORPORA = {
    "rotation": dict(densify="rotation"),
    "sentinel": dict(densify="sentinel"),
    "ties": dict(densify="rotation", dup=True),
    "b4": dict(densify="rotation", b=4),
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def built(request, tmp_path_factory):
    """One corpus built into a .idx by each package."""
    kw = CORPORA[request.param]
    tmp = str(tmp_path_factory.mktemp(request.param))
    paths, words, sizes, held = _sig_corpus(tmp, **kw)
    b = kw.get("b", 8)
    code_bits = b + 1 if kw["densify"] == "sentinel" else b
    cfg = choose_band_config(K, b, code_bits=code_bits, threshold=0.5)
    j_cfg = j_choose_band_config(K, b, code_bits=code_bits, threshold=0.5)
    j_path, t_path = os.path.join(tmp, "j.idx"), os.path.join(tmp, "t.idx")
    j_build_index(paths, j_path, j_cfg)
    build_index(paths, t_path, cfg, device="cpu")
    return dict(name=request.param, paths=paths, words=words, sizes=sizes,
                held=held, cfg=cfg, j_path=j_path, t_path=t_path, b=b)


def _queries(c):
    n = c["words"].shape[0]
    picks = [0, 3, 17, n // 2, n - 1]
    return np.concatenate([c["words"][picks], c["held"]])


# ---------------------------------------------------------------------------
# Estimator and banding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 4, 8])
def test_theorem1_constants_match_reference(b):
    rng = np.random.default_rng(b)
    f1 = rng.integers(0, 5000, 64).astype(np.uint32)
    f2 = rng.integers(0, 5000, 64).astype(np.uint32)
    for D in (1 << 16, 1 << 30):
        jc = jest.bbit_constants(jnp.asarray(f1), jnp.asarray(f2), D, b)
        tc = test.bbit_constants(torch.from_numpy(f1.astype(np.int64)),
                                 torch.from_numpy(f2.astype(np.int64)), D, b)
        for j, t in zip(jc, tc):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=RTOL_C, atol=0)
    R = rng.random(64).astype(np.float32)
    np.testing.assert_allclose(
        test.collision_prob(torch.from_numpy(R), 300, 500, 1 << 16,
                            b).numpy(),
        np.asarray(jest.collision_prob(jnp.asarray(R), 300, 500, 1 << 16, b)),
        rtol=RTOL_C, atol=0)
    np.testing.assert_allclose(
        test.estimate_resemblance(torch.from_numpy(R), 300, 500, 1 << 16,
                                  b).numpy(),
        np.asarray(jest.estimate_resemblance(jnp.asarray(R), 300, 500,
                                             1 << 16, b)),
        rtol=RTOL_C, atol=SCORE_ATOL)


@pytest.mark.parametrize("b,sentinel", [(8, False), (8, True), (4, False),
                                        (1, True), (16, False)])
def test_band_keys_bit_identical(b, sentinel):
    rng = np.random.default_rng(b + sentinel)
    spec, jspec = PackSpec(K, b, sentinel), JPackSpec(K, b, sentinel)
    words = rng.integers(0, 2**32, (37, spec.words), dtype=np.uint32)
    if sentinel:           # valid codes only: <= 2^b, EMPTY among them
        codes = rng.integers(0, (1 << b) + 1, (37, K)).astype(np.uint32)
        from repro.core.bbit import pack_codes
        words = np.asarray(pack_codes(jnp.asarray(codes), spec.code_bits))
    for threshold in (0.3, 0.5, 0.8):
        cfg = choose_band_config(K, b, code_bits=spec.code_bits,
                                 threshold=threshold)
        j_cfg = j_choose_band_config(K, b, code_bits=spec.code_bits,
                                     threshold=threshold)
        assert (cfg.n_bands, cfg.rows_per_band, cfg.code_bits) == \
            (j_cfg.n_bands, j_cfg.rows_per_band, j_cfg.code_bits)
        got = band_keys_packed(from_numpy(words, "cpu"), spec, cfg)
        want = j_band_keys_packed(jnp.asarray(words), jspec, j_cfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    assert s_curve(0.6, 32, 4) == j_s_curve(0.6, 32, 4)


def test_band_keys_from_codes_and_config_errors():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2**32, (9, 40), dtype=np.uint32)
    for cb, r in ((32, 1), (8, 4), (9, 3), (1, 32)):
        cfg = BandingConfig(40 // r, r, cb)
        from repro.index import BandingConfig as JBanding
        want = j_band_keys_from_codes(jnp.asarray(codes), JBanding(
            40 // r, r, cb))
        got = band_keys_from_codes(from_numpy(codes, "cpu"), cfg)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    with pytest.raises(ValueError):
        BandingConfig(4, 5, 8)                  # 40-bit keys
    with pytest.raises(ValueError):
        band_keys_from_codes(from_numpy(codes, "cpu"), BandingConfig(50, 1, 8))


# ---------------------------------------------------------------------------
# .idx files
# ---------------------------------------------------------------------------

def test_idx_byte_identical(built):
    with open(built["j_path"], "rb") as f:
        want = f.read()
    with open(built["t_path"], "rb") as f:
        got = f.read()
    assert len(got) == len(want) and got == want
    meta = read_index_meta(built["t_path"])
    assert meta.n == built["words"].shape[0]


@pytest.mark.parametrize("sentinel", [False, True])
def test_idx_with_set_sizes_byte_identical(tmp_path, sentinel):
    paths, _, sizes, _ = _sig_corpus(
        str(tmp_path), densify="sentinel" if sentinel else "rotation",
        n=90, seed=4)
    cb = 9 if sentinel else 8
    cfg = BandingConfig(16, 2, cb)
    from repro.index import BandingConfig as JBanding
    j_build_index(paths, str(tmp_path / "j.idx"), JBanding(16, 2, cb),
                  set_sizes=sizes, s=S)
    meta = build_index(paths, str(tmp_path / "t.idx"), cfg, set_sizes=sizes,
                       s=S, device="cpu")
    assert meta.has_set_sizes and meta.s == S
    assert (tmp_path / "t.idx").read_bytes() == \
        (tmp_path / "j.idx").read_bytes()
    index = load_index(str(tmp_path / "t.idx"), device="cpu")
    np.testing.assert_array_equal(index.set_sizes, sizes)
    with pytest.raises(ValueError, match="set_sizes"):
        build_index(paths, str(tmp_path / "x.idx"), cfg, set_sizes=sizes[1:],
                    device="cpu")


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_search_bit_identical_to_reference(built, mode):
    """The port, serving the JAX-built .idx, returns the reference's ids
    and scores bit for bit (exact over 64-row blocks, so the running
    top-k merge runs; LSH over the candidate union)."""
    q = _queries(built)
    want_s = JSearcher(j_load_index(built["j_path"]), backend="ref",
                       corpus_block=64)
    got_s = IndexSearcher(load_index(built["j_path"], device="cpu"),
                          device="cpu", corpus_block=64)
    for topk in (1, 10, 300):            # 300 > n: padded with -1 / -inf
        want = want_s.search(jnp.asarray(q), topk, mode=mode)
        got = got_s.search(q, topk, mode=mode)
        assert got.indices.dtype == np.int64 and got.indices.shape == \
            (q.shape[0], topk)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)
        if mode == "lsh":
            np.testing.assert_array_equal(got.n_candidates,
                                          want.n_candidates)
    # corpus rows find themselves first (ties resolve to the lowest id)
    res = got_s.search(q[:5], 3, mode=mode)
    n = built["words"].shape[0]
    first = [0, 3, 17, n // 2, n - 1]
    if built["name"] == "ties":
        first = [i % 17 for i in first]
    np.testing.assert_array_equal(res.indices[:, 0], first)


def test_candidates_match_reference(built):
    """LSH candidate unions from the mmap'd bucket tables, per query and
    batched, equal the reference's."""
    q = _queries(built)
    spec, cfg = PackSpec(K, built["b"], built["name"] == "sentinel"), \
        built["cfg"]
    keys = to_numpy(band_keys_packed(from_numpy(q, "cpu"), spec, cfg))
    index = load_index(built["t_path"], device="cpu")
    j_index = j_load_index(built["j_path"])
    got = index.candidates_batch(keys)
    want = j_index.candidates_batch(keys)
    assert len(got) == len(want) == q.shape[0]
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(index.candidates(keys[0]), got[0])
    assert got[0].size and got[0][0] == 0      # query 0 is corpus row 0


def test_search_of_jax_pallas_scan_on_own_index(built):
    """The port's own .idx, searched by the port, against the reference's
    fused scan running the Pallas kernel in interpret mode."""
    q = _queries(built)[:6]
    want = JSearcher(j_load_index(built["t_path"]), backend="interpret",
                     corpus_block=128).search(jnp.asarray(q), 10)
    got = IndexSearcher(load_index(built["t_path"], device="cpu"),
                        device="cpu", corpus_block=128).search(q, 10)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_theorem1_rerank_with_set_sizes(tmp_path, mode):
    paths, words, sizes, held = _sig_corpus(str(tmp_path), n=150, seed=6)
    from repro.index import BandingConfig as JBanding
    j_build_index(paths, str(tmp_path / "j.idx"), JBanding(32, 2, 8),
                  set_sizes=sizes, s=S)
    q = np.concatenate([words[[1, 40, 149]], held])
    q_sizes = np.concatenate([sizes[[1, 40, 149]],
                              np.full(len(held), 50, np.uint32)])
    want = JSearcher(j_load_index(str(tmp_path / "j.idx")), backend="ref",
                     corpus_block=64).search(jnp.asarray(q), 10, mode=mode,
                                             query_sizes=q_sizes)
    searcher = IndexSearcher(load_index(str(tmp_path / "j.idx"),
                                        device="cpu"),
                             device="cpu", corpus_block=64)
    got = searcher.search(q, 10, mode=mode, query_sizes=q_sizes)
    finite = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), finite)
    np.testing.assert_allclose(got.scores[finite], want.scores[finite],
                               rtol=0, atol=SCORE_ATOL)
    # ids agree wherever the neighbouring scores are apart by more than
    # the tolerance (a closer pair may legitimately swap)
    with np.errstate(invalid="ignore"):          # -inf - -inf padding
        gap = np.abs(np.diff(want.scores, axis=1,
                             prepend=np.inf, append=-np.inf))
    sep = np.minimum(gap[:, :-1], gap[:, 1:]) > 1e-5
    np.testing.assert_array_equal(got.indices[sep], want.indices[sep])
    assert np.array_equal(got.indices[:3, 0], [1, 40, 149])
    with pytest.raises(ValueError, match="query_sizes"):
        searcher.search(q, 10, mode=mode)


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_submit_flush_equals_search(built, mode):
    index = load_index(built["t_path"], device="cpu")
    searcher = IndexSearcher(index, device="cpu", corpus_block=100)
    q = _queries(built)
    want = searcher.search(q, 7, mode=mode)
    spec = index.spec
    rows = [q[0], from_numpy(q[1:2], "cpu"),
            PackedSignatures(from_numpy(q[2:3], "cpu"), spec.k, spec.b,
                             spec.sentinel)] + list(q[3:])
    tickets = [searcher.submit(r) for r in rows]
    out = searcher.flush(7, mode=mode)
    assert sorted(out) == tickets
    got = np.concatenate([out[t].indices for t in tickets])
    np.testing.assert_array_equal(got, want.indices)
    np.testing.assert_array_equal(
        np.concatenate([out[t].scores for t in tickets]), want.scores)
    assert searcher.flush() == {}
    with pytest.raises(ValueError, match="one query row"):
        searcher.submit(PackedSignatures(from_numpy(q[:2], "cpu"), spec.k,
                                         spec.b, spec.sentinel))
    with pytest.raises(ValueError, match="packed words"):
        searcher.submit(q[:2])
    with pytest.raises(ValueError):
        searcher.search(q[:, :-1], 5, mode=mode)
    with pytest.raises(ValueError):
        searcher.search(q, 0, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        searcher.search(q, 5, mode="dense")


def test_entry_points_need_cuda_unless_cpu(built, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = load_index(built["t_path"], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexSearcher(index)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IndexSearcher(index, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(built["t_path"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(built["paths"], built["t_path"] + ".x", built["cfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sharded(built["paths"], built["t_path"] + ".d", built["cfg"],
                      n_shards=2)
    assert index.corpus.device.type == "cpu"
    assert index.corpus.dtype == torch.int32


@pytest.mark.parametrize("densify", ["rotation", "sentinel"])
def test_slice_end_to_end_matches_reference(tmp_path, densify):
    """The slice as a whole: the same raw shards and hash coefficients
    (handed over with ``family_from_jax``) through each package's
    preprocess -> build -> load -> search give byte-identical ``.idx``
    files and identical exact and LSH results."""
    spec = JDatasetSpec("slice", n=300, D=1 << S, avg_nnz=48,
                        n_prototypes=4, overlap=0.8, seed=21)
    raw = j_make_sharded(spec, str(tmp_path / "raw"), n_shards=3)
    jfam = JOPH.create(jax.random.PRNGKey(3), K, S, "2u", densify)
    code_bits = 9 if densify == "sentinel" else 8
    cfg = choose_band_config(K, 8, code_bits=code_bits)
    from repro.index import BandingConfig as JBanding
    j_cfg = JBanding(cfg.n_bands, cfg.rows_per_band, cfg.code_bits)
    paths = {}
    for who, prep in (("j", j_preprocess), ("t", t_preprocess)):
        fam = jfam if who == "j" else family_from_jax(jfam, "cpu")
        prep(raw, str(tmp_path / f"sig_{who}"), fam, b=8, chunk_size=100,
             loader_kwargs={"lane_multiple": 8})
        paths[who] = sorted(str(p) for p in (tmp_path / f"sig_{who}").iterdir())
    j_build_index(paths["j"], str(tmp_path / "j.idx"), j_cfg)
    build_index(paths["t"], str(tmp_path / "t.idx"), cfg, device="cpu")
    assert (tmp_path / "t.idx").read_bytes() == \
        (tmp_path / "j.idx").read_bytes()
    index = load_index(str(tmp_path / "t.idx"), device="cpu")
    q = np.asarray(index.words_host[[0, 50, 150, 239]])
    want = JSearcher(j_load_index(str(tmp_path / "j.idx")), backend="ref",
                     corpus_block=64)
    got = IndexSearcher(index, device="cpu", corpus_block=64)
    for mode in ("exact", "lsh"):
        w, g = want.search(jnp.asarray(q), 5, mode=mode), \
            got.search(q, 5, mode=mode)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.indices[:, 0], [0, 50, 150, 239])
