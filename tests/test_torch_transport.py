"""Port parity for the ``bSHr`` shard transport:

  * ``_pack_msg`` frames byte-identical to the reference's (numpy-seeded
    headers and buffers), and ``_recv_msg`` reads either package's;
  * a router over ``SocketShardClient``s to port ``ShardService``s equals
    the in-process router (exact, LSH, Theorem-1 rerank);
  * a port router whose clients reach the reference's services, and a
    reference router whose clients reach the port's services, equal
    their in-process routers: the two packages talk to each other;
  * garbage, torn frames, bad headers, short buffers and a silent server
    are clean errors, and the service keeps serving.

Every socket binds to port 0; every service is closed by its fixture or
``finally``.
"""

import socket
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import load_sharded as j_load_sharded
from repro.index import transport as jtr
from repro_torch.index import (BandingConfig, IndexSearcher, build_index,
                               build_sharded, load_index, load_sharded)
from repro_torch.index import transport as ttr
from repro_torch.obs import get_registry, get_tracer

from test_torch_index import S, SCORE_ATOL, _sig_corpus

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
    tmp = tmp_path_factory.mktemp("transport")
    paths, words, sizes, held = _sig_corpus(str(tmp), n=240, seed=41,
                                            n_files=4)
    cfg = BandingConfig(*CFG)
    build_sharded(paths, str(tmp / "sh"), cfg, n_shards=3, device="cpu")
    build_sharded(paths, str(tmp / "sz"), cfg, n_shards=2, set_sizes=sizes,
                  s=S, device="cpu")
    build_index(paths, str(tmp / "one.idx"), cfg, device="cpu")
    q = np.concatenate([words[[0, 9, 120, 239]], held])
    return dict(tmp=tmp, words=words, sizes=sizes, q=q)


@pytest.fixture()
def services():
    """Services opened by a test; all closed at its end."""
    opened = []
    yield opened
    for svc in opened:
        svc.close()
        if isinstance(svc, ttr.ShardService):   # the port's close joins
            assert not svc._thread.is_alive()


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pack_msg_frames_byte_identical(seed):
    rng = np.random.default_rng(seed)
    q = int(rng.integers(1, 9))
    arrays = [("qwords", rng.integers(0, 2**32, (q, 32), dtype=np.uint32)),
              ("query_sizes", rng.integers(0, 900, q).astype(np.uint32)),
              ("qkeys", rng.integers(0, 2**32, (q, 32), dtype=np.uint32)),
              ("scores", rng.random((q, 5)).astype(np.float32)),
              ("indices", rng.integers(-1, 999, (q, 5)).astype(np.int64))]
    take = [a for a in arrays if rng.random() < 0.7]
    header = {"kind": "search", "topk": int(rng.integers(1, 20)),
              "mode": ("exact", "lsh")[seed % 2]}
    frame = ttr._pack_msg(header, take)
    assert frame == jtr._pack_msg(header, take)
    assert ttr._pack_msg({"kind": "hello"}) == jtr._pack_msg({"kind": "hello"})
    # the port's tensors go on the wire as the reference's uint32 arrays
    t_take = [(n, torch.from_numpy(a.view(np.int32)) if a.dtype == np.uint32
               else a) for n, a in take]
    assert ttr._pack_msg(header, [(n, ttr._host(a)) for n, a in t_take]) \
        == frame
    a, b = socket.socketpair()
    with a, b:
        a.sendall(frame)
        hdr, bufs = ttr._recv_msg(b)
    assert hdr["kind"] == "search" and list(bufs) == [n for n, _ in take]
    for n, arr in take:
        np.testing.assert_array_equal(bufs[n], arr)


# ---------------------------------------------------------------------------
# Fan-out over sockets
# ---------------------------------------------------------------------------

def _factory(services, make):
    def factory(searcher):
        svc = make(searcher)
        services.append(svc)
        return ttr.SocketShardClient(svc.address, timeout_s=30.0)
    return factory


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_socket_fanout_bit_identical(corpus, services, mode):
    shard_dir = str(corpus["tmp"] / "sh")
    local = load_sharded(shard_dir, device="cpu", corpus_block=64)
    remote = load_sharded(shard_dir, device="cpu", corpus_block=64,
                          client_factory=_factory(services,
                                                  ttr.ShardService))
    assert [c.n for c in remote.clients] == [c.n for c in local.clients]
    want = local.search(corpus["q"], 10, mode=mode)
    got = remote.search(corpus["q"], 10, mode=mode)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
    if mode == "lsh":
        np.testing.assert_array_equal(got.n_candidates, want.n_candidates)
    tickets = [remote.submit(r) for r in corpus["q"][:3]]
    out = remote.flush(10, mode=mode)
    np.testing.assert_array_equal(
        np.concatenate([out[t].indices for t in tickets]),
        want.indices[:3])


def test_socket_set_sizes_rerank(corpus, services):
    shard_dir = str(corpus["tmp"] / "sz")
    q, qs = corpus["words"][:5], corpus["sizes"][:5]
    local = load_sharded(shard_dir, device="cpu", corpus_block=64)
    remote = load_sharded(shard_dir, device="cpu", corpus_block=64,
                          client_factory=_factory(services,
                                                  ttr.ShardService))
    for mode in ("exact", "lsh"):
        want = local.search(q, 5, mode=mode, query_sizes=qs)
        got = remote.search(q, 5, mode=mode, query_sizes=qs)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("mode", ["exact", "lsh"])
def test_port_and_reference_talk_to_each_other(corpus, services, mode):
    """Port clients against the reference's services, and the reference's
    clients against the port's services: the same results as each
    package's in-process router."""
    shard_dir = str(corpus["tmp"] / "sh")
    q = corpus["q"]
    j_local = j_load_sharded(shard_dir, backend="ref", corpus_block=64)
    t_local = load_sharded(shard_dir, device="cpu", corpus_block=64)
    # the reference's searchers behind its services, reached by port clients
    j_services = [jtr.ShardService(s) for s in j_local.searchers]
    services.extend(j_services)
    it = iter(j_services)
    t_over_j = load_sharded(
        shard_dir, device="cpu", corpus_block=64,
        client_factory=lambda s: ttr.SocketShardClient(next(it).address))
    # the port's searchers behind its services, reached by JAX clients
    t_services = [ttr.ShardService(s) for s in t_local.searchers]
    services.extend(t_services)
    it2 = iter(t_services)
    j_over_t = j_load_sharded(
        shard_dir, backend="ref", corpus_block=64,
        client_factory=lambda s: jtr.SocketShardClient(next(it2).address))
    want_t = t_local.search(q, 10, mode=mode)
    want_j = j_local.search(jnp.asarray(q), 10, mode=mode)
    got_t = t_over_j.search(q, 10, mode=mode)
    got_j = j_over_t.search(jnp.asarray(q), 10, mode=mode)
    for got, want in ((got_t, want_t), (got_j, want_j), (want_t, want_j)):
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)
    assert [c.n for c in t_over_j.clients] == [s.index.n for s in
                                               j_local.searchers]


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

def test_service_survives_garbage_and_remote_errors(corpus, services):
    searcher = IndexSearcher(load_index(str(corpus["tmp"] / "one.idx"),
                                        device="cpu"), device="cpu")
    svc = ttr.ShardService(searcher)
    services.append(svc)
    with socket.create_connection(svc.address, timeout=5.0) as s:
        s.sendall(b"\x00" * 64)                 # garbage: dropped
    client = ttr.SocketShardClient(svc.address, timeout_s=5.0)
    q = np.ascontiguousarray(searcher.index.words_host[:2])
    with pytest.raises(ttr.RemoteShardError, match="mode"):
        client.dispatch(q, 5, mode="nonsense")()
    with pytest.raises(ttr.RemoteShardError, match="packed words"):
        client.dispatch(np.zeros((1, 3), np.uint32), 5)()
    got = client.dispatch(q, 5)()
    want = searcher.dispatch(q, 5)()
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert client.n == searcher.index.n


def _fake_server(handler):
    """One-connection fake shard server running ``handler(conn)``; joined
    by the returned ``stop``."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        with conn:
            handler(conn)

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop():
        srv.close()
        t.join(timeout=10)
        assert not t.is_alive()
    return srv.getsockname(), stop


def _drain_request(conn):
    conn.settimeout(5.0)
    try:
        conn.recv(1 << 20)
    except OSError:
        pass


def _short_buffer(conn):
    _drain_request(conn)
    hdr = b'{"kind": "result", "arrays": [["indices", "<i8", [4, 10]]]}'
    payload = struct.pack("<I", len(hdr)) + hdr + b"\x00" * 16
    conn.sendall(ttr._MAGIC + struct.pack("<I", len(payload)) + payload)


def _torn(conn):
    full = ttr._pack_msg({"kind": "result"},
                         [("indices", np.zeros((1, 5), np.int64)),
                          ("scores", np.zeros((1, 5), np.float32))])
    _drain_request(conn)
    conn.sendall(full[:len(full) // 2])


def _bad_magic(conn):
    _drain_request(conn)
    conn.sendall(b"XXXX" + struct.pack("<I", 4) + b"junk")


def _bad_header(conn):
    _drain_request(conn)
    payload = struct.pack("<I", 8) + b"\xff" * 8
    conn.sendall(ttr._MAGIC + struct.pack("<I", len(payload)) + payload)


@pytest.mark.parametrize("handler,match", [
    (_torn, "mid-frame"), (_bad_magic, "magic"), (_bad_header, "corrupt"),
    (_short_buffer, "truncated")])
def test_bad_replies_are_clean_transport_errors(handler, match):
    addr, stop = _fake_server(handler)
    try:
        harvest = ttr.SocketShardClient(addr, timeout_s=5.0).dispatch(
            np.zeros((1, 4), np.uint32), 5)
        with pytest.raises(ttr.TransportError, match=match):
            harvest()
    finally:
        stop()


def test_unresponsive_server_times_out():
    release = threading.Event()

    def silent(conn):
        _drain_request(conn)
        release.wait(10.0)

    addr, stop = _fake_server(silent)
    try:
        harvest = ttr.SocketShardClient(addr, timeout_s=0.2).dispatch(
            np.zeros((1, 4), np.uint32), 5)
        with pytest.raises(OSError):
            harvest()
    finally:
        release.set()
        stop()


def test_loopback_factory_owns_its_services(corpus):
    fac = ttr.loopback_client_factory(timeout_s=10.0)
    try:
        router = load_sharded(str(corpus["tmp"] / "sh"), device="cpu",
                              client_factory=fac)
        assert len(fac.services) == len(fac.clients) == router.n_shards
        res = router.search(corpus["q"][:2], 3)
        assert res.indices.shape == (2, 3)
    finally:
        fac.close()
    assert not any(svc._thread.is_alive() for svc in fac.services)


def test_socket_scores_within_reference_tolerance_with_sizes(corpus,
                                                             services):
    """With set sizes the port's Theorem-1 scores agree with the
    reference's to the stated 1e-6 (XLA's float32 expm1), over sockets."""
    shard_dir = str(corpus["tmp"] / "sz")
    q, qs = corpus["words"][:5], corpus["sizes"][:5]
    remote = load_sharded(shard_dir, device="cpu", corpus_block=64,
                          client_factory=_factory(services,
                                                  ttr.ShardService))
    ref = j_load_sharded(shard_dir, backend="ref", corpus_block=64)
    got = remote.search(q, 5, mode="exact", query_sizes=qs)
    want = ref.search(jnp.asarray(q), 5, mode="exact", query_sizes=qs)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0,
                               atol=SCORE_ATOL)
