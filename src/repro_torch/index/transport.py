"""Loopback-TCP shard transport: the real ``ShardClient`` seam (port of
``repro.index.transport``; the ``bSHr`` frames are byte-identical, so a
client of either package talks to a service of the other).

``ShardService`` puts one shard's ``IndexSearcher`` behind a socket
server speaking length-prefixed binary frames; ``SocketShardClient``
is the matching ``ShardClient`` -- plug-compatible with
``LocalShardClient`` via ``ShardedIndex(client_factory=...)`` and
bit-identical to it (the wire carries the exact numpy buffers a local
dispatch would return).

Wire format (all integers little-endian):

    frame   := magic(4) | payload_len(u32) | payload
    payload := header_len(u32) | header(JSON, utf-8) | array bytes...

The JSON header carries ``kind`` plus scalar fields, and an ``arrays``
list of ``[name, dtype, shape]`` entries describing the raw buffers
concatenated after it (C order, in list order).  Requests are
``hello`` (returns the shard's doc count -- backs ``client.n``) and
``search`` (qwords / optional query_sizes / optional qkeys + topk +
mode, answered with a ``result`` frame holding the ``SearchResult``
buffers, or an ``error`` frame).  Anything malformed -- bad magic,
truncated frame, undecodable header, short buffers -- raises
``TransportError`` client-side (an ``OSError``, so retry policies
treat it like any other I/O fault) and is answered/ignored
server-side without killing the service.

Each ``dispatch`` uses its own connection: concurrent server workers
share ``ShardClient`` instances, and per-dispatch sockets make
timeouts, cancellation, and injected connection drops independent
per in-flight query.

On the card: ``SocketShardClient`` moves the query words to the host once
per dispatch (the wire carries uint32 numpy buffers); ``ShardService``
scores on its searcher's device, each connection on a CUDA stream of its
own, and sends numpy.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.index.query import SearchResult
from repro_torch.index.router import ShardClient

__all__ = ["ShardService", "SocketShardClient", "TransportError",
           "loopback_client_factory"]

_MAGIC = b"bSHr"
_HDR = struct.Struct("<4sI")
_MAX_FRAME = 1 << 30


class TransportError(OSError):
    """A torn, truncated, or corrupt transport frame (retryable)."""


# -- framing ------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def _pack_msg(header: dict, arrays=()) -> bytes:
    """header dict + named numpy buffers -> one wire frame."""
    meta = []
    bufs = []
    for name, arr in arrays:
        arr = np.ascontiguousarray(arr)
        meta.append([name, arr.dtype.str, list(arr.shape)])
        bufs.append(arr.tobytes())
    header = dict(header, arrays=meta)
    hdr = json.dumps(header).encode("utf-8")
    payload = struct.pack("<I", len(hdr)) + hdr + b"".join(bufs)
    return _HDR.pack(_MAGIC, len(payload)) + payload


def _send_msg(sock: socket.socket, header: dict, arrays=()) -> None:
    sock.sendall(_pack_msg(header, arrays))


def _recv_msg(sock: socket.socket) -> Tuple[dict, dict]:
    """Read one frame -> (header, {name: ndarray}).  TransportError on
    bad magic / truncation / corrupt header / short buffers."""
    magic, n = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise TransportError(f"bad frame magic {magic!r}")
    if n > _MAX_FRAME:
        raise TransportError(f"frame length {n} exceeds limit")
    payload = _recv_exact(sock, n)
    if len(payload) < 4:
        raise TransportError("frame too short for header length")
    (hlen,) = struct.unpack_from("<I", payload)
    if 4 + hlen > len(payload):
        raise TransportError("header length exceeds frame")
    try:
        header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportError(f"corrupt frame header: {e}") from e
    if not isinstance(header, dict):
        raise TransportError("frame header is not an object")
    arrays = {}
    off = 4 + hlen
    for entry in header.get("arrays", ()):
        try:
            name, dtype, shape = entry
            nbytes = int(np.dtype(dtype).itemsize * int(np.prod(shape)))
        except (TypeError, ValueError) as e:
            raise TransportError(f"corrupt array descriptor: {e}") from e
        if off + nbytes > len(payload):
            raise TransportError(
                f"array {name!r} truncated ({len(payload) - off}/{nbytes} "
                "bytes)")
        arrays[name] = np.frombuffer(
            payload, dtype, count=int(np.prod(shape)),
            offset=off).reshape(shape)
        off += nbytes
    return header, arrays


def _host(x) -> np.ndarray:
    """A wire buffer: int32 bit-pattern tensors go as uint32, the way the
    reference sends its uint32 arrays."""
    if isinstance(x, torch.Tensor):
        return u32.to_numpy(x) if x.dtype == torch.int32 else \
            x.detach().cpu().numpy()
    return np.asarray(x)


# -- server -------------------------------------------------------------

class ShardService:
    """One shard's searcher behind a loopback-TCP frame server.

    Per-connection handler threads; a malformed request gets an
    ``error`` frame (when the stream is still framed) or drops the
    connection, and the service keeps serving.  ``close()`` stops the
    accept loop, closes the listener and joins the loop.
    """

    def __init__(self, searcher, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.searcher = searcher
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"shard-service-{self.address[1]}")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                      # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        dev = self.searcher.device
        if dev.type == "cuda":
            # handler threads would all share the default stream
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                self._serve_frames(conn)
        else:
            self._serve_frames(conn)

    def _serve_frames(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    header, arrays = _recv_msg(conn)
                except TransportError as e:
                    # Malformed stream: best-effort error frame, then
                    # drop the connection (framing is unrecoverable).
                    if str(e).startswith("connection closed mid-frame (0/"):
                        return              # clean EOF between frames
                    try:
                        _send_msg(conn, {"kind": "error",
                                         "error": str(e)})
                    except OSError:
                        pass
                    return
                except OSError:
                    return
                try:
                    reply, bufs = self._handle(header, arrays)
                except Exception as e:      # searcher-side failure
                    reply, bufs = {"kind": "error",
                                   "error": f"{type(e).__name__}: {e}"}, ()
                try:
                    _send_msg(conn, reply, bufs)
                except OSError:
                    return

    def _handle(self, header: dict, arrays: dict):
        kind = header.get("kind")
        if kind == "hello":
            return {"kind": "hello_ok", "n": int(self.searcher.index.n)}, ()
        if kind != "search":
            raise ValueError(f"unknown request kind {kind!r}")
        if "qwords" not in arrays:
            raise ValueError("search request missing qwords")
        res = self.searcher.dispatch(
            arrays["qwords"], int(header["topk"]),
            mode=header.get("mode", "exact"),
            query_sizes=arrays.get("query_sizes"),
            qkeys=arrays.get("qkeys"))()
        out = [("indices", np.asarray(res.indices)),
               ("scores", np.asarray(res.scores))]
        if res.n_candidates is not None:
            out.append(("n_candidates", np.asarray(res.n_candidates)))
        return {"kind": "result"}, out

    def close(self) -> None:
        """Stop accepting and join the accept loop (``shutdown`` wakes the
        blocked ``accept``; a bare ``close`` does not on Linux).  Open
        connections end when their clients close them."""
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)


# -- client -------------------------------------------------------------

class SocketShardClient(ShardClient):
    """``ShardClient`` over a ``ShardService`` address.

    ``dispatch`` writes the request on a fresh connection immediately
    and returns a harvest closure that blocks on the reply -- the
    server computes while the caller fans out to other shards, same
    overlap the local client gets from ``IndexSearcher.dispatch``.
    ``timeout_s`` bounds every socket op (connect/send/recv); an
    expired timeout surfaces as ``socket.timeout`` (a ``TimeoutError``
    / ``OSError``), never a hang.
    """

    def __init__(self, address: Tuple[str, int], *,
                 timeout_s: Optional[float] = 30.0):
        self.address = (address[0], int(address[1]))
        self.timeout_s = timeout_s
        self._n: Optional[int] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address,
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _roundtrip(self, header: dict, arrays=()) -> Tuple[dict, dict]:
        with self._connect() as sock:
            _send_msg(sock, header, arrays)
            reply, bufs = _recv_msg(sock)
        if reply.get("kind") == "error":
            raise RemoteShardError(reply.get("error", "unknown shard error"))
        return reply, bufs

    @property
    def n(self) -> int:
        if self._n is None:
            reply, _ = self._roundtrip({"kind": "hello"})
            if reply.get("kind") != "hello_ok":
                raise TransportError(
                    f"unexpected hello reply {reply.get('kind')!r}")
            self._n = int(reply["n"])
        return self._n

    def dispatch(self, qwords, topk: int, *, mode: str = "exact",
                 query_sizes=None,
                 qkeys=None) -> Callable[[], SearchResult]:
        arrays = [("qwords", _host(qwords))]
        if query_sizes is not None:
            arrays.append(("query_sizes", _host(query_sizes)))
        if qkeys is not None:
            arrays.append(("qkeys", _host(qkeys)))
        sock = self._connect()
        try:
            _send_msg(sock, {"kind": "search", "topk": int(topk),
                             "mode": mode}, arrays)
        except BaseException:
            sock.close()
            raise

        def harvest() -> SearchResult:
            try:
                reply, bufs = _recv_msg(sock)
            finally:
                sock.close()
            if reply.get("kind") == "error":
                raise RemoteShardError(
                    reply.get("error", "unknown shard error"))
            if reply.get("kind") != "result":
                raise TransportError(
                    f"unexpected reply kind {reply.get('kind')!r}")
            if "indices" not in bufs or "scores" not in bufs:
                raise TransportError("result frame missing buffers")
            return SearchResult(bufs["indices"], bufs["scores"],
                                bufs.get("n_candidates"))
        return harvest


class RemoteShardError(RuntimeError):
    """The shard executed the request and failed (not a wire fault, so
    resilience policies do not retry it by default)."""


def loopback_client_factory(*, timeout_s: Optional[float] = 30.0):
    """A ``client_factory=`` that spins up one ``ShardService`` per
    shard searcher and returns ``SocketShardClient``s to them.

    The factory object keeps ``.services`` / ``.clients`` lists and a
    ``.close()`` that tears all services down (tests/benchmarks own
    the lifecycle; services are daemon threads either way).
    """
    def factory(searcher) -> SocketShardClient:
        svc = ShardService(searcher)
        client = SocketShardClient(svc.address, timeout_s=timeout_s)
        factory.services.append(svc)
        factory.clients.append(client)
        return client

    factory.services = []
    factory.clients = []
    factory.close = lambda: [svc.close() for svc in factory.services]
    return factory
