"""``mvfs://`` — a socket-served remote filesystem scheme (port of
``multiverso_tpu/io/mvfs.py``; the protocol is the JAX package's, so a
client of either package reaches a server of either package).

Reference capability (not copied): the second registered Stream scheme was
``hdfs://`` — remote storage reached over the network through libhdfs
(``src/io/hdfs_stream.cpp:7-157``), proving ``StreamFactory`` is a real
dispatch seam, compile-gated behind MULTIVERSO_USE_HDFS.

Design: no HDFS is assumed (and cloud egress is a deployment property),
so the remote scheme is self-hosted: ``MvfsServer``
exports a local directory over TCP with the same framed length-prefixed
protocol shape the runtime's host wire uses, and ``MvfsStream`` is the
client-side ``Stream``. Writes land in a server-side temp file and commit
with an atomic rename on close — the same crash-safety contract the local
checkpoint driver uses. A ``MvfsFileSystem`` exposes the directory
operations (exists / replace / makedirs / listdir) so ``CheckpointDriver``
can snapshot THROUGH the scheme, not just open streams on it.

Protocol: one request/reply pair per operation. Frame =
``uint32 header_len | header json | uint64 payload_len | payload bytes``.
Ops: open_r, read, open_w, write, close_r/close_w (commit), exists,
replace, makedirs, listdir, remove.

Example::

    server = MvfsServer(root="/data/ckpt")
    endpoint = server.serve("0.0.0.0:0")          # host:port
    # elsewhere (any process with TCP reach):
    with get_stream(f"mvfs://{endpoint}/run1/t0.mvckpt", "w") as s:
        s.write(payload)
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
from typing import Any, Dict, Optional, Tuple

from multiverso_tpu_torch import log
from multiverso_tpu_torch.io import FileSystem, Stream, URI, register_fs, register_scheme

_HDR = struct.Struct("<I")
_PAY = struct.Struct("<Q")
_tmp_ids = itertools.count()  # unique temp-file suffixes, server-wide


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mvfs: peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _send(sock: socket.socket, header: Dict[str, Any],
          payload: bytes = b"") -> None:
    head = json.dumps(header).encode()
    sock.sendall(_HDR.pack(len(head)) + head + _PAY.pack(len(payload))
                 + payload)


def _recv(sock: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    (hlen,) = _HDR.unpack(_read_exact(sock, _HDR.size))
    header = json.loads(_read_exact(sock, hlen).decode())
    (plen,) = _PAY.unpack(_read_exact(sock, _PAY.size))
    payload = _read_exact(sock, plen) if plen else b""
    return header, payload


class MvfsServer:
    """Serves a local root directory to remote MvfsStream clients."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._sock: Optional[socket.socket] = None
        self._threads: list = []
        self._live_conns: set = set()
        self._conns_lock = threading.Lock()
        self._active = False
        self.endpoint = ""

    # -- lifecycle -----------------------------------------------------------
    def serve(self, endpoint: str = "127.0.0.1:0") -> str:
        host, _, port = endpoint.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(16)
        self._active = True
        self.endpoint = f"{host or '127.0.0.1'}:{self._sock.getsockname()[1]}"
        accept = threading.Thread(target=self._accept_loop,
                                  name="mvfs-accept", daemon=True)
        accept.start()
        self._threads.append(accept)
        return self.endpoint

    def stop(self) -> None:
        """Take the export offline: stop accepting AND sever established
        connections (a stopped server must not keep mutating the root
        through old sockets)."""
        self._active = False
        if self._sock is not None:
            try:
                # shutdown BEFORE close: a thread blocked in accept() holds
                # the open file description, keeping the port bound after
                # close(); shutdown wakes it so the port actually frees
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        with self._conns_lock:
            live = list(self._live_conns)
        for conn in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "MvfsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals -------------------------------------------------------------
    def _resolve(self, path: str) -> str:
        """Map a request path under the exported root; reject escapes."""
        full = os.path.abspath(os.path.join(self.root, path.lstrip("/")))
        if not (full == self.root or full.startswith(self.root + os.sep)):
            raise PermissionError(f"path escapes export root: {path}")
        return full

    def _accept_loop(self) -> None:
        while self._active and self._sock is not None:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # daemon threads self-terminate on disconnect; not retained (a
            # long-lived server would otherwise grow a dead-Thread list)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="mvfs-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # per-connection open handles: id -> (file object, temp path or None)
        handles: Dict[int, Tuple[Any, Optional[str]]] = {}
        next_id = 0
        with self._conns_lock:
            if not self._active:
                conn.close()
                return
            self._live_conns.add(conn)
        try:
            while True:
                try:
                    req, payload = _recv(conn)
                except (ConnectionError, OSError):
                    return
                try:
                    reply, data = self._handle(req, payload, handles)
                    if "handle_new" in reply:
                        handles[next_id] = reply.pop("handle_new")
                        reply["handle"] = next_id
                        next_id += 1
                except Exception as exc:  # surface as a client-side error
                    reply, data = {"err": f"{type(exc).__name__}: {exc}"}, b""
                _send(conn, reply, data)
        finally:
            for fp, tmp in handles.values():
                try:
                    fp.close()
                except OSError:
                    pass
                if tmp is not None and os.path.exists(tmp):
                    os.remove(tmp)  # uncommitted write: discard
            with self._conns_lock:
                self._live_conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, req: Dict[str, Any], payload: bytes,
                handles: Dict[int, Tuple[Any, Optional[str]]]
                ) -> Tuple[Dict[str, Any], bytes]:
        op = req["op"]
        if op == "open_r":
            fp = open(self._resolve(req["path"]), "rb")
            return {"handle_new": (fp, None)}, b""
        if op == "read":
            fp, _ = handles[req["handle"]]
            return {}, fp.read(req["size"]) if req["size"] >= 0 else fp.read()
        if op == "open_w":
            full = self._resolve(req["path"])
            os.makedirs(os.path.dirname(full), exist_ok=True)
            # server-wide counter: two concurrent write handles on the SAME
            # path (even over one pooled client connection) must not share
            # a temp file
            tmp = full + f".mvfs-tmp-{next(_tmp_ids)}"
            if req.get("append") and os.path.exists(full):
                import shutil
                shutil.copyfile(full, tmp)  # append continues existing bytes
            fp = open(tmp, "ab" if req.get("append") else "wb")
            return {"handle_new": (fp, tmp)}, b""
        if op == "write":
            fp, _ = handles[req["handle"]]
            fp.write(payload)
            return {"written": len(payload)}, b""
        if op == "sync":
            # durability barrier for WAL appends through the scheme; note
            # the temp file only commits (rename) on close, so an open
            # handle's bytes are durable but not yet visible at the final
            # name — see docs/fault_tolerance.md §7 on mvfs-backed WALs
            fp, _ = handles[req["handle"]]
            fp.flush()
            os.fsync(fp.fileno())
            return {}, b""
        if op == "close":
            fp, tmp = handles.pop(req["handle"])
            fp.close()
            if tmp is not None:  # commit: atomic rename over the final name
                os.replace(tmp, tmp[:tmp.index(".mvfs-tmp-")])
            return {}, b""
        if op == "exists":
            return {"exists": os.path.exists(self._resolve(req["path"]))}, b""
        if op == "replace":
            os.replace(self._resolve(req["src"]), self._resolve(req["dst"]))
            return {}, b""
        if op == "makedirs":
            os.makedirs(self._resolve(req["path"]), exist_ok=True)
            return {}, b""
        if op == "listdir":
            full = self._resolve(req["path"])
            names = sorted(os.listdir(full)) if os.path.isdir(full) else []
            return {"names": names}, b""
        if op == "remove":
            os.remove(self._resolve(req["path"]))
            return {}, b""
        raise ValueError(f"mvfs: unknown op {op!r}")


class MvfsRemoteError(IOError):
    """The server processed the request and reported failure (the
    connection itself is healthy)."""


class _MvfsConn:
    """One client connection; serialized request/reply. A transport failure
    evicts this connection from the pool so the next open redials (a
    restarted server must not poison every later filesystem op)."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._sock = socket.create_connection((host, port), timeout=30)
        self._lock = threading.Lock()

    def call(self, header: Dict[str, Any], payload: bytes = b""
             ) -> Tuple[Dict[str, Any], bytes]:
        try:
            with self._lock:
                _send(self._sock, header, payload)
                reply, data = _recv(self._sock)
        except OSError:
            _evict(self.host, self.port, self)
            raise
        if "err" in reply:
            raise MvfsRemoteError(f"mvfs server: {reply['err']}")
        return reply, data

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# connection pool: one socket per (host, port) per process — streams and
# filesystem ops share it (requests are serialized per connection)
_conns: Dict[Tuple[str, int], _MvfsConn] = {}
_conns_lock = threading.Lock()


def _conn_for(host: str, port: int) -> _MvfsConn:
    with _conns_lock:
        conn = _conns.get((host, port))
    if conn is not None:
        return conn
    # dial OUTSIDE the global lock: a blackholed endpoint (30s connect
    # timeout) must not stall mvfs traffic to healthy servers
    fresh = _MvfsConn(host, port)
    with _conns_lock:
        conn = _conns.get((host, port))
        if conn is not None:  # raced: keep the first, drop ours
            fresh.close()
            return conn
        _conns[(host, port)] = fresh
    return fresh


def _evict(host: str, port: int, conn: _MvfsConn) -> None:
    """Drop a broken pooled connection so the next open redials."""
    with _conns_lock:
        if _conns.get((host, port)) is conn:
            del _conns[(host, port)]
    conn.close()


def reset_connections() -> None:
    """Drop pooled connections (server restarted / tests)."""
    with _conns_lock:
        for conn in _conns.values():
            conn.close()
        _conns.clear()


def _host_port(uri: URI) -> Tuple[str, int]:
    """host:port from the authority; a missing/garbled port is a malformed
    address (programmer error), reported as such — not a bad stream."""
    host, sep, port = uri.host.rpartition(":")
    if not sep or not port.isdigit():
        log.fatal("mvfs address needs host:port, got %r", uri.raw)
    return host, int(port)


class MvfsStream(Stream):
    """Client-side stream on a served path (``mvfs://host:port/path``)."""

    def __init__(self, uri: URI, mode: str) -> None:
        host, port = _host_port(uri)
        self._conn: Optional[_MvfsConn] = None
        self._writing = "w" in mode or "a" in mode
        op = ("open_w" if self._writing else "open_r")
        try:
            # connect inside the guard: a down server yields a bad stream
            # (good() False), matching the LocalStream/FsspecStream contract
            self._conn = _conn_for(host, port)
            reply, _ = self._conn.call(
                {"op": op, "path": uri.path, "append": "a" in mode})
            self._handle: Optional[int] = reply["handle"]
        except MvfsRemoteError as exc:  # server said no; connection healthy
            log.error("MvfsStream: cannot open %s (%s)", uri.raw, exc)
            self._handle = None
        except OSError as exc:  # transport failure: evict the pooled conn
            log.error("MvfsStream: cannot reach %s (%s)", uri.raw, exc)
            if self._conn is not None:
                _evict(host, port, self._conn)
                self._conn = None
            self._handle = None

    def write(self, data: bytes) -> int:
        if self._handle is None:
            log.fatal("MvfsStream.write on bad stream")
        reply, _ = self._conn.call(
            {"op": "write", "handle": self._handle}, bytes(data))
        return reply["written"]

    def read(self, size: int = -1) -> bytes:
        if self._handle is None:
            log.fatal("MvfsStream.read on bad stream")
        _, data = self._conn.call(
            {"op": "read", "handle": self._handle, "size": size})
        return data

    def good(self) -> bool:
        return self._handle is not None

    def sync(self) -> None:
        if self._handle is not None and self._writing:
            self._conn.call({"op": "sync", "handle": self._handle})

    def close(self) -> None:
        if self._handle is not None:
            self._conn.call({"op": "close", "handle": self._handle})
            self._handle = None


class MvfsFileSystem(FileSystem):
    """Directory operations on a served root — lets CheckpointDriver
    snapshot/restore through the remote scheme."""

    def _split(self, address: str) -> Tuple[_MvfsConn, str]:
        uri = URI.parse(address)
        host, port = _host_port(uri)
        return _conn_for(host, port), uri.path

    def exists(self, address: str) -> bool:
        conn, path = self._split(address)
        reply, _ = conn.call({"op": "exists", "path": path})
        return bool(reply["exists"])

    def replace(self, src: str, dst: str) -> None:
        conn, spath = self._split(src)
        _, dpath = self._split(dst)
        conn.call({"op": "replace", "src": spath, "dst": dpath})

    def makedirs(self, address: str) -> None:
        conn, path = self._split(address)
        conn.call({"op": "makedirs", "path": path})

    def listdir(self, address: str) -> list:
        conn, path = self._split(address)
        reply, _ = conn.call({"op": "listdir", "path": path})
        return reply["names"]

    def remove(self, address: str) -> None:
        conn, path = self._split(address)
        conn.call({"op": "remove", "path": path})


register_scheme("mvfs", lambda uri, mode: MvfsStream(uri, mode))
register_fs("mvfs", MvfsFileSystem())
