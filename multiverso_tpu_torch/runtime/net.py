"""Host-side network transport + collectives (port of
``multiverso_tpu/runtime/net.py``; the frames are the JAX package's, byte
for byte).

Reference capability (not copied): the ``NetInterface`` seam with MPI/ZMQ
backends (``include/multiverso/net.h:15-49``, ``net/mpi_net.h``,
``net/zmq_net.h``) and the hand-rolled ``AllreduceEngine``
(``include/multiverso/net/allreduce_engine.h:80-168``).

The process that holds the tables talks to its worker processes here: a
TCP transport with the reference's message framing semantics (typed header
+ length-prefixed blobs), an optional shared-memory ring for colocated
peers (``runtime/shm.py``), and a ring allreduce/allgather engine built on
the raw send/recv channel. Everything it carries is numpy on the host.

Two channels per peer, like the reference's split between mailbox traffic
(``Send/Recv`` via the Communicator) and raw blocking transfers
(``SendTo/RecvFrom/SendRecv`` used by the AllreduceEngine):

* channel 0 — mailbox: frames land in a shared recv queue (``recv()``)
* channel 1 — raw: frames land in a per-peer queue (``recv_from(rank)``)
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count, gauge_add, observe
from multiverso_tpu_torch.obs.profiler import clear_wait, mark_wait
from multiverso_tpu_torch.obs.trace import flight_dump, hop
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.shm import ShmChannel
from multiverso_tpu_torch.utils import MtQueue

_MAGIC = 0x4D565450  # 'MVTP'
# Wire version — the ONE place the frame layout is bumped. v2 grew the
# req_id field (idempotent replay, fault/retry.py); v3 grew payload_len +
# a CRC32 over the blob section, so a corrupted frame is detected and
# DISCARDED (the length keeps the stream in sync; retransmit + the dedup
# window recover the frame) instead of desyncing on a garbled blob size;
# v4 grew the watermark field (read-replica tier: WAL record sequence on
# replies/records, staleness budget on Request_Read frames); v5 grew the
# deadline budget field — the REMAINING microseconds a request's caller
# will keep waiting (0 = no deadline, never refused). A budget, not an
# instant: each receiver re-anchors it against its own monotonic clock
# (wall-clock skew between hosts cannot expire a request), and each hop
# that re-encodes the frame ships only what's left after its own queueing,
# so the budget decrements across hops for free.
# Both sides of every deployment ship from this repo, so a mismatch is a
# config error and the connection is dropped loudly rather than negotiated.
_VERSION = 5
# magic, version, channel, src, dst, type, table, msg_id, req_id,
# watermark, deadline_us, nblobs, payload_len, crc32(payload)
_HEADER = struct.Struct("<IBBiiiiqqqiiqI")
_BLOB = struct.Struct("<B8sq")  # ndim, dtype str (padded), nbytes

# One vectored syscall carries at most this many iovec segments — well
# under Linux's IOV_MAX (1024) so sendmsg never rejects a batch.
_IOV_MAX_SEGS = 512
# Batches at or below this many bytes are joined into ONE contiguous
# buffer before the syscall: copying a few KiB is cheaper than carrying
# dozens of iovec entries through the kernel. Zero-copy only pays once
# the payload dwarfs the copy cost.
_JOIN_BYTES = 1 << 16
# Producer backpressure: a connection's outgoing queue holds at most this
# many multiples of wire_coalesce_bytes before senders block (a dead-slow
# peer must not buffer unbounded frames in the process).
_QUEUE_CAP_MULT = 8


def _tune_socket(sock: socket.socket, buf_bytes: int = 1 << 20) -> None:
    """The ONE socket-tuning site (data plane and multihost control plane
    both call it): latency first (TCP_NODELAY — frames are latency-bound
    RPCs, coalescing happens above the socket, not in Nagle), then
    throughput (SO_SNDBUF/SO_RCVBUF sized for a full coalesced batch so a
    vectored flush lands in one kernel pass)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, int(buf_bytes))
        except OSError:
            pass  # platform cap — the default sizing still applies


def _pack_blob(arr: np.ndarray) -> Tuple[bytes, memoryview, int]:
    """-> (head bytes, payload buffer, payload nbytes). The payload is a
    memoryview over the array's own memory — never ``tobytes()`` — so
    large Add/Get payloads cross the send path without a Python-side
    copy (the memoryview keeps any ascontiguousarray temporary alive)."""
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.str.encode()[:8].ljust(8, b" ")
    head = _BLOB.pack(arr.ndim, dt, arr.nbytes) + struct.pack(
        f"<{arr.ndim}q", *arr.shape)
    return head, memoryview(arr).cast("B"), arr.nbytes


class _WireDesync(ConnectionError):
    """The stream produced an unparsable header (bad magic / version):
    nothing downstream can be trusted — the connection must drop."""


class _Frame:
    """One queued outbound frame: its iovec segments plus completion
    state (``done``/``error``) the drain loop reports back through."""

    __slots__ = ("segments", "nbytes", "done", "error")

    def __init__(self, segments: List[Any], nbytes: int) -> None:
        self.segments = segments
        self.nbytes = nbytes
        self.done = False
        self.error: Optional[BaseException] = None


_send_metrics_cache = None


def _send_metrics():
    """Send-path metric objects, resolved ONCE: the registry's global
    lock must not sit on the per-frame hot path (Dashboard.reset zeroes
    objects in place, so cached references stay live)."""
    global _send_metrics_cache
    if _send_metrics_cache is None:
        from multiverso_tpu_torch.dashboard import Dashboard
        _send_metrics_cache = (Dashboard.counter("SEND_SYSCALLS"),
                               Dashboard.counter("SEND_COALESCED_FRAMES"),
                               Dashboard.counter("SEND_COALESCED_BYTES"),
                               Dashboard.histogram("WIRE_FRAMES_PER_SYSCALL"),
                               Dashboard.gauge("SEND_QUEUE_BYTES"))
    return _send_metrics_cache


class _SendState:
    """Per-socket outgoing state: the legacy per-frame send lock plus —
    in coalescing mode — the frame deque a dedicated drain thread
    flushes in vectored batches. ``held`` freezes the drain (tests and
    deterministic-coalescing harnesses force a burst through it)."""

    __slots__ = ("lock", "cv", "frames", "bytes", "closed", "error", "held",
                 "draining")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # plain Lock under the Condition: the default RLock's ownership
        # bookkeeping is measurable on the per-frame path
        self.cv = threading.Condition(threading.Lock())
        self.frames: deque = deque()
        self.bytes = 0
        self.closed = False
        self.error: Optional[BaseException] = None
        self.held = False
        # True while exactly one sender (inline caller or the drain
        # thread) is mid-batch — the exclusivity that keeps the stream
        # ordered without a lock held across the syscall
        self.draining = False


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    # profiler wait site: time parked in recv is wire/peer wait, not CPU
    prev = mark_wait("net_recv")
    try:
        while n > 0:
            chunk = sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("peer closed")
            chunks.append(chunk)
            n -= len(chunk)
    finally:
        clear_wait(prev)
    return b"".join(chunks)


def get_local_ip() -> str:
    """Best-effort local IP (reference net_util::GetLocalIPAddress parity)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        return ip
    except OSError:
        return "127.0.0.1"


def parse_machine_file(path: str) -> List[str]:
    """One ``host[:port]`` per line; rank = line index (zmq_net.h machine-file
    contract). Default port from the ``port`` flag."""
    from multiverso_tpu_torch.config import get_flag
    endpoints = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" not in line:
                line = f"{line}:{get_flag('port')}"
            endpoints.append(line)
    return endpoints


class TcpNet:
    """Rank-to-rank TCP transport with explicit Bind/Connect (the reference
    ZMQ backend's raw-net mode for external hosts)."""

    def __init__(self) -> None:
        self.rank = -1
        self.size = 0
        self._endpoints: List[str] = []
        self._listener: Optional[socket.socket] = None
        self._conns: Dict[int, socket.socket] = {}
        self._conn_lock = threading.Lock()
        self._send_states: Dict[socket.socket, _SendState] = {}
        self._mailbox: MtQueue = MtQueue()
        self._raw: Dict[int, MtQueue] = {}
        self._accept_thread: Optional[threading.Thread] = None
        self._accepted: list = []
        self._active = False
        # coalescing caps: cached for the drain loop but LIVE through the
        # config watch seam, so a runtime step (operator or autotuner)
        # reshapes the next vectored send instead of waiting for a net
        # rebuild; 0 on either flag = per-frame sendall. The
        # queue-vs-sendall mode itself stays as constructed — only the
        # caps of an already-coalescing net move (the mode needs the
        # queue machinery wired at construction).
        self._coalesce_frames = int(config.get_flag("wire_coalesce_frames"))
        self._coalesce_bytes = int(config.get_flag("wire_coalesce_bytes"))
        self._coalesce = (self._coalesce_frames > 0
                          and self._coalesce_bytes > 0)
        self._flag_unsubs = [
            config.FLAGS.on_change("wire_coalesce_frames",
                                   self._on_coalesce_change),
            config.FLAGS.on_change("wire_coalesce_bytes",
                                   self._on_coalesce_change),
        ]
        # shared-memory transport (runtime/shm.py), negotiated per dialed
        # connection when the flag is on; keyed by the TCP socket that
        # carries the connection's liveness (server side: the accepted
        # conn the offer arrived on)
        self._shm_enabled = bool(config.get_flag("wire_shm"))
        self._shm_bytes = int(config.get_flag("wire_shm_bytes"))
        self._shm_channels: Dict[Any, ShmChannel] = {}

    def _on_coalesce_change(self, _name: str, _value) -> None:
        # caps move live (the drain loop reads them per batch); the
        # queue-vs-sendall mode stays as constructed
        self._coalesce_frames = int(config.get_flag("wire_coalesce_frames"))
        self._coalesce_bytes = int(config.get_flag("wire_coalesce_bytes"))

    # -- lifecycle ----------------------------------------------------------
    def bind(self, rank: int, endpoint: str) -> str:
        """Listen on ``host:port`` (port 0 → ephemeral); returns the bound
        endpoint (MV_NetBind parity)."""
        host, port = endpoint.rsplit(":", 1)
        self.rank = rank
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        # wildcard/loopback binds must advertise a dialable address
        adv_host = get_local_ip() if host in ("0.0.0.0", "::", "") else host
        bound = f"{adv_host}:{self._listener.getsockname()[1]}"
        self._active = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"mvtpu-net-accept-{rank}")
        self._accept_thread.start()
        return bound

    def connect(self, endpoints: Sequence[str]) -> None:
        """Record the full rank→endpoint map (MV_NetConnect parity).
        Connections are dialed lazily on first send."""
        self._endpoints = list(endpoints)
        self.size = len(endpoints)
        for r in range(self.size):
            self._raw.setdefault(r, MtQueue())

    def init(self, rank: int, endpoints: Sequence[str]) -> None:
        """bind + connect in one step (symmetric deployments)."""
        self.bind(rank, endpoints[rank])
        self.connect(endpoints)

    def finalize(self) -> None:
        self._active = False
        for unsub in getattr(self, "_flag_unsubs", ()):
            unsub()
        self._flag_unsubs = []
        # flush queued frames BEFORE tearing connections down: callers
        # that enqueued (deregister, final replies) relied on sendall
        # semantics — give the drain loops a bounded window to empty
        self._flush_queues(timeout=1.0)
        # close negotiated shm channels: blocked ring peers fail fast and
        # each reader thread disposes its mappings on the way out
        with self._conn_lock:
            channels = list(self._shm_channels.values())
            self._shm_channels.clear()
        for ch in channels:
            ch.close()
        with self._conn_lock:
            states = list(self._send_states.values())
        for st in states:
            with st.cv:
                st.closed = True
                st.cv.notify_all()
        if self._listener is not None:
            # shutdown() first: close() alone leaves the accept thread
            # blocked inside accept(), and that in-flight syscall pins the
            # open file description — the port would stay in LISTEN and a
            # server restart could not rebind it (fault recovery path)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conn_lock:
            for sock in list(self._conns.values()) + self._accepted:
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
            self._accepted.clear()
        self._mailbox.exit()
        for q in self._raw.values():
            q.exit()

    # -- send ---------------------------------------------------------------
    def send(self, msg: Message) -> int:
        return self._send(msg, channel=0)

    def send_to(self, rank: int, blobs: List[np.ndarray]) -> int:
        msg = Message(src=self.rank, dst=rank, type=MsgType.Request_Get,
                      data=blobs)
        return self._send(msg, channel=1)

    def recv(self) -> Optional[Message]:
        """Pop the next mailbox message (blocks; None on shutdown). Raises
        ConnectionError when a peer connection died while the transport is
        live (fail-fast instead of hanging waiters)."""
        msg = self._mailbox.pop()
        if (msg is not None and msg.type == MsgType.Reply_Error
                and msg.src == -1):
            raise ConnectionError("net: peer connection lost")
        return msg

    def recv_from(self, rank: int) -> Optional[List[np.ndarray]]:
        msg = self._raw[rank].pop()
        if msg is None:
            return None
        if msg.type == MsgType.Reply_Error and msg.src == -1:
            raise ConnectionError(
                "net: peer connection lost while waiting for data")
        return msg.data

    def send_recv(self, dst: int, blobs: List[np.ndarray],
                  src: int) -> Optional[List[np.ndarray]]:
        self.send_to(dst, blobs)
        return self.recv_from(src)

    def send_via(self, conn: socket.socket, msg: Message,
                 channel: int = 0, flush: bool = False) -> int:
        """Send over an explicit connection — the reply path for peers that
        never bound a listener (remote table clients): the server answers
        over the socket the request arrived on (``msg._conn``).
        ``flush=True`` blocks until the frame reached the kernel — the
        ordering barrier replication needs (a WAL record must hit the
        standby's socket before the client's ACK is even queued)."""
        segments, nbytes = self._frame_segments(msg, channel)
        return self._enqueue(conn, segments, nbytes, flush=flush)

    # -- internals ----------------------------------------------------------
    def _frame_segments(self, msg: Message,
                        channel: int) -> Tuple[List[Any], int]:
        """Vectored frame assembly: ``[header, blob-head, blob-payload,
        ...]`` where payloads are memoryviews over the original array
        memory. The CRC32 runs incrementally across the payload section,
        so the bytes on the wire are bit-identical to the legacy
        concatenated frame without ever materializing it."""
        t0 = time.perf_counter()
        segments: List[Any] = [b""]  # header lands here once CRC is known
        crc = 0
        payload_len = 0
        for arr in msg.data:
            head, payload, blob_bytes = _pack_blob(np.asarray(arr))
            crc = zlib.crc32(head, crc)
            segments.append(head)
            payload_len += len(head)
            if blob_bytes:
                crc = zlib.crc32(payload, crc)
                segments.append(payload)
                payload_len += blob_bytes
        # trace flag rides the channel byte's high bit (channels are tiny
        # small ints) — no header-layout change, v3-framed transports
        # (shm rings) inherit it for free
        wire_channel = channel | (0x80 if getattr(msg, "trace", False)
                                  else 0)
        # deadline rides as REMAINING budget (µs): measured against this
        # sender's clock at encode time, so queueing spent here is already
        # subtracted. An expired-at-encode deadline ships as the 1 µs
        # floor — the receiver drops it at drain with a truthful
        # deadline_exceeded instead of this layer silently eating it.
        deadline_us = 0
        local_deadline = getattr(msg, "deadline", 0.0)
        if local_deadline > 0:
            deadline_us = max(
                1, min(0x7FFFFFFF,
                       int((local_deadline - time.monotonic()) * 1e6)))
        segments[0] = _HEADER.pack(_MAGIC, _VERSION, wire_channel, msg.src,
                                   msg.dst, int(msg.type), msg.table_id,
                                   msg.msg_id, msg.req_id, msg.watermark,
                                   deadline_us, len(msg.data), payload_len,
                                   crc)
        observe("FRAME_ENCODE_SECONDS", time.perf_counter() - t0)
        return segments, _HEADER.size + payload_len

    def _frame(self, msg: Message, channel: int) -> bytes:
        """Contiguous frame bytes — the ChaosNet corrupt seam and golden
        tests want the materialized form; the hot path never builds it."""
        segments, _ = self._frame_segments(msg, channel)
        return b"".join(segments)

    def _send(self, msg: Message, channel: int) -> int:
        segments, nbytes = self._frame_segments(msg, channel)
        return self._enqueue(self._socket_for(msg.dst), segments, nbytes)

    def _send_raw(self, dst: int, frame: bytes) -> int:
        """Framed-bytes send seam: ChaosNet's ``corrupt`` action flips bits
        in an already-built frame and ships it through here. Rides the
        same per-socket queue as vectored frames, so a corrupted frame
        coalesces with its neighbors exactly like a healthy one."""
        return self._enqueue(self._socket_for(dst), [frame], len(frame))

    def _send_via_raw(self, conn: socket.socket, frame: bytes) -> int:
        return self._enqueue(conn, [frame], len(frame))

    # -- coalescing send queue ----------------------------------------------
    def _state_for(self, sock: socket.socket) -> _SendState:
        with self._conn_lock:
            st = self._send_states.get(sock)
            if st is None:
                st = self._send_states[sock] = _SendState()
            return st

    def _enqueue(self, sock: socket.socket, segments: List[Any],
                 nbytes: int, flush: bool = False) -> int:
        # shm divert: a negotiated connection's frames cross as ONE locked
        # memcpy into the ring — no queue, no syscall; writes are
        # synchronous (ring-full blocking = the sendall backpressure), so
        # ``flush`` is trivially satisfied. ``sock`` may BE the channel
        # (reply path for frames that arrived over the ring).
        if isinstance(sock, ShmChannel):
            return sock.send_segments(segments, nbytes)
        if self._shm_channels:
            ch = self._shm_channels.get(sock)
            if ch is not None:
                return ch.send_segments(segments, nbytes)
        st = self._state_for(sock)
        if not self._coalesce:
            # legacy posture (wire_coalesce_* = 0): one locked sendall
            # per frame, frame bytes materialized
            with st.lock:
                sock.sendall(b"".join(segments))
            _send_metrics()[0].add(1)
            return nbytes
        cap = max(self._coalesce_bytes * _QUEUE_CAP_MULT, 8 << 20)
        frame = None
        with st.cv:
            if st.bytes >= cap:
                # backpressure: block while the peer is this far behind —
                # the bound sendall's kernel buffer used to provide
                st.cv.wait_for(lambda: st.bytes < cap or st.closed
                               or st.error is not None)
            if st.error is not None:
                raise OSError(f"net: send failed earlier on this "
                              f"connection: {st.error!r}")
            if st.closed:
                raise OSError("net: transport closed")
            # fast path: the connection is idle — claim the drain token
            # and send INLINE on this thread, allocating nothing (the
            # single-outstanding-request case costs what a bare locked
            # sendall did). A send already in flight is exactly the
            # coalescing case: queue the frame for the current holder's
            # next batch.
            fast = not st.held and not st.draining and not st.frames
            if fast:
                st.draining = True
            else:
                frame = _Frame(segments, nbytes)
                st.frames.append(frame)
                st.bytes += nbytes
                _send_metrics()[4].add(nbytes)  # SEND_QUEUE_BYTES
                claim = not st.held and not st.draining
                if claim:
                    st.draining = True
        if fast:
            try:
                if nbytes <= _JOIN_BYTES:
                    sock.sendall(b"".join(segments))
                    syscalls = 1
                else:
                    syscalls = self._sendmsg_all(sock, segments)
            except OSError as exc:
                self._fail_send_state(st, exc)
                raise  # synchronous, exactly like the legacy sendall
            (syscalls_c, frames_c, bytes_c, fps_hist, _g) = _send_metrics()
            syscalls_c.add(syscalls)
            frames_c.add(1)
            bytes_c.add(nbytes)
            fps_hist.observe(1 / syscalls)
            with st.cv:
                st.draining = False
                # frames queued while our send was in flight: drain them
                # (coalesced) before releasing the token
                backlog = bool(st.frames) and not st.held \
                    and st.error is None
                if backlog:
                    st.draining = True
                st.cv.notify_all()
            if backlog:
                self._drain_pending(sock, st)
            return nbytes
        if claim:
            self._drain_pending(sock, st)
        if flush and not frame.done:
            with st.cv:
                st.cv.wait_for(lambda: frame.done
                               or frame.error is not None)
            if frame.error is not None:
                raise OSError(f"net: flush failed: {frame.error!r}")
        return nbytes

    def _fail_send_state(self, st: _SendState,
                         exc: BaseException) -> None:
        """Sticky-fail a connection's send state: every queued frame and
        future sender sees the error; flush/backpressure waiters wake."""
        with st.cv:
            st.error = exc
            st.draining = False
            for fr in st.frames:
                fr.error = exc
            st.frames.clear()
            _send_metrics()[4].add(-st.bytes)
            st.bytes = 0
            st.cv.notify_all()

    def _drain_pending(self, sock: socket.socket, st: _SendState) -> None:
        """Flush the queue in vectored batches until empty — the drain
        loop. Caller must hold the ``draining`` token; frames other
        threads queue while a batch is in flight are picked up by the
        re-check before the token is released, so every frame queued
        behind an in-flight send rides ONE sendmsg syscall with its
        neighbors (bounded by the wire_coalesce_* caps)."""
        (syscalls_c, frames_c, bytes_c, fps_hist, queue_gauge) = \
            _send_metrics()
        while True:
            batch: List[_Frame] = []
            iov: List[Any] = []
            nbytes = 0
            with st.cv:
                while st.frames:
                    fr = st.frames[0]
                    if batch and (len(batch) >= self._coalesce_frames
                                  or nbytes + fr.nbytes
                                  > self._coalesce_bytes
                                  or len(iov) + len(fr.segments)
                                  > _IOV_MAX_SEGS):
                        break
                    st.frames.popleft()
                    batch.append(fr)
                    iov.extend(fr.segments)
                    nbytes += fr.nbytes
                if not batch:
                    st.draining = False
                    return
            try:
                if nbytes <= _JOIN_BYTES:
                    # small batches ride one contiguous buffer: copying
                    # a few KiB beats extra iovec entries in the kernel
                    iov = [b"".join(iov)]
                syscalls = self._sendmsg_all(sock, iov)
            except OSError as exc:
                self._fail_send_state(st, exc)
                return
            syscalls_c.add(syscalls)
            frames_c.add(len(batch))
            bytes_c.add(nbytes)
            fps_hist.observe(len(batch) / syscalls)
            with st.cv:
                st.bytes -= nbytes
                queue_gauge.add(-nbytes)
                for fr in batch:
                    fr.done = True
                st.cv.notify_all()
                if not st.frames:
                    st.draining = False
                    return

    @staticmethod
    def _sendmsg_all(sock: socket.socket, iov: List[Any]) -> int:
        """Send the whole iovec list; returns the syscall count. Handles
        partial writes (resume mid-segment via memoryview slicing) and
        chunks at _IOV_MAX_SEGS so the kernel never rejects a batch."""
        iov = list(iov)
        syscalls = 0
        idx = 0
        while idx < len(iov):
            sent = sock.sendmsg(iov[idx:idx + _IOV_MAX_SEGS])
            syscalls += 1
            while idx < len(iov):
                seg_len = len(iov[idx])
                if sent >= seg_len:
                    sent -= seg_len
                    idx += 1
                elif sent:
                    iov[idx] = memoryview(iov[idx])[sent:]
                    break
                else:
                    break
        return max(syscalls, 1)

    def _flush_queues(self, timeout: float = 1.0) -> None:
        """Bounded wait for every outgoing queue to reach the kernel
        (draining any backlog a hold left behind)."""
        deadline = time.monotonic() + timeout
        with self._conn_lock:
            states = list(self._send_states.items())
        for sock, st in states:
            self._release_sends(sock)
            with st.cv:
                st.cv.wait_for(
                    lambda: st.bytes == 0 or st.error is not None,
                    timeout=max(0.0, deadline - time.monotonic()))

    def _hold_sends(self, sock: socket.socket) -> None:
        """Freeze a connection's drain (frames queue but nothing is
        sent) — the deterministic-coalescing seam the forced-coalesce
        tests use; ``_release_sends`` flushes the built-up burst as one
        vectored batch."""
        st = self._state_for(sock)
        with st.cv:
            st.held = True

    def _release_sends(self, sock: socket.socket) -> None:
        st = self._state_for(sock)
        with st.cv:
            st.held = False
            claim = bool(st.frames) and not st.draining \
                and st.error is None
            if claim:
                st.draining = True
            st.cv.notify_all()
        if claim:
            self._drain_pending(sock, st)

    def _socket_for(self, rank: int) -> socket.socket:
        with self._conn_lock:
            sock = self._conns.get(rank)
        if sock is not None:
            return sock
        if not (0 <= rank < len(self._endpoints)):
            log.fatal("net: no endpoint for rank %d", rank)
        host, port = self._endpoints[rank].rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=30)
        # the connect timeout must not linger as an IO timeout: an idle
        # connection's recv loop would otherwise die after 30s of silence
        # and fake a peer loss
        sock.settimeout(None)
        _tune_socket(sock)
        # shm negotiation runs INLINE before the socket becomes visible:
        # either every data frame on this connection rides the ring or
        # none does — no mixed-stream ordering window at switch time
        channel = self._shm_offer(sock) if self._shm_enabled else None
        with self._conn_lock:
            # keep the first established connection per peer
            existing = self._conns.get(rank)
            if existing is not None:
                sock.close()  # the peer's conn-drop reaps its channel side
                if channel is not None:
                    channel.dispose()
                return existing
            self._conns[rank] = sock
            if channel is not None:
                self._shm_channels[sock] = channel
        self._active = True
        # dialed sockets also receive: peers without a listener of their own
        # (remote table clients) get replies back over this connection
        threading.Thread(target=self._recv_loop, args=(sock,), daemon=True,
                         name=f"mvtpu-net-recv-dial-{self.rank}").start()
        if channel is not None:
            threading.Thread(target=self._shm_recv_loop,
                             args=(channel, sock), daemon=True,
                             name=f"mvtpu-shm-recv-dial-{self.rank}").start()
        return sock

    def _accept_loop(self) -> None:
        while self._active:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            _tune_socket(conn)
            with self._conn_lock:
                self._accepted.append(conn)
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True,
                             name=f"mvtpu-net-recv-{self.rank}").start()

    def _read_frame(self, read, srcs_seen: set) -> Optional[Message]:
        """Read ONE v3 frame off a byte stream (``read(n) -> bytes``) —
        the parse shared by the TCP recv loop and the shm ring reader, so
        both transports carry bit-identical framing. Returns None on a
        CRC reject (the length header keeps the stream in sync; the frame
        is discarded and retransmit recovers it); raises
        :class:`_WireDesync` on an unparsable header."""
        head = read(_HEADER.size)
        (magic, version, channel, src, dst, mtype, table_id, msg_id,
         req_id, watermark, deadline_us, nblobs, payload_len,
         crc) = _HEADER.unpack(head)
        # the channel byte's high bit is the trace flag — mask it off
        # before routing (the raw channel's == 1 check must still hold)
        trace = bool(channel & 0x80)
        channel &= 0x7F
        if magic != _MAGIC:
            log.error("net: bad frame magic %x", magic)
            raise _WireDesync("bad frame magic")
        if version != _VERSION:
            log.error("net: wire version %d from peer (want %d)",
                      version, _VERSION)
            raise _WireDesync("wire version mismatch")
        srcs_seen.add(src)
        # the header's payload_len keeps the stream in sync even when the
        # payload is garbage: read it all, checksum, and only then parse
        # blob structure out of it
        payload = read(payload_len) if payload_len else b""
        if zlib.crc32(payload) != crc:
            count("FRAME_CRC_REJECTS")
            log.error("net: CRC mismatch on %s frame from %d — "
                      "frame discarded (retransmit recovers it)",
                      MsgType(mtype), src)
            hop(req_id, "net_crc_reject")
            flight_dump("frame_crc_reject", src=src,
                        msg_type=int(mtype), req_id=req_id)
            return None
        t0 = time.perf_counter()
        off = 0
        blobs = []
        for _ in range(nblobs):
            ndim, dt, nbytes = _BLOB.unpack_from(payload, off)
            off += _BLOB.size
            shape = struct.unpack_from(f"<{ndim}q", payload, off)
            off += 8 * ndim
            dtype = np.dtype(dt.decode().strip())
            blobs.append(np.frombuffer(
                payload, dtype=dtype, count=nbytes // dtype.itemsize,
                offset=off).reshape(shape).copy())
            off += nbytes
        observe("FRAME_DECODE_SECONDS", time.perf_counter() - t0)
        hop(req_id, "net_recv")
        msg = Message(src=src, dst=dst, type=MsgType(mtype),
                      table_id=table_id, msg_id=msg_id,
                      req_id=req_id, watermark=watermark, trace=trace,
                      data=blobs)
        if deadline_us > 0:
            # re-anchor the remaining budget on THIS process's monotonic
            # clock — absolute instants never cross the wire
            msg.deadline = time.monotonic() + deadline_us / 1e6
        msg._wire_channel = channel
        return msg

    def _route(self, msg: Message) -> None:
        """Deliver a received frame to its queue (mailbox / per-peer raw)."""
        if getattr(msg, "_wire_channel", 0) == 1:
            self._raw.setdefault(msg.src, MtQueue()).push(msg)
        else:
            self._mailbox.push(msg)

    def _recv_loop(self, conn: socket.socket) -> None:
        srcs_seen: set = set()
        try:
            while self._active:
                try:
                    msg = self._read_frame(
                        lambda n: _read_exact(conn, n), srcs_seen)
                except _WireDesync:
                    self._drop_conn(conn, srcs_seen)
                    return
                if msg is None:
                    continue  # CRC reject; stream stays in sync
                if msg.type == MsgType.Control_Shm:
                    # transport-internal negotiation: never surfaces to
                    # the mailbox/dispatcher
                    self._shm_serve_accept(conn, msg)
                    continue
                if msg.type == MsgType.Control_Reply_Shm:
                    continue  # stale duplicate; handshake reads inline
                msg._conn = conn  # reply path for listener-less peers
                self._route(msg)
        except (ConnectionError, OSError):
            self._drop_conn(conn, srcs_seen)
            return

    # -- shared-memory transport (runtime/shm.py) ---------------------------
    def _shm_offer(self, sock: socket.socket) -> Optional[ShmChannel]:
        """Inline shm handshake on a fresh dialed connection (nothing else
        is on this wire yet, so a blocking read of the reply is safe).
        Returns the live channel, or None — the caller keeps TCP. The
        segment files are unlinked as soon as the handshake settles: both
        sides hold mappings, so even a kill -9 cannot leak them.
        Negotiation frames bypass the ChaosNet seams deliberately — chaos
        targets data-plane frames; a dropped offer would silently change
        which transport a chaos run exercises."""
        from multiverso_tpu_torch.runtime import shm as shm_mod
        try:
            paths, channel = shm_mod.create_pair(self._shm_bytes)
        except OSError as exc:
            log.error("shm: segment creation failed (%r); staying on TCP",
                      exc)
            return None
        ok = False
        try:
            payload = json.dumps({"c2s": paths[0], "s2c": paths[1]}).encode()
            msg = Message(src=self.rank, dst=-1, type=MsgType.Control_Shm,
                          data=[np.frombuffer(payload, dtype=np.uint8)])
            segments, _ = self._frame_segments(msg, 0)
            sock.settimeout(10.0)
            sock.sendall(b"".join(segments))
            reply = self._read_frame(lambda n: _read_exact(sock, n), set())
            if reply is None or reply.type != MsgType.Control_Reply_Shm:
                log.error("shm: unexpected negotiation reply %s; staying "
                          "on TCP", None if reply is None else reply.type)
                return None
            ans = json.loads(bytes(np.asarray(
                reply.data[0], dtype=np.uint8)).decode()) if reply.data \
                else {}
            if not ans.get("ok"):
                log.info("shm: peer declined (%s); staying on TCP",
                         ans.get("error", "wire_shm off"))
                return None
            ok = True
            return channel
        except (ConnectionError, OSError, ValueError) as exc:
            log.error("shm: negotiation failed (%r); staying on TCP", exc)
            return None
        finally:
            try:
                sock.settimeout(None)
            except OSError:
                pass
            shm_mod.unlink_quiet(*paths)
            if not ok:
                channel.dispose()

    def _shm_serve_accept(self, conn: socket.socket, msg: Message) -> None:
        """Handle a Control_Shm offer: map the pair, start the ring
        reader, accept — or refuse (flag off / unmappable, i.e. a
        non-colocated peer) and the client transparently keeps TCP."""
        from multiverso_tpu_torch.runtime import shm as shm_mod
        channel: Optional[ShmChannel] = None
        error: Optional[str] = None
        if not self._shm_enabled:
            error = "wire_shm is off on this server"
        else:
            try:
                spec = json.loads(bytes(np.asarray(
                    msg.data[0], dtype=np.uint8)).decode())
                channel = shm_mod.open_pair(str(spec["c2s"]),
                                            str(spec["s2c"]))
            except (OSError, ValueError, KeyError, IndexError) as exc:
                error = f"cannot map offered segments: {exc!r}"
        payload: Dict[str, Any] = {"ok": error is None}
        if error is not None:
            payload["error"] = error
            log.info("shm: offer declined: %s", error)
        reply = Message(src=self.rank, dst=msg.src,
                        type=MsgType.Control_Reply_Shm, msg_id=msg.msg_id,
                        data=[np.frombuffer(json.dumps(payload).encode(),
                                            dtype=np.uint8)])
        segments, nbytes = self._frame_segments(reply, 0)
        try:
            # the reply MUST ride TCP — the channel is registered only
            # after the send, or the divert in _enqueue would put the
            # accept on a ring the client is not reading yet. Plain
            # _enqueue: negotiation bypasses the chaos seams like the
            # offer does (they intercept _send/send_via only).
            self._enqueue(conn, segments, nbytes)
        except OSError as exc:
            log.error("shm: accept reply failed: %r", exc)
            if channel is not None:
                channel.dispose()
            return
        if channel is not None:
            with self._conn_lock:
                self._shm_channels[conn] = channel
            threading.Thread(target=self._shm_recv_loop,
                             args=(channel, conn), daemon=True,
                             name=f"mvtpu-shm-recv-{self.rank}").start()
            log.info("shm: transport negotiated (ring %d bytes/dir)",
                     channel.rx.capacity)

    def _shm_recv_loop(self, channel: ShmChannel,
                       conn: socket.socket) -> None:
        """Ring-side twin of ``_recv_loop``: same framing, same routing;
        replies to ring-arrived frames address the CHANNEL (``msg._conn``),
        so they ride the ring back. The reader owns the mappings' final
        release — it is the last thread touching them."""
        from multiverso_tpu_torch.runtime.shm import _shm_metrics
        rx_frames = _shm_metrics()[2]
        srcs_seen: set = set()
        try:
            while self._active:
                try:
                    msg = self._read_frame(channel.read_exact, srcs_seen)
                except _WireDesync:
                    # garbage on the ring: kill the whole connection (TCP
                    # included) — the reconnect path renegotiates
                    self._drop_conn(conn, srcs_seen)
                    break
                if msg is None:
                    continue  # CRC reject; stream stays in sync
                rx_frames.add(1)
                msg._conn = channel
                self._route(msg)
        except (ConnectionError, OSError):
            if self._active and not channel.closed:
                # the PEER killed the ring (its finalize flipped the
                # shared flags) while our TCP side may sit in a blocked
                # recv that a dead socket cannot always interrupt: run
                # the same conn-drop path a TCP EOF would — pops the
                # socket AND the channel, pushes the peer-lost sentinels
                # that wake blocked waiters into recovery
                self._drop_conn(conn, srcs_seen)
        finally:
            channel.close()
            channel.dispose()

    def _drop_conn(self, conn: socket.socket, srcs_seen: set) -> None:
        """A connection died: prune its bookkeeping and — if the transport
        is still live — push a peer-lost sentinel so blocked receivers
        (mid-allreduce, pending table replies) fail fast instead of hanging
        until finalize(). Only the dead peer's raw queues are poisoned."""
        with self._conn_lock:
            state = self._send_states.pop(conn, None)
            channel = self._shm_channels.pop(conn, None)
            if conn in self._accepted:
                self._accepted.remove(conn)
            for rank, sock in list(self._conns.items()):
                if sock is conn:
                    del self._conns[rank]
                    srcs_seen = srcs_seen | {rank}
        if channel is not None:
            # the TCP liveness channel died: fail ring waiters fast (its
            # reader thread disposes the mappings on exit)
            channel.close()
        if state is not None:
            # fail queued frames + wake flush/backpressure waiters; the
            # drain thread exits on the error mark
            err = ConnectionError("net: peer connection lost")
            with state.cv:
                if state.error is None:
                    state.error = err
                for fr in state.frames:
                    fr.error = err
                state.frames.clear()
                gauge_add("SEND_QUEUE_BYTES", -state.bytes)
                state.bytes = 0
                state.cv.notify_all()
        try:
            conn.close()
        except OSError:
            pass
        if not self._active:
            return  # normal shutdown; finalize() exits the queues
        sentinel = Message(src=-1, dst=self.rank, type=MsgType.Reply_Error)
        sentinel._conn = conn
        self._mailbox.push(sentinel)
        for src in srcs_seen:
            q = self._raw.get(src)
            if q is not None:
                q.push(sentinel)


class AllreduceEngine:
    """Host collectives over the raw channel (reference AllreduceEngine
    capability). On-mesh the algorithm choice (Bruck allgather /
    recursive-halving reduce-scatter) belongs to XLA; here a ring
    reduce-scatter + ring allgather covers the host path, which is
    latency-dominated at external-client scales."""

    def __init__(self, net: TcpNet) -> None:
        self.net = net

    def allreduce(self, data: np.ndarray) -> np.ndarray:
        """Elementwise sum across all ranks; every rank gets the result."""
        n, r = self.net.size, self.net.rank
        if n <= 1:
            return np.asarray(data).copy()
        flat = np.asarray(data).reshape(-1)
        pad = (-flat.size) % n
        work = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        chunks = np.split(work.copy(), n)
        right = (r + 1) % n
        left = (r - 1) % n
        # ring reduce-scatter: after n-1 steps chunk (r+1)%n is fully reduced
        for step in range(n - 1):
            send_idx = (r - step) % n
            recv_idx = (r - step - 1) % n
            got = self.net.send_recv(right, [chunks[send_idx]], left)
            if got is None:
                log.fatal("allreduce: transport shut down mid-collective")
            chunks[recv_idx] = chunks[recv_idx] + got[0]
        # ring allgather of the reduced chunks
        for step in range(n - 1):
            send_idx = (r - step + 1) % n
            recv_idx = (r - step) % n
            got = self.net.send_recv(right, [chunks[send_idx]], left)
            if got is None:
                log.fatal("allreduce: transport shut down mid-collective")
            chunks[recv_idx] = got[0]
        out = np.concatenate(chunks)
        if pad:
            out = out[:flat.size]
        return out.reshape(np.asarray(data).shape)

    def allgather(self, data: np.ndarray) -> List[np.ndarray]:
        """Every rank's array, in rank order (reference Allgather parity)."""
        n, r = self.net.size, self.net.rank
        parts: List[Optional[np.ndarray]] = [None] * n
        parts[r] = np.asarray(data).copy()
        right = (r + 1) % n
        left = (r - 1) % n
        for step in range(n - 1):
            send_idx = (r - step) % n
            got = self.net.send_recv(right, [parts[send_idx]], left)
            if got is None:
                log.fatal("allgather: transport shut down mid-collective")
            parts[(r - step - 1) % n] = got[0]
        return parts  # type: ignore[return-value]
