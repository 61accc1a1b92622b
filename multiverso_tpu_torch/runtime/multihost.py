"""Cross-process (multi-host) lockstep PS runtime (port of
``multiverso_tpu/runtime/multihost.py``).

Reference capability (not copied): the reference scaled its parameter
server by adding MPI/ZMQ ranks — tables were range-sharded across server
ranks, each running its own Server actor, and ``RegisterNode`` grew the
membership (``src/zoo.cpp:73-145``, ``include/multiverso/net/mpi_net.h``).

Several OS processes form one ``torch.distributed`` world
(:func:`init_distributed`); each rank holds its own contiguous row range of
every matrix and array table as a tensor on its device
(``parallel/mesh.table_sharding``), and the KV and sparse kinds whole. What
MPI message ordering did for the reference, LOCKSTEP REPLAY does here, as
in the JAX package: rank 0 (the leader) runs the real dispatcher (async /
BSP / SSP / deterministic — all consistency logic lives there only) and
broadcasts each table-executing request descriptor over a small TCP
control plane; follower ranks replay the identical stream on one replay
thread, so every rank issues the same collectives in the same order.

What crosses between ranks, and on what:

* the TCP control plane carries descriptors (ids + host payloads), acks,
  the barrier (:meth:`MultihostRuntime.barrier`) and the host allreduce
  behind ``mvt.aggregate`` (:meth:`MultihostRuntime.allreduce_host`, the
  leader first, then the ranks in order);
* the process group carries table bytes, as host tensors over gloo
  (``all_gather`` of each rank's OWNED rows, then a select by owner: no
  sum, so a ``-0.0`` stays ``-0.0``): a Get's rows, a whole-table or
  snapshot read, and the word2vec block transaction's candidate rows.
  Every collective runs on the leader's dispatcher thread or a follower's
  replay thread (:meth:`MultihostRuntime._check_collective_thread`), in
  descriptor order; gloo pairs collectives by their order on the group.

An Add needs no collective: every rank replays the same host payload and
applies only the rows it owns (its row kernels run on its own shard).

Completion routing:

* follower worker GETs complete at REPLAY time on the origin rank with the
  result every rank assembled — the rows crossed on the process group, not
  the control plane;
* follower worker ADDs complete via a small ``ack`` from the leader at
  whatever point the leader's server semantics complete them (enqueue
  for deferred-apply servers, apply otherwise), preserving each server
  type's contract.

Request payloads must be host data (numpy / options); the device-IO fast
paths are in-process-only and are disabled on every rank in multihost
mode (``supports_device_io`` is False on the table proxies). The control
frames pickle this package's classes, so a world does not mix JAX and
port ranks; the hello frame's bytes are the JAX package's.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_lib
import io
import json
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import gauge_set, monitor
from multiverso_tpu_torch.obs.trace import hop
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.net import _tune_socket
from multiverso_tpu_torch.utils.backoff import Backoff

# flags: multihost_endpoint / multihost_timeout / multihost_window /
# multihost_token (defined in config.py)

_LEN = struct.Struct("<q")

# -- handshake frame (NON-pickle: struct + json, nothing code-executing) ----
#
# Trust model (docs/multihost.md): post-handshake control frames are pickle
# and assume a private, firewalled interconnect — but the HANDSHAKE never
# unpickles. Both directions exchange a fixed struct header + json body +
# HMAC-SHA256 tag keyed on the `multihost_token` flag, so (a) a scanner or
# stray client hitting the leader port is dropped before any pickle.loads,
# (b) a follower dialing a wrong/stale endpoint fatals instead of replaying
# garbage, and (c) divergent consistency flags are a loud bring-up error,
# not a silent desync (the reference centralized this in its Controller
# register protocol, src/controller.cpp:46-72).
_HELLO_MAGIC = b"MVMH"
_HELLO_VERSION = 2
_HELLO_HDR = struct.Struct("<4sHII")  # magic, version, rank, json_len
_HELLO_MAX_JSON = 1 << 16

# flags every process of one lockstep world must agree on: they shape the
# server semantics, the worker-id grid, and the collective programs
_UNIFORM_FLAGS = ("sync", "ssp_staleness", "deterministic", "local_workers",
                  "remote_workers", "ma", "backup_worker_ratio",
                  "updater_type", "mesh_shape", "mesh_axes")


def init_distributed(coordinator: str, world: int, rank: int) -> None:
    """Form a ``torch.distributed`` gloo world of ``world`` processes; this
    one is ``rank``. ``coordinator`` is the ``host:port`` of the rendezvous
    store rank 0 hosts (not the control plane's ``multihost_endpoint``:
    two ports). Call it on every rank before ``mvt.init(
    multihost_endpoint=...)``. The process group's timeout is the
    ``multihost_timeout`` flag, so a dead rank fails a collective loudly
    instead of hanging for gloo's default 30 minutes.

    The world is gloo: it runs two ranks on ONE card (NCCL refuses that),
    and the table exchange moves host tensors, which NCCL does not take."""
    import datetime

    import torch.distributed as dist

    secs = float(config.get_flag("multihost_timeout"))
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=int(world), rank=int(rank),
                            timeout=datetime.timedelta(seconds=secs))


def world_of_process() -> Tuple[int, int]:
    """(rank, world) of this process's ``torch.distributed`` world; (0, 1)
    when none was formed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _hello_key() -> bytes:
    token = str(config.get_flag("multihost_token"))
    return hashlib.sha256(b"mv-multihost-v2:" + token.encode()).digest()


def _uniform_flags() -> Dict[str, Any]:
    return {name: config.get_flag(name) for name in _UNIFORM_FLAGS}


def _hello_frame(rank: int, world: int) -> bytes:
    body = json.dumps({"world": world, "flags": _uniform_flags()},
                      sort_keys=True).encode()
    head = _HELLO_HDR.pack(_HELLO_MAGIC, _HELLO_VERSION, rank, len(body))
    mac = hmac_lib.new(_hello_key(), head + body, hashlib.sha256).digest()
    return head + body + mac


def _read_hello(sock: socket.socket) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Read + authenticate one hello frame; None on any malformed input
    (never raises on garbage, never executes it)."""
    head = _read_exact(sock, _HELLO_HDR.size)
    if head is None:
        return None
    try:
        magic, version, rank, json_len = _HELLO_HDR.unpack(head)
    except struct.error:
        return None
    if magic != _HELLO_MAGIC or version != _HELLO_VERSION:
        return None
    if not 0 < json_len <= _HELLO_MAX_JSON:
        return None
    rest = _read_exact(sock, json_len + 32)
    if rest is None:
        return None
    body, mac = rest[:json_len], rest[json_len:]
    want = hmac_lib.new(_hello_key(), head + body, hashlib.sha256).digest()
    if not hmac_lib.compare_digest(mac, want):
        return None
    try:
        info = json.loads(body)
    except ValueError:
        return None
    if not isinstance(info, dict):
        return None
    return rank, info


def _check_uniform_flags(peer_name: str, info: Dict[str, Any],
                         world: int) -> None:
    """Fatal (naming the flag) when a peer's consistency-relevant flags
    differ from ours — divergent server semantics would desync silently."""
    if info.get("world") != world:
        log.fatal("multihost: %s runs a world of %s, this process expects "
                  "%d — every process must pass the same topology",
                  peer_name, info.get("world"), world)
    theirs = info.get("flags")
    if not isinstance(theirs, dict):
        log.fatal("multihost: %s hello carries no flag digest", peer_name)
    mine = _uniform_flags()
    diff = [k for k in _UNIFORM_FLAGS if theirs.get(k) != mine[k]]
    if diff:
        detail = ", ".join(f"-{k}={theirs.get(k)!r} vs local {mine[k]!r}"
                           for k in diff)
        log.fatal("multihost: flag mismatch with %s — every process of a "
                  "lockstep world must run identical consistency flags: %s",
                  peer_name, detail)


def _require_gloo_world() -> None:
    """The table exchange runs on the default process group, which must be
    a gloo world (see :func:`init_distributed`): fatal otherwise."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        log.fatal("multihost: no torch.distributed world — call "
                  "init_distributed(coordinator, world, rank) first")
    if dist.get_backend() != "gloo":
        log.fatal("multihost: the world runs on %r; the table exchange "
                  "needs gloo — form it with init_distributed",
                  dist.get_backend())


def _frame_obj(obj: Any) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


class _ObjWriter:
    """Per-socket control-plane writer: frames queue on the caller's
    thread and a drain thread flushes everything queued while the
    previous send was in flight in ONE syscall — the control-plane
    analog of the wire's coalescing drain loop, so a burst of forwarded
    ops / acks / descriptors costs one write instead of a locked
    pickle+sendall each. The queue is byte-bounded: a wedged peer still
    exerts the backpressure the old blocking sendall provided (which the
    leader's outcome-retention bound relies on)."""

    def __init__(self, sock: socket.socket, name: str,
                 on_error: Optional[Callable[[BaseException], None]] = None,
                 max_bytes: int = 2 << 20) -> None:
        self._sock = sock
        self._on_error = on_error
        self._max = int(max_bytes)
        self._cv = threading.Condition()
        self._frames: deque = deque()
        self._bytes = 0
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def send(self, obj: Any) -> None:
        self.send_raw(_frame_obj(obj))

    def send_raw(self, framed: bytes) -> None:
        """Queue one pre-framed payload (the broadcast paths pickle once
        and hand the same bytes to every peer's writer)."""
        with self._cv:
            self._cv.wait_for(lambda: self._bytes < self._max
                              or self._error is not None or self._closed)
            if self._error is not None:
                raise OSError(f"control-plane writer failed: "
                              f"{self._error!r}")
            if self._closed:
                raise OSError("control-plane writer closed")
            self._frames.append(framed)
            self._bytes += len(framed)
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._frames or self._closed)
                if not self._frames:
                    return  # closed and fully drained
                batch = b"".join(self._frames)
                self._frames.clear()
            try:
                self._sock.sendall(batch)
            except OSError as exc:
                with self._cv:
                    self._error = exc
                    self._frames.clear()
                    self._bytes = 0
                    self._cv.notify_all()
                if self._on_error is not None:
                    self._on_error(exc)
                return
            with self._cv:
                self._bytes -= len(batch)
                self._cv.notify_all()

    def close(self, timeout: float = 5.0) -> None:
        """Flush whatever is queued, then stop the drain thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)


class _ForwardWindow:
    """Sliding window over follower-origin table ops in flight to the
    leader: ``acquire`` hands out the next sequence number (blocking once
    ``multihost_window`` ops are unacknowledged), ``release`` retires one.
    Acks arrive in the leader's COMPLETION order, not submission order
    (async applies, BSP defers), so out-of-order releases park in the
    acked set — the reorder buffer — until the cumulative floor reaches
    them. ``size=0`` leaves the pipeline unbounded."""

    def __init__(self, size: int) -> None:
        self._size = int(size)
        self._cv = threading.Condition()
        self._next = 0
        self._floor = 0
        self._acked: set = set()
        self._dead = False

    def _in_flight(self) -> int:
        return self._next - self._floor - len(self._acked)

    def acquire(self) -> int:
        with self._cv:
            if self._size > 0:
                self._cv.wait_for(lambda: self._dead
                                  or self._in_flight() < self._size)
            self._next += 1
            gauge_set("MULTIHOST_WINDOW_INFLIGHT", self._in_flight())
            return self._next

    def release(self, seq: int) -> None:
        with self._cv:
            if seq <= self._floor or seq in self._acked:
                return  # duplicate ack — already retired
            self._acked.add(seq)
            while (self._floor + 1) in self._acked:
                self._acked.remove(self._floor + 1)
                self._floor += 1
            gauge_set("MULTIHOST_WINDOW_INFLIGHT", self._in_flight())
            self._cv.notify_all()

    def fail_all(self) -> None:
        """Poison path: wake every blocked acquirer (their post-wake
        poison check turns the wake into a loud fatal)."""
        with self._cv:
            self._dead = True
            self._cv.notify_all()


def _recv_obj(sock: socket.socket) -> Any:
    header = _read_exact(sock, _LEN.size)
    if header is None:
        return None
    n = _LEN.unpack(header)[0]
    body = _read_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class _Forwarded:
    """A follower-origin request riding through the leader's server: the
    origin/msg_id pair travels WITH the request so deferred servers
    (BSP/deterministic) keep it attached through their pending queues and
    the lockstep wrapper can stamp it onto the broadcast descriptor."""

    __slots__ = ("origin", "msg_id", "request")

    def __init__(self, origin: int, msg_id: int, request: Any) -> None:
        self.origin = origin
        self.msg_id = msg_id
        self.request = request


class _ForwardCompletion:
    """Leader-side completion for a follower-origin request.

    ADDs ack over TCP at the moment the leader's server completes them —
    enqueue-time for deferred-apply servers, apply-time otherwise — so
    each server type's add contract survives the process hop. GET
    results are NOT shipped: the origin rank assembles the identical
    value itself when it replays the op (the rows cross on the process
    group)."""

    __slots__ = ("_runtime", "_origin", "_msg_id", "_seq", "_is_add")

    def __init__(self, runtime: "MultihostRuntime", origin: int,
                 msg_id: int, seq: int, is_add: bool) -> None:
        self._runtime = runtime
        self._origin = origin
        self._msg_id = msg_id
        self._seq = seq
        self._is_add = is_add

    def done(self, result: Any) -> None:
        if not self._is_add:
            return  # origin completes at replay with the local result
        if result is not None and not _is_host_payload(result):
            log.error("multihost: dropping non-host fused add reply "
                      "(device payloads cannot cross the control plane)")
            result = None
        self._runtime._send_to(self._origin,
                               ("ack", self._seq, self._msg_id, result))

    def fail(self, error: BaseException) -> None:
        self._runtime._send_to(
            self._origin, ("fail", self._seq, self._msg_id, repr(error)))


class _NullSink:
    """Write-discarding stream for follower-side snapshot replay (avoids
    buffering a full table copy nobody reads)."""

    def write(self, data: bytes) -> int:
        return len(data)


def _is_host_payload(obj: Any) -> bool:
    if obj is None or isinstance(obj, (int, float, str, bytes, np.ndarray)):
        return True
    if isinstance(obj, (tuple, list)):
        return all(_is_host_payload(x) for x in obj)
    return False


class LockstepTable:
    """Leader-side ServerTable wrapper: broadcast-then-execute.

    Registered in the leader's server in place of the inner table, so
    EVERY device-executing path (direct applies, BSP drains,
    deterministic round drains, admin reads, checkpoint stores) emits a
    descriptor before it runs — the one invariant multi-controller SPMD
    needs."""

    def __init__(self, inner: Any, runtime: "MultihostRuntime") -> None:
        self._inner = inner
        self._runtime = runtime

    # table_id assignment flows through to the inner table
    @property
    def table_id(self) -> int:
        return self._inner.table_id

    @table_id.setter
    def table_id(self, value: int) -> None:
        self._inner.table_id = value

    def merge_add_requests(self, requests):
        """No fusing under a lockstep world: every process_add broadcasts
        its EXACT request to the followers for replay, and forwarded ops
        retire per (origin, msg_id) out of the window — a merged request
        would desync that bookkeeping. (Without this override __getattr__
        would forward to the inner table's merge.) The dispatcher falls
        back to per-message dispatch, the pre-batching behavior."""
        return None

    def process_add(self, request: Any) -> Any:
        origin, msg_id, request = self._split(request)
        if (isinstance(request, tuple) and request
                and isinstance(request[0], str) and request[0] == "transact"):
            log.fatal("raw-closure device transactions are in-process "
                      "only; use a NAMED transaction "
                      "(mv.register_program + transact_device_async(name, "
                      "...)) — the one device-transaction form that rides "
                      "the lockstep stream — or the staged host path")
        seq = self._runtime.broadcast_exec("add", self.table_id, origin,
                                           msg_id, request)
        return self._runtime.run_recorded(seq, "add",
                                          lambda: self._inner.process_add(
                                              request))

    def process_get(self, request: Any) -> Any:
        origin, msg_id, request = self._split(request)
        self._runtime.broadcast_exec("get", self.table_id, origin, msg_id,
                                     request)
        return self._inner.process_get(request)

    def store(self, stream) -> None:
        """Snapshot through the DISPATCHER: the device->host read is a
        collective, so it must be serialized into the lockstep stream —
        checkpoint threads cannot broadcast+execute themselves without
        racing table traffic. The callable below runs on the dispatcher
        thread: broadcast, then read; followers replay the identical
        collective into a discarded sink."""
        def run():
            seq = self._runtime.broadcast_exec("store", self.table_id, -1,
                                               0, None)
            self._runtime.run_recorded(seq, "store",
                                       lambda: self._inner.store(stream))

        self._runtime.run_on_dispatcher(run)

    def load(self, stream) -> None:
        """Restore through the dispatcher: the leader reads the whole
        per-table checkpoint frame and broadcasts the BYTES, so every
        process rebuilds identical device state in lockstep order (safe
        even against live traffic — the dispatcher serializes it)."""
        payload = stream.read(-1)

        def run():
            seq = self._runtime.broadcast_exec("load", self.table_id, -1,
                                               0, payload)
            self._runtime.run_recorded(seq, "load",
                                       lambda: self._inner.load(
                                           io.BytesIO(payload)))

        self._runtime.run_on_dispatcher(run)

    @staticmethod
    def _split(request: Any) -> Tuple[int, int, Any]:
        if isinstance(request, _Forwarded):
            return request.origin, request.msg_id, request.request
        return -1, 0, request

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class FollowerServer:
    """``Zoo.server`` stand-in on follower ranks: forwards local worker
    requests to the leader and replays the leader's lockstep stream on a
    single replay thread (the only thread that runs table collectives)."""

    def __init__(self, runtime: "MultihostRuntime") -> None:
        self._runtime = runtime
        self._tables: Dict[int, Any] = {}
        self.wal = None  # followers never serve the wire; Server surface parity
        # the leader's server semantics, recomputed from the (identical)
        # flags — clients consult these capability bits
        self.gates_gets = (bool(config.get_flag("sync"))
                           or int(config.get_flag("ssp_staleness")) >= 0)
        self.defers_adds = (not self.gates_gets
                            and bool(config.get_flag("deterministic")))

    @property
    def plain_async(self) -> bool:
        # raw-closure device IO stays in-process-only regardless of the
        # leader's server type (payloads cannot cross the control plane)
        return False

    @property
    def supports_named_transact(self) -> bool:
        """Named transactions DO cross processes: the descriptor carries
        a program name + host args, every rank resolves and runs its own
        registration of the same program (runtime/programs.py). Admissible
        exactly when the leader's server is plain async — recomputed from
        the (handshake-enforced identical) flags."""
        return not (self.gates_gets or self.defers_adds)

    def start(self) -> None:
        self._runtime.start_follower(self)

    def stop(self) -> None:
        pass  # the runtime owns the replay thread; Zoo.stop closes it

    def register_table(self, server_table: Any) -> int:
        table_id = len(self._tables)
        # stamp before visibility — replayed descriptors reference the id
        # the moment the leader-side registration barrier releases
        server_table.table_id = table_id
        self._tables[table_id] = server_table
        return table_id

    def table(self, table_id: int) -> Any:
        return self._tables[table_id]

    def send(self, msg: Message) -> None:
        completion = msg.data[-1] if msg.data else None
        request = msg.data[0] if msg.data else None
        seq = 0
        if completion is not None:
            # windowed pipeline: take the next forward sequence number,
            # blocking once multihost_window ops are unacknowledged —
            # backpressure instead of unbounded leader-side queueing
            seq = self._runtime.acquire_window()
            self._runtime.register_pending(msg.msg_id, completion, seq)
        hop(msg.req_id, "follower_forward")
        # follower hop cost (serialize + control-plane enqueue): the
        # same-named histogram gives its distribution via mv.stats/render
        with monitor("FOLLOWER_FORWARD_MSG"):
            # req_id rides as an optional trailing element — old leaders
            # reading the 7-tuple shape still parse the prefix
            self._runtime.send_to_leader(
                ("req", seq, int(msg.type), msg.table_id, msg.src,
                 msg.msg_id, request, msg.req_id))

    # replay executor ------------------------------------------------------
    def execute(self, seq: int, op: str, table_id: int, origin: int,
                msg_id: int, request: Any) -> None:
        mine = origin == self._runtime.rank
        try:
            table = self._tables[table_id]
            if op == "add":
                with monitor("FOLLOWER_REPLAY_ADD_MSG"):
                    result = table.process_add(request)
            elif op == "get":
                with monitor("FOLLOWER_REPLAY_GET_MSG"):
                    result = table.process_get(request)
            elif op == "store":
                # only the collective (device->host read) matters here;
                # the bytes go to a null sink — the leader owns the file
                table.store(_NullSink())
                result = None
            elif op == "load":
                table.load(io.BytesIO(request))
                result = None
            else:
                log.fatal("multihost replay: unknown op %r", op)
        except Exception as exc:
            if op != "get":
                # a mutating replay failure is either a bad request every
                # rank rejects identically (benign) or true divergence
                # (the leader applied it). Only the leader knows which:
                # report and let it adjudicate — it absolves a shared
                # failure, or sends a targeted poison for divergence
                # (round-4 advisor #2, refined: unconditional poison here
                # let one malformed request kill every follower)
                log.error("multihost replay %s on table %d failed (%r); "
                          "reporting to the leader for adjudication", op,
                          table_id, exc)
                self._runtime.report_mut_failure(seq, f"{op}: {exc!r}")
            else:
                log.error("multihost replay %s on table %d failed: %r",
                          op, table_id, exc)
            if mine:
                self._runtime.fail_pending(msg_id, exc)
            return
        named_txn = (op == "add" and isinstance(request, tuple) and request
                     and isinstance(request[0], str)
                     and request[0] == "transact_named")
        if mine and (op == "get" or named_txn):
            # the locally-assembled result (GET rows / a transaction's
            # device reply) completes the origin's pending request — the
            # rows rode the process group, never the control plane
            self._runtime.complete_pending(msg_id, result)


class MultihostRuntime:
    """Control plane: leader accept/forward loops, follower replay loop,
    broadcast ordering, cross-process barrier."""

    def __init__(self, rank: int, world: int, endpoint: str) -> None:
        self.rank = rank
        self.world = world
        self._endpoint = endpoint
        # the follower's replay thread, the one thread there allowed to
        # run the table exchange
        self._replay_thread: Optional[threading.Thread] = None
        # (seconds, bytes sent) of each table exchange, newest last: what a
        # Get's rows cost on the process group
        self.exchange_log: deque = deque(maxlen=65536)
        self._timeout = float(config.get_flag("multihost_timeout"))
        self._seq = 0
        self._stopping = threading.Event()
        # follower-side: outstanding local requests (msg_id -> (completion,
        # forward-window seq)) plus the sliding window over forwards
        self._pending: Dict[int, Tuple[Any, int]] = {}
        self._pending_lock = threading.Lock()
        self._window = _ForwardWindow(int(config.get_flag(
            "multihost_window")))
        # leader-side: follower sockets by rank, each with a coalescing
        # control-plane writer (descriptors/acks batch per syscall)
        self._conns: Dict[int, socket.socket] = {}
        self._writers: Dict[int, _ObjWriter] = {}
        self._leader_writer: Optional[_ObjWriter] = None
        self._threads: List[threading.Thread] = []
        self._barrier_arrivals = 0
        self._barrier_cv = threading.Condition()
        self._barrier_release = threading.Event()
        self._server: Optional[Any] = None        # leader: real Server
        self._follower: Optional[FollowerServer] = None
        self._leader_sock: Optional[socket.socket] = None
        # poison: set when this rank can no longer uphold the lockstep
        # invariant (leader died, a mutating replay failed) — every later
        # control-plane interaction fails LOUDLY instead of diverging
        self._poisoned: Optional[str] = None
        # leader-side outcomes of broadcast MUTATING ops, for adjudicating
        # follower divergence reports (see run_recorded/_adjudicate)
        self._outcomes: Dict[int, bool] = {}
        self._outcome_floor = 0  # lowest seq still retained after pruning
        self._outcome_cv = threading.Condition()
        # cross-process host allreduce (mv.aggregate's global leg)
        self._agg_seq = 0
        self._agg_cv = threading.Condition()
        self._agg_contrib: Dict[int, Tuple[int, List[Any]]] = {}
        self._agg_event = threading.Event()
        self._agg_payload: Optional[Tuple[int, List[Any]]] = None

    # -- bring-up ----------------------------------------------------------
    def connect(self) -> None:
        _require_gloo_world()
        host, port = self._endpoint.rsplit(":", 1)
        # ONE monotonic deadline governs the whole bring-up: rejected
        # handshakes (scanners, drip-feeders) consume the same budget as
        # everything else instead of restarting the clock per accept
        deadline = time.monotonic() + self._timeout
        if self.rank == 0:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((host, int(port)))
            listener.listen(self.world)
            while len(self._conns) < self.world - 1:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(set(range(1, self.world))
                                     - set(self._conns))
                    log.fatal("multihost: follower rank(s) %s never "
                              "completed the handshake with %s within "
                              "%.0fs", missing, self._endpoint,
                              self._timeout)
                listener.settimeout(remaining)
                try:
                    conn, _addr = listener.accept()
                except TimeoutError:
                    continue  # deadline check at loop top fatals
                _tune_socket(conn)
                # bound the hello read too: an accepted connection that
                # never speaks must not wedge bring-up past the deadline
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                try:
                    hello = _read_hello(conn)
                except OSError:
                    hello = None
                if hello is None:
                    log.error("multihost: dropping connection with bad or "
                              "unauthenticated handshake (wrong "
                              "multihost_token?)")
                    conn.close()
                    continue
                peer, info = hello
                if not 1 <= peer < self.world or peer in self._conns:
                    log.fatal("multihost: follower handshake claims rank "
                              "%d (world %d, already connected: %s)",
                              peer, self.world, sorted(self._conns))
                _check_uniform_flags(f"follower rank {peer}", info,
                                     self.world)
                # ack: authenticates the leader back and confirms admission
                conn.sendall(_hello_frame(0, self.world))
                conn.settimeout(None)
                self._conns[peer] = conn
                self._writers[peer] = _ObjWriter(
                    conn, name=f"mv-multihost-send-{peer}")
            listener.close()
            for peer, conn in self._conns.items():
                t = threading.Thread(target=self._leader_recv_loop,
                                     args=(peer, conn),
                                     name=f"mv-multihost-recv-{peer}",
                                     daemon=True)
                t.start()
                self._threads.append(t)
        else:
            sock = None
            bo = Backoff(base=0.1, cap=1.0, deadline=deadline)
            while True:
                try:
                    sock = socket.create_connection(
                        (host, int(port)),
                        timeout=max(1.0, deadline - time.monotonic()))
                    break
                except OSError:
                    # the leader may not have bound yet — retry on the
                    # shared jittered backoff until the handshake window
                    # closes (jitter matters here: every follower in the
                    # job races the same bind)
                    if not bo.wait():
                        log.fatal("multihost: cannot reach leader at %s "
                                  "within %.0fs", self._endpoint,
                                  self._timeout)
            _tune_socket(sock)
            sock.settimeout(max(1.0, deadline - time.monotonic()))
            sock.sendall(_hello_frame(self.rank, self.world))
            try:
                ack = _read_hello(sock)
            except OSError:
                ack = None
            if ack is None:
                log.fatal("multihost: leader at %s did not return an "
                          "authenticated ack — wrong endpoint, wrong "
                          "multihost_token, or a flag mismatch the leader "
                          "rejected (see its log)", self._endpoint)
            _check_uniform_flags("the leader", ack[1], self.world)
            sock.settimeout(None)
            self._leader_sock = sock
            self._leader_writer = _ObjWriter(
                sock, name="mv-multihost-send-leader",
                on_error=lambda exc: self.poison(
                    f"cannot reach the leader (rank 0): {exc!r}"))
            # the reader thread exists from bring-up on (not only once a
            # FollowerServer attaches): MA-mode worlds have no PS but
            # still barrier and aggregate over this socket
            t = threading.Thread(target=self._replay_loop,
                                 name="mv-multihost-replay", daemon=True)
            self._replay_thread = t
            t.start()
            self._threads.append(t)

    def attach_leader(self, server: Any) -> None:
        self._server = server

    # -- table exchange (process-group collectives) -------------------------
    def _check_collective_thread(self) -> None:
        """Table collectives run on the leader's dispatcher thread or a
        follower's replay thread only: gloo pairs collectives by their
        order on the group, so a collective from any other thread (or a
        second thread) would pair with the wrong peer call and desync or
        hang the world. Fatal, not a quiet fallback."""
        if self.rank == 0:
            expected = getattr(self._server, "_thread", None)
        else:
            expected = self._replay_thread
        if threading.current_thread() is not expected:
            log.fatal("multihost: a table collective ran on thread %s, off "
                      "the %s — route it through the lockstep stream",
                      threading.current_thread().name,
                      "dispatcher" if self.rank == 0 else "replay thread")

    def _all_gather(self, arr: np.ndarray) -> List[np.ndarray]:
        """Every rank's ``arr`` (same shape and dtype on every rank), as
        raw bytes over the exchange group: bitwise, for any dtype."""
        import torch
        import torch.distributed as dist

        self._check_collective_thread()
        arr = np.ascontiguousarray(arr)
        flat = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        outs = [torch.empty_like(flat) for _ in range(self.world)]
        t0 = time.perf_counter()
        try:
            dist.all_gather(outs, flat)
        except Exception as exc:
            log.fatal("multihost: table exchange (all_gather of %d bytes) "
                      "failed: %r", flat.numel(), exc)
        self.exchange_log.append((time.perf_counter() - t0, flat.numel()))
        return [o.numpy().view(arr.dtype).reshape(arr.shape) for o in outs]

    def exchange_rows(self, owner: np.ndarray, mine: np.ndarray
                      ) -> np.ndarray:
        """Rows of a request whose row ``i`` rank ``owner[i]`` holds:
        ``mine`` is THIS rank's owned rows in request order (``owner ==
        rank``). Each rank sends only its owned rows (padded to the
        largest rank's count) and every rank places each peer's rows at
        that peer's positions — a select by owner, never a sum. Every rank
        gets the whole reply. Collective: runs on every rank with the same
        ``owner``."""
        owner = np.asarray(owner)
        counts = np.bincount(owner, minlength=self.world)
        most = int(counts.max()) if owner.size else 0
        out = np.empty((owner.size,) + mine.shape[1:], mine.dtype)
        if most == 0:
            return out
        send = np.zeros((most,) + mine.shape[1:], mine.dtype)
        send[: len(mine)] = mine
        for r, rows in enumerate(self._all_gather(send)):
            out[owner == r] = rows[: counts[r]]
        return out

    def assemble(self, local: np.ndarray, ranges: List[Tuple[int, int]],
                 axis: int = 0) -> np.ndarray:
        """The logical array from every rank's range ``ranges[r]`` along
        ``axis`` (``local`` is this rank's): each rank's block is padded to
        the largest and gathered. Collective, like ``exchange_rows``."""
        most = max(hi - lo for lo, hi in ranges)
        local = np.moveaxis(np.asarray(local), axis, 0)
        send = np.zeros((most,) + local.shape[1:], local.dtype)
        send[: local.shape[0]] = local
        parts = [rows[: hi - lo] for rows, (lo, hi)
                 in zip(self._all_gather(send), ranges)]
        return np.moveaxis(np.concatenate(parts, axis=0), 0, axis)

    def wrap_table(self, server_table: Any) -> LockstepTable:
        return LockstepTable(server_table, self)

    def start_follower(self, follower: FollowerServer) -> None:
        # the reader thread already runs (spawned at connect); replay
        # descriptors only start flowing once tables are registered, which
        # is barrier-gated after this attach
        self._follower = follower

    # -- leader side -------------------------------------------------------
    def run_on_dispatcher(self, fn: Any) -> Any:
        """Execute ``fn`` on the leader's dispatcher thread, serialized
        with table traffic (delegates to Server.run_serialized — the
        shared quiesced-execution primitive; re-entrant)."""
        return self._server.run_serialized(fn, timeout=self._timeout)

    def broadcast_exec(self, op: str, table_id: int, origin: int,
                       msg_id: int, request: Any) -> int:
        """Emit one lockstep descriptor to every follower. Must run on
        the leader's dispatcher thread — that single thread's execution
        order IS the collective program order every process must share;
        a broadcast from any other thread could interleave differently
        with the leader's own executions."""
        expected = getattr(self._server, "_thread", None)
        if expected is not None and threading.current_thread() is not expected:
            log.fatal("multihost: broadcast_exec off the dispatcher thread "
                      "(%s) — route through run_on_dispatcher",
                      threading.current_thread().name)
        # pickle BEFORE consuming a sequence number: a non-serializable
        # request must fail only itself, not desync every follower's
        # expected seq (the fatal propagates to the requester's completion
        # via Server._main; the lockstep stream stays consistent)
        desc = ("exec", self._seq + 1, op, table_id, origin, msg_id, request)
        try:
            payload = pickle.dumps(desc, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as exc:
            log.fatal("multihost: request is not host-serializable (%r) — "
                      "device-array payloads cannot cross processes; use "
                      "the host add/get paths", exc)
        self._seq += 1
        # pickled ONCE; each peer's coalescing writer queues the same
        # framed bytes — descriptors emitted while a previous write is in
        # flight flush together in one syscall per follower
        framed = _LEN.pack(len(payload)) + payload
        for peer in sorted(self._writers):
            writer = self._writers.get(peer)  # recv-crash handler pops
            if writer is None:                # concurrently on its thread
                continue
            try:
                writer.send_raw(framed)
            except OSError as exc:
                # a peer that missed a descriptor can never rejoin the
                # stream — drop it loudly; its absence surfaces at the
                # next collective (gloo) rather than as silent corruption
                log.error("multihost: lost follower %d mid-broadcast (%r);"
                          " dropping it from the control plane", peer, exc)
                self._drop_follower(peer)
        return self._seq

    def _drop_follower(self, peer: int) -> None:
        self._conns.pop(peer, None)
        writer = self._writers.pop(peer, None)
        if writer is not None:
            writer.close(timeout=0.1)

    def run_recorded(self, seq: int, op: str, fn: Any) -> Any:
        """Execute a broadcast MUTATING op on the leader and record its
        outcome so follower divergence reports (``mut_failed``) can be
        adjudicated: a failure the leader shares is a bad request every
        rank skipped identically (absolve); a failure only the follower
        hit means its replica diverged (targeted poison)."""
        try:
            result = fn()
        except BaseException as exc:
            self._record_outcome(seq, ok=False)
            raise exc
        self._record_outcome(seq, ok=True)
        return result

    def _record_outcome(self, seq: int, ok: bool) -> None:
        with self._outcome_cv:
            self._outcomes[seq] = ok
            # Retention must exceed the deepest possible replay lag: the
            # per-follower writer queue is byte-bounded (2 MiB) so
            # broadcast_exec blocks once a follower falls that far
            # behind (natural backpressure), bounding in-flight
            # descriptors to a few thousand — 64k retained outcomes is
            # far beyond that, and an int->bool entry is tiny
            if len(self._outcomes) > 65536:
                for s in sorted(self._outcomes)[:32768]:
                    del self._outcomes[s]
                self._outcome_floor = min(self._outcomes)
            self._outcome_cv.notify_all()

    def _adjudicate(self, peer: int, seq: int, err: str) -> None:
        """Leader response to a follower's mutating-replay failure. Runs
        on that peer's recv thread (blocking it pauses only that peer)."""
        with self._outcome_cv:
            if seq < self._outcome_floor:
                # pruned: the follower lagged beyond every plausible
                # backpressure bound and the evidence is gone — poison
                # honestly (cannot prove the replica did NOT diverge)
                self._send_to(peer, ("poison",
                                     f"replay of op seq {seq} failed "
                                     f"({err}) and the leader no longer "
                                     "retains its outcome — cannot rule "
                                     "out divergence"))
                return
            known = self._outcome_cv.wait_for(
                lambda: seq in self._outcomes, timeout=self._timeout)
            leader_ok = self._outcomes.get(seq, True)
        if not known:
            # the leader never finished executing seq — it is likely stuck
            # in the collective the follower failed to join; the cluster
            # cannot make progress either way
            self._send_to(peer, ("poison",
                                 f"replay of op seq {seq} failed ({err}) "
                                 "and the leader's own execution never "
                                 "completed — cluster wedged"))
        elif leader_ok:
            log.error("multihost: follower %d DIVERGED on seq %d (%s) — "
                      "the leader applied it; poisoning that rank", peer,
                      seq, err)
            self._send_to(peer, ("poison",
                                 f"replay of mutating op seq {seq} failed "
                                 f"({err}) but the leader applied it — "
                                 "this rank's replica diverged"))
        else:
            log.info("multihost: rank %d and the leader both rejected "
                     "seq %d (%s) — bad request, every replica skipped "
                     "it identically", peer, seq, err)

    def _leader_recv_loop(self, peer: int, conn: socket.socket) -> None:
        try:
            self._leader_recv_body(peer, conn)
        except Exception:  # noqa: BLE001
            # a dying recv thread must WEDGE nothing: log with traceback
            # and close the socket so the follower sees EOF and poisons
            # itself loudly (silent thread death stranded a whole world)
            import traceback
            log.error("multihost: recv loop for follower %d crashed:\n%s",
                      peer, traceback.format_exc())
            try:
                conn.close()
            except OSError:
                pass
            self._drop_follower(peer)

    def _leader_recv_body(self, peer: int, conn: socket.socket) -> None:
        while True:
            obj = _recv_obj(conn)
            if obj is None:
                if not self._stopping.is_set():
                    log.error("multihost: lost follower %d", peer)
                return
            kind = obj[0]
            if kind == "req":
                # 8th element (the origin's trace req_id) is optional:
                # a 7-tuple from an older follower is an untraced forward
                (_, fwd_seq, msg_type, table_id, src, msg_id,
                 request) = obj[:7]
                req_id = obj[7] if len(obj) > 7 else 0
                msg_type = MsgType(msg_type)
                hop(req_id, "leader_recv_forward")
                data: List[Any] = []
                if msg_type.is_server_bound and msg_type in (
                        MsgType.Request_Add, MsgType.Request_Get):
                    # named transactions complete like GETs: the origin
                    # materializes the (device) reply at replay time —
                    # the leader must NOT ack, its device result cannot
                    # cross the control plane. (isinstance-str FIRST: a
                    # plain add's request[0] is an id ARRAY, and
                    # ndarray == str is an elementwise comparison whose
                    # truth value raises — it killed this recv thread)
                    named_txn = (isinstance(request, tuple) and request
                                 and isinstance(request[0], str)
                                 and request[0] == "transact_named")
                    completion = _ForwardCompletion(
                        self, peer, msg_id, fwd_seq,
                        is_add=(msg_type == MsgType.Request_Add
                                and not named_txn))
                    data = [_Forwarded(peer, msg_id, request), completion]
                self._server.send(Message(
                    src=src, dst=-1, type=msg_type, table_id=table_id,
                    msg_id=msg_id, req_id=int(req_id),
                    trace=bool(req_id), data=data))
            elif kind == "barrier_enter":
                with self._barrier_cv:
                    self._barrier_arrivals += 1
                    self._barrier_cv.notify_all()
            elif kind == "agg":
                _, src, seq, leaves = obj
                with self._agg_cv:
                    self._agg_contrib[src] = (seq, leaves)
                    self._agg_cv.notify_all()
            elif kind == "mut_failed":
                self._adjudicate(peer, obj[1], obj[2])
            elif kind == "bye":
                return
            else:
                log.error("multihost: unknown message %r from %d", kind,
                          peer)

    def _send_to(self, peer: int, obj: Any) -> None:
        if peer < 0:
            return
        writer = self._writers.get(peer)
        if writer is None:
            return
        try:
            writer.send(obj)
        except OSError as exc:
            log.error("multihost: send to %d failed: %r", peer, exc)

    # -- follower side -----------------------------------------------------
    @property
    def poisoned(self) -> Optional[str]:
        return self._poisoned

    def poison(self, reason: str) -> None:
        """Mark this rank as unable to uphold the lockstep invariant
        (leader died, a mutating replay diverged): fail every outstanding
        completion now and every later interaction loudly — a poisoned
        rank must never serve another value."""
        if self._poisoned is not None:
            return
        self._poisoned = reason
        log.error("multihost POISONED: %s", reason)
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        err = RuntimeError(f"multihost rank poisoned: {reason}")
        for completion, _seq in pending:
            try:
                completion.fail(err)
            except Exception:  # a dead waiter must not mask the rest
                pass
        # wake anything blocked on the control plane; their post-wake
        # poison check turns the wake into a loud fatal
        self._window.fail_all()
        self._agg_event.set()
        self._barrier_release.set()

    def _check_poison(self) -> None:
        if self._poisoned is not None:
            log.fatal("multihost rank poisoned: %s", self._poisoned)

    def report_mut_failure(self, seq: int, err: str) -> None:
        """Tell the leader this rank failed to replay mutating op ``seq``.
        Replay CONTINUES while the leader adjudicates: if the leader
        shared the failure (bad request) nothing happens; if the leader
        applied the op, a targeted poison arrives within one round trip —
        a bounded window traded for a deadlock-free protocol (the leader
        may still be blocked inside the very collective we failed to
        join, so waiting here could deadlock the reader thread)."""
        try:
            self._leader_writer.send(("mut_failed", seq, err))
        except OSError as exc:
            self.poison(f"cannot report divergence to the leader: {exc!r}")

    def send_to_leader(self, obj: Any) -> None:
        self._check_poison()
        try:
            self._leader_writer.send(obj)
        except OSError as exc:
            self.poison(f"cannot reach the leader (rank 0): {exc!r}")
            self._check_poison()

    def acquire_window(self) -> int:
        """Next forward sequence number; blocks while the window is full.
        A poison wake is loud, not a grant."""
        seq = self._window.acquire()
        self._check_poison()
        return seq

    def register_pending(self, msg_id: int, completion: Any,
                         seq: int = 0) -> None:
        self._check_poison()
        with self._pending_lock:
            self._pending[msg_id] = (completion, seq)
            # poison() may have drained _pending between the check above
            # and the insert — a completion registered after the drain
            # would wait forever. Re-check under the lock the drain
            # takes: either the drain saw our entry, or we see _poisoned.
            if self._poisoned is None:
                return
            if self._pending.pop(msg_id, None) is None:
                return  # the drain beat us to it and already failed it
        if seq:
            self._window.release(seq)
        completion.fail(RuntimeError(
            f"multihost rank poisoned: {self._poisoned}"))

    def _pop_pending(self, msg_id: int) -> Optional[Any]:
        with self._pending_lock:
            entry = self._pending.pop(msg_id, None)
        if entry is None:
            return None
        completion, seq = entry
        if seq:
            self._window.release(seq)
        return completion

    def complete_pending(self, msg_id: int, result: Any) -> None:
        completion = self._pop_pending(msg_id)
        if completion is not None:
            completion.done(result)

    def fail_pending(self, msg_id: int, exc: BaseException) -> None:
        completion = self._pop_pending(msg_id)
        if completion is not None:
            completion.fail(exc if isinstance(exc, Exception)
                            else RuntimeError(repr(exc)))

    def _replay_loop(self) -> None:
        try:
            self._replay_body()
        except Exception as exc:  # noqa: BLE001
            import traceback
            log.error("multihost: replay loop crashed:\n%s",
                      traceback.format_exc())
            self.poison(f"replay loop crashed: {exc!r}")

    def _replay_body(self) -> None:
        expect_seq = 0
        while self._poisoned is None:
            obj = _recv_obj(self._leader_sock)
            if obj is None:
                if not self._stopping.is_set():
                    # leader death is unrecoverable for a lockstep rank:
                    # poison so every in-flight and future request fails
                    # loudly instead of hanging (the reference worlds hung
                    # silently on a dead root)
                    self.poison("lost the leader (rank 0) connection — "
                                "the lockstep stream is gone; this rank "
                                "cannot continue")
                return
            kind = obj[0]
            if kind == "exec":
                _, seq, op, table_id, origin, msg_id, request = obj
                expect_seq += 1
                # poison (not log.fatal): a FatalError here would only
                # kill this daemon thread, leaving the rank unpoisoned
                # and every later op hanging — the exact silent failure
                # the poison mechanism exists to prevent
                if seq != expect_seq:
                    self.poison(f"replay out of order: seq {seq}, "
                                f"expected {expect_seq} — collective "
                                "stream corrupt")
                    return
                if self._follower is None:
                    self.poison("exec descriptor arrived on a rank with "
                                "no follower server (MA-mode worlds have "
                                "no PS tables)")
                    return
                self._follower.execute(seq, op, table_id, origin, msg_id,
                                       request)
            elif kind == "ack":
                # ("ack", fwd_seq, msg_id, result) — completion routes by
                # msg_id; the window retires fwd_seq through the reorder
                # buffer (acks complete in the leader's apply order, not
                # submission order)
                self.complete_pending(obj[2], obj[3])
            elif kind == "fail":
                self.fail_pending(obj[2], RuntimeError(obj[3]))
            elif kind == "agg_result":
                self._agg_payload = (obj[1], obj[2])
                self._agg_event.set()
            elif kind == "barrier_release":
                self._barrier_release.set()
            elif kind == "poison":
                # the leader adjudicated a divergence report against us
                self.poison(obj[1])
                return
            elif kind == "stop":
                self._stopping.set()
                return
            else:
                log.error("multihost: unknown descriptor %r", kind)

    # -- cross-process allreduce (mv.aggregate's global leg) ---------------
    def allreduce_host(self, leaves: List[Any]) -> List[Any]:
        """Elementwise-sum a list of numpy leaves across every process:
        followers ship their local sums to the leader, the leader reduces
        and broadcasts the global result — the cross-process half of
        ``MV_Aggregate`` (reference: ``MPI_Allreduce`` in
        ``include/multiverso/net/mpi_net.h:147-151``; contract shape:
        ``Test/test_allreduce.cpp:13-16``). COLLECTIVE: every process must
        call it the same number of times in the same order (enforced by a
        sequence check). One concurrent aggregate per process (Zoo's slot-0
        worker is the single caller). The sum runs in one fixed order —
        the leader's leaves first, then each follower's in rank order — so
        every rank gets the same bits."""
        self._check_poison()
        self._agg_seq += 1
        seq = self._agg_seq
        if self.rank == 0:
            with self._agg_cv:
                if not self._agg_cv.wait_for(
                        lambda: len(self._agg_contrib) >= self.world - 1,
                        timeout=self._timeout):
                    log.fatal("multihost aggregate timed out: %d/%d "
                              "follower contributions after %.0fs — a "
                              "rank is not calling mv.aggregate",
                              len(self._agg_contrib), self.world - 1,
                              self._timeout)
                contribs = dict(self._agg_contrib)
                self._agg_contrib.clear()
            total = [np.array(x, copy=True) for x in leaves]
            for src in sorted(contribs):
                peer_seq, peer_leaves = contribs[src]
                if peer_seq != seq:
                    log.fatal("multihost aggregate desynchronized: rank %d "
                              "is at call #%d, the leader at #%d — "
                              "aggregate is collective and must run in the "
                              "same order on every process", src, peer_seq,
                              seq)
                if len(peer_leaves) != len(total):
                    log.fatal("multihost aggregate: rank %d deposited %d "
                              "leaves, the leader %d", src,
                              len(peer_leaves), len(total))
                for i, leaf in enumerate(peer_leaves):
                    total[i] += np.asarray(leaf)
            # pickle ONCE, send the same framed bytes to every peer (the
            # payload is a model's leaves in MA mode — O(world x bytes)
            # re-serialization would stall every local worker on the
            # aggregate barrier)
            payload = pickle.dumps(("agg_result", seq, total),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            framed = _LEN.pack(len(payload)) + payload
            for peer in sorted(self._writers):
                writer = self._writers.get(peer)
                if writer is None:
                    continue
                try:
                    writer.send_raw(framed)
                except OSError as exc:
                    log.error("multihost: agg_result to %d failed: %r",
                              peer, exc)
            return total
        self._agg_event.clear()
        self.send_to_leader(("agg", self.rank, seq, leaves))
        if not self._agg_event.wait(self._timeout):
            log.fatal("multihost aggregate timed out after %.0fs waiting "
                      "for the global sum (leader stuck or a rank missing "
                      "its aggregate call)", self._timeout)
        self._check_poison()  # the wake may have been a poison, not a result
        got_seq, total = self._agg_payload
        if got_seq != seq:
            log.fatal("multihost aggregate: result for call #%d arrived "
                      "while waiting for #%d — collective order violated",
                      got_seq, seq)
        return total

    # -- barrier -----------------------------------------------------------
    def barrier(self) -> None:
        """Cross-process rendezvous over the control plane (the analog of
        the reference Controller's Barrier message round,
        ``src/controller.cpp:82-107``)."""
        if self.rank == 0:
            with self._barrier_cv:
                if not self._barrier_cv.wait_for(
                        lambda: self._barrier_arrivals >= self.world - 1,
                        timeout=self._timeout):
                    log.fatal("multihost barrier timed out "
                              "(%d/%d followers arrived)",
                              self._barrier_arrivals, self.world - 1)
                self._barrier_arrivals -= self.world - 1
            for peer in sorted(self._conns):
                self._send_to(peer, ("barrier_release",))
        else:
            self._barrier_release.clear()
            self.send_to_leader(("barrier_enter", self.rank))
            if not self._barrier_release.wait(self._timeout):
                log.fatal("multihost barrier timed out waiting for release")
            self._check_poison()  # a poison wake is loud, not a release

    # -- teardown ----------------------------------------------------------
    def shutdown(self) -> None:
        self._stopping.set()
        if self.rank == 0:
            for peer in sorted(self._conns):
                self._send_to(peer, ("stop",))
            # writers flush on close, so the stop descriptors (and any
            # queued acks before them) actually reach the followers
            for writer in list(self._writers.values()):
                writer.close(timeout=5.0)
            self._writers.clear()
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
        else:
            if self._poisoned is None:
                try:
                    self.send_to_leader(("bye",))
                except (OSError, log.FatalError):
                    pass  # a dying leader must not block OUR teardown
            if self._leader_writer is not None:
                self._leader_writer.close(timeout=5.0)
            # let the replay thread consume the leader's "stop" so no
            # lockstep descriptor is dropped mid-collective (a poisoned
            # rank's reader thread has already exited)
            join_timeout = self._timeout if self._poisoned is None else 5.0
            for t in self._threads:
                t.join(timeout=join_timeout)
            if self._leader_sock is not None:
                try:
                    self._leader_sock.close()
                except OSError:
                    pass
                self._leader_sock = None


def spawn_lockstep_world(child_script: str, scenario: str, world: int = 2,
                         timeout: float = 300.0,
                         expect: Optional[Dict[int, Tuple[int,
                                                          Optional[str]]]]
                         = None,
                         env: Optional[Dict[str, str]] = None) -> List[str]:
    """Launch ``world`` OS processes running ``child_script`` (argv: rank,
    world, rendezvous port, control port, scenario) and return
    each rank's combined output; raises RuntimeError on any failure or
    missing ``MULTIHOST_CHILD_OK rank=<r>`` marker. Both ports are picked
    free per world. ``expect`` overrides the (returncode,
    required-marker) expectation per rank — ``(42, None)`` accepts a
    deliberately-crashed rank (failure-injection scenarios); a LIST of
    such pairs accepts any one of them (races between equally-loud
    failure paths), with ``None`` in the returncode slot matching any
    exit code. ``env`` adds to the children's environment."""
    import os
    import subprocess
    import sys

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    coord, ctl = free_port(), free_port()
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = repo + os.pathsep + child_env.get("PYTHONPATH",
                                                                 "")
    child_env.update(env or {})
    # children inherit our process group: an outer harness that must kill
    # a wedged world kills the process GROUP; the finally below covers
    # every in-process failure path
    procs = [
        subprocess.Popen(
            [sys.executable, child_script, str(rank), str(world),
             str(coord), str(ctl), scenario],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=child_env, cwd=repo)
        for rank in range(world)
    ]
    outs: List[str] = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        want = (expect or {}).get(rank,
                                  (0, f"MULTIHOST_CHILD_OK rank={rank}"))
        alts = want if isinstance(want, list) else [want]
        ok = any((rc is None or p.returncode == rc)
                 and (marker is None or marker in out)
                 for rc, marker in alts)
        if not ok:
            others = "".join(
                f"\n--- rank {r} (rc={q.returncode}), last lines:\n"
                + "\n".join(o.splitlines()[-30:])
                for r, (q, o) in enumerate(zip(procs, outs)) if r != rank)
            raise RuntimeError(f"lockstep world rank {rank} failed "
                               f"(rc={p.returncode}, want one of "
                               f"{alts!r}):\n{out}{others}")
    return outs
