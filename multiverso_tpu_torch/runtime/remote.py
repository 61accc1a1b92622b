"""Remote table serving — the cross-process parameter-server path (port of
``multiverso_tpu/runtime/remote.py``).

Reference capability (not copied): a worker in ANY process reaches tables via
worker actor → Communicator → network → Server actor, with the reply
retracing the path (``src/worker.cpp:30-76``, ``src/communicator.cpp:69-105``,
``src/server.cpp:36-58``).

ONE process owns the tables (torch tensors on its device) and runs the
dispatcher (:mod:`multiverso_tpu_torch.runtime.server`); any other process
is a client. :class:`RemoteServer` is the net↔dispatcher bridge: a pump
thread pops table-request frames from the TCP (or shared-memory) mailbox,
decodes them into the same request structures local workers enqueue, and
attaches a completion that frames the reply back over the connection the
request arrived on. Every table's ``process_get`` answers a host request
with numpy, so the reply is encoded on the dispatcher from host arrays: no
tensor reaches the codec or the pump thread, and the pump launches
nothing. :class:`RemoteClient` registers (a worker id + the table
directory) and hands out worker-table proxies that share all client
shaping code with the in-process workers; only the channel differs. A
client holds no table state and touches no card.

The wire is the JAX package's, byte for byte: a client of either package
talks to a server of either package. The table directory carries each
table's logical shape and numpy dtype string (``remote_spec``).

Fault story (:mod:`multiverso_tpu_torch.fault`): every correlated request
carries a session-unique ``req_id``; the server keeps a bounded dedup
window mapping req_id to the cached reply, so a client may retransmit
freely and a retried Add applies exactly once. Remote workers renew a lease
with heartbeats; the sync watchdog evicts expired leases from the BSP/SSP
clock gates. Transports are built through
:func:`multiverso_tpu_torch.fault.inject.make_net`, so the whole path runs
under seeded fault injection via config flags.

Durable serving (``durable/``): with a write-ahead log attached to the
dispatcher (``mv.serve`` under the ``wal_dir`` flag) every wire Add carries
its raw blobs to the dispatcher's append, replies and heartbeats carry the
log's append watermark, a ``Control_Replicate`` subscriber (a warm standby
or a read replica) receives a quiesced state transfer and then every
record, and ``Control_Digest`` answers the fleet auditor. ``Request_Read``
is the read tier's slot-free primary Get (``runtime/read.py`` routes a
client's Gets through replicas and falls back here).

Sharded serving (``shard/``): a shard-group member serves the group's
layout manifest over ``Control_Layout``; a ``Control_Migrate`` subscriber
(a live-migration joiner) receives a quiesced transfer of its id ranges
and then every record; ``Control_Migrate_Cutover`` installs a new layout
and fences this member, which from then on refuses requests stamped
with an older layout version (``Reply_WrongShard``, checked after the
dedup window); ``Control_Cut`` snapshots every table at the WAL fence
(``durable/cut.py``).
"""

from __future__ import annotations

import itertools
import os
import random
import signal
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.dashboard import Dashboard, count, gauge_set, observe
from multiverso_tpu_torch.fault.detector import LivenessDetector
from multiverso_tpu_torch.fault.inject import make_net
from multiverso_tpu_torch.fault.retry import (CircuitBreaker, RetryBudget,
                                        RetryPolicy)
from multiverso_tpu_torch.obs.metrics import StatsSnapshot
from multiverso_tpu_torch.obs.trace import flight_dump, hop, tag_tenant
from multiverso_tpu_torch.runtime.admission import resolve_tenant
from multiverso_tpu_torch.runtime.contracts import slot_free
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id
from multiverso_tpu_torch.runtime.net import TcpNet
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.tables.array_table import ArrayWorker
from multiverso_tpu_torch.tables.base import Completion, WorkerTable
from multiverso_tpu_torch.tables.kv_table import KVWorker
from multiverso_tpu_torch.tables.matrix_table import (MatrixWorker,
                                                      merge_duplicate_rows)
from multiverso_tpu_torch.tables.sparse_table import SparseWorker

# wire_quant_bits lives in config.py (must exist before this module is
# first imported so mv.init(wire_quant_bits=...) works)
config.define_bool("wire_compression", True,
                   "SparseFilter-compress float32 payloads on host hops "
                   "when the sparse form is smaller")


# -- server side -------------------------------------------------------------

# dedup-window sentinel: the request arrived and is being processed; a
# replay seen now is swallowed (the original's completion will reply)
_INFLIGHT = object()


class WrongShardError(Exception):
    """A Reply_WrongShard came back: the request was stamped with a layout
    version older than the serving shard's installed layout, so it was
    REFUSED before applying. Carries the server's layout version and the
    new manifest so the shard router re-fetches and re-routes without an
    extra Control_Layout round trip."""

    def __init__(self, layout_version: int, manifest) -> None:
        super().__init__(f"stale shard layout (server at version "
                         f"{layout_version})")
        self.layout_version = int(layout_version)
        self.manifest = manifest


def _host_reply(payload: Any) -> Any:
    """A reply payload with every tensor read to a host numpy array. The
    tables answer host requests with numpy already; a request in one of
    the in-process device forms would answer with a tensor, and the codec
    and the pump take host arrays only. Runs where the completion fires:
    on the dispatcher thread."""
    if isinstance(payload, torch.Tensor):
        return payload.detach().cpu().numpy()
    if isinstance(payload, tuple):
        return tuple(_host_reply(x) for x in payload)
    if isinstance(payload, list):
        return [_host_reply(x) for x in payload]
    if isinstance(payload, dict):
        return {k: _host_reply(v) for k, v in payload.items()}
    return payload


class _NetCompletion:
    """Dispatcher completion that frames the result back over the wire and
    records it in the server's dedup window, so a replay of the same
    request re-sends this reply instead of re-applying the request."""

    __slots__ = ("_server", "_conn", "_template", "_compress")

    def __init__(self, server: "RemoteServer", conn, template: Message,
                 compress: bool) -> None:
        self._server = server
        self._conn = conn
        self._template = template
        self._compress = compress

    def _reply(self, msg_type: MsgType, payload: Any) -> None:
        t = self._template
        msg = Message(src=t.dst, dst=t.src, type=msg_type,
                      table_id=t.table_id, msg_id=t.msg_id, req_id=t.req_id,
                      watermark=self._server.append_watermark(),
                      data=wire.encode(_host_reply(payload),
                                       compress=self._compress))
        self._server._dedup_store(t.req_id, msg)
        hop(t.req_id, "reply_sent")
        try:
            self._server._net.send_via(self._conn, msg)
        except OSError as exc:
            log.error("remote: reply to worker %d failed: %r (the client "
                      "recovers it via retransmit + the dedup cache)",
                      t.src, exc)

    def done(self, result: Any) -> None:
        reply_type = (MsgType.Reply_Get
                      if self._template.type == MsgType.Request_Get
                      else MsgType.Reply_Add)
        self._reply(reply_type, result)

    def fail(self, error: BaseException) -> None:
        # admission refusals and deadline drops ship their exact truthful
        # string (clients key graceful degradation on the "shed: " /
        # "deadline_exceeded" prefixes); everything else ships its repr
        self._reply(MsgType.Reply_Error,
                    getattr(error, "wire_text", None) or repr(error))


class _ReadCompletion:
    """Completion for a slot-free Request_Read: replies Reply_Read stamped
    with the primary's append watermark. No dedup entry — reads are
    idempotent, a replayed read just re-serves."""

    __slots__ = ("_server", "_conn", "_template", "_compress")

    def __init__(self, server: "RemoteServer", conn, template: Message,
                 compress: bool) -> None:
        self._server = server
        self._conn = conn
        self._template = template
        self._compress = compress

    def _reply(self, msg_type: MsgType, payload: Any) -> None:
        t = self._template
        msg = Message(src=t.dst, dst=t.src, type=msg_type,
                      table_id=t.table_id, msg_id=t.msg_id, req_id=t.req_id,
                      watermark=self._server.append_watermark(),
                      data=wire.encode(_host_reply(payload),
                                       compress=self._compress))
        hop(t.req_id, "read_reply_sent")
        try:
            self._server._net.send_via(self._conn, msg)
        except OSError as exc:
            log.error("remote: read reply failed: %r (the client falls "
                      "back to another endpoint)", exc)

    def done(self, result: Any) -> None:
        count("READS_SERVED_PRIMARY")
        self._reply(MsgType.Reply_Read, result)

    def fail(self, error: BaseException) -> None:
        self._reply(MsgType.Reply_Error,
                    getattr(error, "wire_text", None) or repr(error))


class _QueryCompletion(_ReadCompletion):
    """Completion for a slot-free Request_Query on the primary: replies
    Reply_Query stamped with the append watermark. Idempotent like a
    read — no dedup entry; a replayed query just re-scores."""

    __slots__ = ()

    def done(self, result: Any) -> None:
        count("QUERIES_SERVED_PRIMARY")
        self._reply(MsgType.Reply_Query, result)


class RemoteServer:
    """Serves this process's tables to client processes over TCP (or the
    shared-memory ring)."""

    def __init__(self, zoo) -> None:
        self._zoo = zoo
        self._net = make_net()  # ChaosNet under fault_spec, else TcpNet
        self._thread: Optional[threading.Thread] = None
        self._wid_lock = threading.Lock()
        self._next_remote = 0
        self._free_slots: List[int] = []  # recycled by Control_Deregister
        # slot -> the connection that registered it: a deregister is honored
        # only from that connection, so a replayed/forged deregister cannot
        # free a slot that was re-leased to a different client
        self._leased: Dict[int, Any] = {}
        # client session nonce -> worker id: the authority for
        # reconnect-and-resume (a client proves slot ownership with the
        # session it registered under, not with its — dead — connection)
        self._sessions: Dict[int, int] = {}
        # bounded idempotent-replay window: req_id -> _INFLIGHT | cached
        # reply Message (re-sent verbatim over the replaying frame's conn)
        self._dedup: "OrderedDict[int, Any]" = OrderedDict()
        self._dedup_lock = threading.Lock()
        self._dedup_max = max(16, int(config.get_flag("dedup_window")))
        # warm-standby replication subscribers (durable/standby.py):
        # connections that receive every WAL record + periodic heartbeats
        self._standbys: List[Any] = []
        self._standby_lock = threading.Lock()
        self._standby_hb: Optional[threading.Thread] = None
        self._standby_hb_stop = threading.Event()
        self.liveness = LivenessDetector(
            float(config.get_flag("lease_seconds")))
        self.endpoint: Optional[str] = None
        # shard-group membership (shard/group.py): the layout manifest
        # this member serves over Control_Layout — either the dict
        # itself, or a path loaded lazily (the group publishes the file
        # only after every member has bound its endpoint)
        self.layout: Optional[Dict[str, Any]] = None
        self.layout_path: str = ""
        # live-migration layout fencing (shard/reshard.py): requests
        # stamped with a layout version below this are refused with
        # Reply_WrongShard instead of applied — the router re-fetches and
        # re-routes. 0 = no fencing (unsharded servers, pre-migration
        # groups); bumped only by a Control_Migrate_Cutover install.
        self.layout_version: int = 0

    def append_watermark(self) -> int:
        """The primary's WAL append sequence (-1 when serving without
        durability — no staleness unit exists then). Reads a plain int
        written on the dispatcher thread; safe from any thread."""
        server = self._zoo.server
        wal = server.wal if server is not None else None
        return int(wal.seq) if wal is not None else -1

    def serve(self, endpoint: str = "127.0.0.1:0") -> str:
        """Bind + start the pump; returns the dialable endpoint."""
        self.endpoint = self._net.bind(0, endpoint)
        if self._zoo.server is not None:
            # the sync watchdog polls this to escalate stalls to evictions
            self._zoo.server.liveness = self.liveness
            if self._zoo.server.wal is not None:
                # replication fan-out: every durable append reaches the
                # subscribed standbys over their replication connections
                self._zoo.server.wal.add_observer(self._replicate_record)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="mv-remote-serve")
        self._thread.start()
        return self.endpoint

    def stop(self) -> None:
        if (self._zoo.server is not None
                and self._zoo.server.liveness is self.liveness):
            self._zoo.server.liveness = None
        self._standby_hb_stop.set()
        if self._standby_hb is not None:
            self._standby_hb.join(timeout=10)
            self._standby_hb = None
        self._net.finalize()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- idempotent replay ---------------------------------------------------
    def _replayed(self, msg: Message) -> bool:
        """True → this frame replays an already-seen request: re-send the
        cached reply (if built) over THIS frame's connection — the original
        may have gone to a connection that no longer exists — or swallow
        the duplicate while the original is still in flight."""
        if msg.req_id == 0:
            return False
        with self._dedup_lock:
            hit = self._dedup.get(msg.req_id)
            if hit is None:
                self._dedup[msg.req_id] = _INFLIGHT
                while len(self._dedup) > self._dedup_max:
                    self._dedup.popitem(last=False)
                gauge_set("SERVER_DEDUP_OCCUPANCY", len(self._dedup))
                return False
        count("SERVER_DEDUP_HITS")
        hop(msg.req_id, "server_dedup_hit")
        if hit is not _INFLIGHT:
            try:
                self._net.send_via(msg._conn, hit)
            except OSError as exc:
                log.error("remote: dedup re-reply failed: %r", exc)
        return True

    def _dedup_store(self, req_id: int, reply: Message) -> None:
        if req_id == 0:
            return
        with self._dedup_lock:
            if req_id in self._dedup:
                self._dedup[req_id] = reply

    def seed_dedup(self, seeds) -> None:
        """Rebuild the idempotent-replay window from recovered/replicated
        WAL records — ``(req_id, worker, msg_id)`` triples in replay
        order. A client retransmitting an Add that was logged before the
        crash/failover gets a synthesized ACK instead of a second apply:
        exactly-once survives the restart. Remote Add replies are
        ACK-shaped (the client ignores the payload), so the synthesis is
        faithful to what the dead server would have re-sent."""
        with self._dedup_lock:
            for req_id, worker, msg_id in list(seeds)[-self._dedup_max:]:
                self._dedup[int(req_id)] = Message(
                    src=0, dst=int(worker), type=MsgType.Reply_Add,
                    msg_id=int(msg_id), req_id=int(req_id),
                    data=wire.encode(None))
            while len(self._dedup) > self._dedup_max:
                self._dedup.popitem(last=False)

    # -- warm-standby replication (durable/standby.py) -----------------------
    def _replicate_record(self, seq: int, req_id: int, worker: int,
                          table_id: int, msg_id: int, blobs) -> None:
        """WAL observer: forward one durable record to every subscribed
        standby. Runs on the dispatcher thread right after the append, so
        a record the primary ACKs was already written to each standby's
        socket before the ACK frame — the kernel delivers it even if the
        primary dies the next instant. Each record carries its append
        sequence so replicas track their replay watermark and DETECT
        stream gaps (a missing sequence forces a resubscribe)."""
        with self._standby_lock:
            conns = list(self._standbys)
        for conn in conns:
            msg = Message(src=worker, dst=-1,
                          type=MsgType.Control_Wal_Record,
                          table_id=table_id, msg_id=msg_id, req_id=req_id,
                          watermark=seq, data=list(blobs))
            try:
                # flush: the record must reach the standby's socket before
                # the client's ACK is even queued — the two frames ride
                # different connections, so the dispatcher-thread order
                # alone does not give the kernel-delivery order
                self._net.send_via(conn, msg, flush=True)
            except OSError as exc:
                log.error("remote: replication to a standby failed (%r); "
                          "dropping the subscriber — it will resubscribe "
                          "with a full state transfer", exc)
                with self._standby_lock:
                    if conn in self._standbys:
                        self._standbys.remove(conn)

    def _subscribe_standby(self, msg: Message) -> None:
        """Handle Control_Replicate: quiesced full-state transfer (every
        table + the Add half of the dedup window), then subscribe the
        connection to the live record stream. The snapshot and the
        subscription happen in ONE dispatcher-serialized block, so no add
        can fall between them. ``store`` reads each table's tensors to
        host bytes inside the block, so later Adds cannot show through."""
        wal = self._zoo.server.wal
        if wal is None:
            self._refuse(msg, "replication needs durability: start the "
                              "primary with the wal_dir flag")
            return

        def transfer():
            tables = {}
            for table_id, table in list(self._zoo.server._tables.items()):
                stream = mv_io.MemoryStream()
                table.store(stream)
                tables[int(table_id)] = np.frombuffer(
                    stream.getvalue(), dtype=np.uint8)
            with self._dedup_lock:
                dedup = [[m.req_id, m.dst, m.msg_id]
                         for m in self._dedup.values()
                         if isinstance(m, Message)
                         and m.type == MsgType.Reply_Add]
            with self._standby_lock:
                # idempotent: a gap-triggered resubscribe arrives over the
                # SAME live connection — double-adding it would double
                # every later record
                if msg._conn not in self._standbys:
                    self._standbys.append(msg._conn)
            # the snapshot's watermark, read inside the serialized block:
            # every record the standby will see next has seq > this
            return tables, dedup, int(wal.seq)

        tables, dedup, watermark = self._zoo.server.run_serialized(
            transfer, timeout=None)
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Replicate,
            msg_id=msg.msg_id, req_id=msg.req_id, watermark=watermark,
            data=wire.encode({"tables": tables, "dedup": dedup,
                              "watermark": watermark})))
        log.info("remote: standby subscribed (%d table(s), %d dedup "
                 "seed(s) transferred)", len(tables), len(dedup))
        self._ensure_standby_heartbeats()

    # -- live key-range migration (shard/reshard.py) -------------------------
    def _subscribe_migrate(self, msg: Message) -> None:
        """Handle Control_Migrate: a joining shard asks for a quiesced
        raw-value transfer of specific shard-local id ranges, then tails
        this donor's WAL record stream like a standby (the subscriber
        filters to its ranges; the donor fan-out stays one code path).
        Snapshot + subscription happen in ONE dispatcher-serialized block
        — no Add falls between the extracted values and the first tailed
        record. ``extract_range`` reads each range to a host copy inside
        the block, and the frame is encoded from that copy, so a later
        Add cannot show through."""
        wal = self._zoo.server.wal
        if wal is None:
            self._refuse(msg, "live migration needs durability: start "
                              "the donor with the wal_dir flag")
            return
        ranges = wire.decode(msg.data).get("tables", {})

        def transfer():
            tables = {}
            for table_id, (lo, hi) in ranges.items():
                table = self._zoo.server._tables[int(table_id)]
                tables[int(table_id)] = table.extract_range(int(lo),
                                                            int(hi))
            with self._standby_lock:
                if msg._conn not in self._standbys:
                    self._standbys.append(msg._conn)
            return tables, int(wal.seq)

        tables, watermark = self._zoo.server.run_serialized(
            transfer, timeout=None)
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Migrate,
            msg_id=msg.msg_id, req_id=msg.req_id, watermark=watermark,
            data=wire.encode({"tables": tables, "watermark": watermark})))
        log.info("remote: migration subscriber attached (%d range(s), "
                 "watermark %d)", len(tables), watermark)
        self._ensure_standby_heartbeats()

    def _migrate_cutover(self, msg: Message) -> None:
        """Handle Control_Migrate_Cutover: install the attached manifest
        (the layout-version fence goes up) and answer with the WAL seq
        after a dispatcher drain. This handler runs on the pump thread —
        the ONLY thread that enqueues wire requests — so once the fence is
        set here, no further stale-stamped Add can enter the dispatcher;
        the run_serialized barrier then drains everything already queued,
        so every acknowledged Add on this donor has seq <= the returned
        watermark and the record stream is silent above it. Also the
        rollback vehicle: aborting re-installs the old topology under a
        HIGHER version through the same RPC."""
        payload = wire.decode(msg.data)
        manifest = payload["manifest"]
        version = int(manifest.get("layout_version", 1))
        if version > self.layout_version:
            self.layout = manifest
            self.layout_version = version
        server = self._zoo.server
        if server is not None and server.wal is not None:
            watermark = server.run_serialized(lambda: int(server.wal.seq),
                                              timeout=None)
        else:
            watermark = -1
        count("MIGRATION_CUTOVERS")
        hop(msg.req_id, "migrate_cutover")
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Migrate_Cutover,
            msg_id=msg.msg_id, req_id=msg.req_id, watermark=watermark,
            data=wire.encode({"watermark": watermark,
                              "layout_version": self.layout_version})))
        log.info("remote: cutover to layout version %d at watermark %d",
                 version, watermark)

    def _ensure_standby_heartbeats(self) -> None:
        """Primary→standby heartbeats: the standby's lease on the primary
        must stay renewed while the WAL idles, or a quiet training lull
        would look like primary death."""
        if self._standby_hb is not None:
            return
        period = float(config.get_flag("heartbeat_seconds"))
        if period <= 0:
            return
        self._standby_hb = threading.Thread(
            target=self._standby_heartbeat_loop, args=(period,),
            daemon=True, name="mv-remote-standby-hb")
        self._standby_hb.start()

    def _standby_heartbeat_loop(self, period: float) -> None:
        while not self._standby_hb_stop.wait(period):
            try:
                # a fresh frame per beat: the watermark stamp keeps the
                # replicas' view of the primary's append position current
                # while the WAL idles
                beat = Message(src=0, dst=-1,
                               type=MsgType.Control_Heartbeat,
                               watermark=self.append_watermark())
                with self._standby_lock:
                    conns = list(self._standbys)
                for conn in conns:
                    try:
                        self._net.send_via(conn, beat)
                    except OSError:
                        with self._standby_lock:
                            if conn in self._standbys:
                                self._standbys.remove(conn)
            except Exception as exc:  # noqa: BLE001 — a dead heartbeat
                # thread starves every standby's lease into a FALSE
                # failover; log and keep beating
                log.error("remote: standby heartbeat tick failed: %r", exc)

    def _refuse(self, msg: Message, text: str) -> None:
        """Answer a control frame this server cannot serve with a
        Reply_Error saying why (never a silent drop)."""
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Reply_Error,
            msg_id=msg.msg_id, req_id=msg.req_id, data=wire.encode(text)))

    # -- pump ---------------------------------------------------------------
    def _pump(self) -> None:
        compress = bool(config.get_flag("wire_compression"))
        while True:
            try:
                msg = self._net.recv()
            except ConnectionError:
                continue  # a client connection died; its waiters are remote
            if msg is None:
                return
            try:
                self._handle(msg, compress)
            except Exception as exc:  # noqa: BLE001 — keep serving
                log.error("remote server: error on %s: %r", msg.type, exc)
                _NetCompletion(self, msg._conn, msg, False).fail(exc)

    def _handle(self, msg: Message, compress: bool) -> None:
        if msg.src >= 0:
            # ANY frame from a worker renews its lease; dedicated
            # heartbeats only matter while the client idles or blocks
            self.liveness.beat(msg.src)
        hop(msg.req_id, "server_recv")
        if msg.type == MsgType.Control_Heartbeat:
            return
        if msg.type == MsgType.Control_Stats:
            self._reply_stats(msg)
            return
        if msg.type == MsgType.Control_Layout:
            self._reply_layout(msg)
            return
        if msg.type == MsgType.Control_Watermark:
            self._reply_watermark(msg)
            return
        if msg.type == MsgType.Control_Traces:
            self._reply_traces(msg)
            return
        if msg.type == MsgType.Control_Profile:
            self._reply_profile(msg)
            return
        if msg.type == MsgType.Control_Digest:
            self._reply_digest(msg)
            return
        if msg.type == MsgType.Control_Cut:
            self._handle_cut(msg)
            return
        if msg.type == MsgType.Request_Read:
            self._serve_read(msg, compress)
            return
        if msg.type == MsgType.Request_Query:
            self._serve_query(msg, compress)
            return
        if msg.type == MsgType.Control_Register:
            if not self._replayed(msg):
                self._register_client(msg)
            return
        if msg.type == MsgType.Control_Deregister:
            self._deregister_client(msg)
            return
        if msg.type == MsgType.Control_Replicate:
            self._subscribe_standby(msg)
            return
        if msg.type == MsgType.Control_Migrate:
            self._subscribe_migrate(msg)
            return
        if msg.type == MsgType.Control_Migrate_Cutover:
            self._migrate_cutover(msg)
            return
        if msg.type == MsgType.Server_Finish_Train:
            self._zoo.server.send(Message(
                src=msg.src, dst=-1, type=msg.type, table_id=msg.table_id,
                msg_id=msg.msg_id))
            return
        if msg.type not in (MsgType.Request_Get, MsgType.Request_Add):
            log.error("remote server: unhandled frame type %s", msg.type)
            return
        if self._replayed(msg):
            return
        if (self.layout_version > 0 and msg.req_id
                and 0 <= msg.watermark < self.layout_version):
            # Stale-layout fence, strictly AFTER the dedup check: a
            # replayed-but-already-applied Add re-serves its cached ACK
            # above and never lands here, so a WrongShard refusal
            # GUARANTEES the request did not apply on this shard — the
            # router may safely re-issue it under a fresh req_id. Pop the
            # _INFLIGHT entry _replayed just inserted: this req_id's
            # story on this shard is over.
            with self._dedup_lock:
                if self._dedup.get(msg.req_id) is _INFLIGHT:
                    del self._dedup[msg.req_id]
            count("MIGRATION_WRONG_SHARD_REPLIES")
            hop(msg.req_id, "wrong_shard_refused")
            self._net.send_via(msg._conn, Message(
                src=0, dst=msg.src, type=MsgType.Reply_WrongShard,
                table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
                trace=msg.trace,
                data=wire.encode({"layout_version": self.layout_version,
                                  "manifest": self.layout})))
            return
        request = wire.decode(msg.data)
        completion = _NetCompletion(self, msg._conn, msg, compress)
        # req_id rides into the dispatcher so server-side stages (gate
        # defer/release, WAL append, apply) land on the request's trace
        forward = Message(
            src=msg.src, dst=-1, type=msg.type, table_id=msg.table_id,
            msg_id=msg.msg_id, req_id=msg.req_id, deadline=msg.deadline,
            data=[request, completion])
        if (msg.type == MsgType.Request_Add and msg.req_id
                and self._zoo.server.wal is not None):
            # raw wire blobs ride along for the dispatcher's write-ahead
            # append (Server._wal_append) — logged before apply/ACK,
            # replayed through wire.decode at recovery
            forward._wal = (msg.req_id, msg.src, msg.table_id, msg.msg_id,
                            msg.data)
        hop(msg.req_id, "dispatch_enqueue")
        self._zoo.server.send(forward)

    @slot_free
    def _serve_read(self, msg: Message, compress: bool) -> None:
        """Request_Read on the PRIMARY: a slot-free Get — no worker slot,
        no lease, no dedup entry. The request rides the dispatcher queue
        as an administrative Get (src=-1 bypasses every round gate), so
        it serializes with applies, and the Reply_Read is stamped with the
        append watermark at reply time. The primary is trivially "fresh",
        so the request's staleness budget is always satisfied here — this
        is the fallback target when no replica qualifies."""
        request = wire.decode(msg.data)
        completion = _ReadCompletion(self, msg._conn, msg, compress)
        hop(msg.req_id, "dispatch_enqueue")
        self._zoo.server.send(Message(
            src=-1, dst=-1, type=MsgType.Request_Get,
            table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
            deadline=msg.deadline,
            data=[request, completion]))

    @slot_free
    def _serve_query(self, msg: Message, compress: bool) -> None:
        """Request_Query on the PRIMARY: slot-free like a Request_Read —
        no worker slot, no lease, no dedup entry. Rides the dispatcher
        queue under its own type (src=-1, serving lane, never clocked) so
        the top-k scoring serializes with applies, and the Reply_Query is
        stamped with the append watermark at reply time."""
        request = wire.decode(msg.data)
        completion = _QueryCompletion(self, msg._conn, msg, compress)
        hop(msg.req_id, "dispatch_enqueue")
        self._zoo.server.send(Message(
            src=-1, dst=-1, type=MsgType.Request_Query,
            table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
            deadline=msg.deadline,
            data=[request, completion]))

    @slot_free
    def _reply_watermark(self, msg: Message) -> None:
        """Control_Watermark: this process's position in the WAL stream —
        slot-free like the stats probe (an operator asking 'how stale is
        this endpoint' must get an answer even when every slot is
        taken). A traced replica-served Get fires one of these at the
        primary under its own req_id (the read tier's confirm leg), so
        the reply-sent hop below is the 'primary watermark path' segment
        of a stitched cross-process trace."""
        watermark = self.append_watermark()
        hop(msg.req_id, "watermark_reply_sent")
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Watermark,
            msg_id=msg.msg_id, req_id=msg.req_id, watermark=watermark,
            trace=msg.trace,
            data=wire.encode({"role": "primary", "watermark": watermark,
                              "primary_watermark": watermark, "lag": 0})))

    @slot_free
    def _reply_traces(self, msg: Message) -> None:
        """Control_Traces: ship this process's recent per-request traces
        plus its wall clock at reply time — the pull half of fleet trace
        stitching (obs/collector.py). Slot-free like the stats probe."""
        from multiverso_tpu_torch.obs.trace import TRACES
        n = max(1, int(config.get_flag("trace_export_max")))
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Traces,
            msg_id=msg.msg_id, req_id=msg.req_id,
            data=wire.encode({"role": "primary",
                              "endpoint": self.endpoint or "",
                              "t_reply_ns": time.time_ns(),
                              "traces": TRACES.export(n),
                              # tenant tags ride as a sibling key legacy
                              # collectors simply ignore (and legacy
                              # senders omit — frames are unchanged)
                              "tenants": TRACES.export_tenants(n)})))

    @slot_free
    def _reply_profile(self, msg: Message) -> None:
        """Control_Profile: ship this process's sampling-profiler report
        (per-thread self-time, wait-site seconds, top collapsed stacks)
        — the pull half of fleet attribution (obs/critpath.py).
        Slot-free like the stats probe: a profile of a wedged server is
        worth the most exactly when every slot is taken."""
        from multiverso_tpu_torch.obs.profiler import PROFILER
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Profile,
            msg_id=msg.msg_id, req_id=msg.req_id,
            data=wire.encode({"role": "primary",
                              "endpoint": self.endpoint or "",
                              "t_reply_ns": time.time_ns(),
                              "profile": PROFILER.report()})))

    @slot_free
    def _reply_digest(self, msg: Message) -> None:
        """Control_Digest: per-table order-independent content digests at
        this primary's EXACT append watermark — digest and watermark are
        read in one dispatcher-serialized block, so no Add can land
        between them (the digest reads each table to host bytes there).
        Slot-free like the stats probe. The layout version is this
        member's fence (0 for an unsharded primary)."""
        from multiverso_tpu_torch.obs.audit import digest_payload
        server = self._zoo.server
        t0 = time.perf_counter()

        def run():
            wal = server.wal
            return digest_payload(
                server._tables, role="primary", endpoint=self.endpoint or "",
                watermark=int(wal.seq) if wal is not None else -1,
                layout_version=self.layout_version)

        payload = server.run_serialized(run, timeout=None)
        observe("AUDIT_DIGEST_SECONDS", time.perf_counter() - t0)
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Digest,
            msg_id=msg.msg_id, req_id=msg.req_id,
            watermark=int(payload.get("watermark", -1)),
            data=wire.encode(payload)))

    def _handle_cut(self, msg: Message) -> None:
        """Control_Cut: snapshot every table at this shard's WAL fence
        (durable/cut.py) and reply the fence + digests. Runs on the pump
        thread — the only thread that enqueues wire requests — so the
        dispatcher-serialized capture block drains everything already
        accepted and fences out everything after, the same quiesce shape
        as the Control_Replicate transfer. A durability-less server
        refuses: without a WAL there is no fence to cut at."""
        from multiverso_tpu_torch.durable import cut as cut_mod
        if self._zoo.server.wal is None:
            self._refuse(msg, "consistent cuts need durability: start "
                              "the server with the wal_dir flag")
            return
        request = wire.decode(msg.data) if msg.data else {}
        request = request if isinstance(request, dict) else {}
        reply = cut_mod.capture_cut(self, str(request.get("cut_id", "adhoc")))
        if request.get("kill") == "shard":
            # chaos drill (MV_CUT_KILL=shard): die AFTER the local
            # snapshot but BEFORE replying — the coordinator sees a
            # timeout, the cut fails, and the previous manifest must
            # remain the fleet's recovery point
            log.error("cut: MV_CUT_KILL=shard — dying before the cut "
                      "reply (drill)")
            os.kill(os.getpid(), signal.SIGKILL)
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Cut,
            msg_id=msg.msg_id, req_id=msg.req_id,
            watermark=int(reply["fence"]), data=wire.encode(reply)))

    @slot_free
    def _reply_stats(self, msg: Message) -> None:
        """Control_Stats: ship this process's full dashboard — monitors,
        counters, gauges, histograms as bucket arrays — back over the
        probing connection. No worker slot, no lease, no dedup entry: a
        stats probe must stay readable even when every slot is taken or
        the clock gates are wedged (that is when an operator needs it)."""
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Stats,
            msg_id=msg.msg_id, req_id=msg.req_id,
            data=wire.encode(Dashboard.snapshot())))

    @slot_free
    def _reply_layout(self, msg: Message) -> None:
        """Control_Layout: ship the shard group's layout manifest. Like
        the stats probe: no worker slot, no lease, no dedup entry — a
        bootstrapping client must be able to ask ANY member."""
        layout = self.layout
        if layout is None and self.layout_path:
            try:
                import json
                with open(self.layout_path, "r", encoding="utf-8") as f:
                    layout = self.layout = json.load(f)
            except (OSError, ValueError):
                layout = None  # manifest not published yet — reply error
        if layout is None:
            self._refuse(msg, "no shard layout: this server is not a "
                              "shard-group member (or the group's "
                              "manifest is not published yet)")
            return
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Layout,
            msg_id=msg.msg_id, req_id=msg.req_id,
            data=wire.encode(layout)))

    def _deregister_client(self, msg: Message) -> None:
        # Graceful close. Slot recycling is async-server only: the sync
        # server's per-worker clocks/finished flags are positional history
        # a newcomer must not inherit, so BSP keeps the reference's
        # static-membership contract (a departed worker's slot stays
        # retired; crashed clients are reclaimed only by lease eviction).
        # Only the connection that leased the slot may free it: a
        # duplicate, forged, or replayed deregister (src=-1, a local id,
        # a replay after the slot was re-leased) must not let two later
        # clients share one worker id. A recycled slot DOES inherit the
        # departed client's per-worker updater state (momentum/adagrad
        # accumulators) — deliberate: that state is the slot's
        # optimization history, exactly what the reference's static
        # membership kept positional.
        from multiverso_tpu_torch.runtime.server import SyncServer
        slot = int(msg.src)
        conn = getattr(msg, "_conn", None)
        with self._wid_lock:
            if conn is None or self._leased.get(slot) is not conn:
                log.error("remote: ignoring deregister for slot %d "
                          "(not leased to this connection)", slot)
                return
            self.liveness.forget(slot)
            # drop session claims on the slot so a stale client cannot
            # resume a slot later re-leased to someone else
            self._sessions = {s: w for s, w in self._sessions.items()
                              if w != slot}
            if not isinstance(self._zoo.server, SyncServer):
                del self._leased[slot]
                self._free_slots.append(slot)

    def _resume_slot(self, session: int, resume: int,
                     msg: Message) -> Optional[str]:
        """Validate a reconnect-and-resume claim (``_wid_lock`` held);
        returns a refusal message or None (granted, caller re-leases).
        The session nonce — not the connection, which is typically dead —
        is the authority for slot ownership."""
        base = self._zoo.num_workers - self._zoo.remote_workers
        idx = resume - base
        if not 0 <= idx < self._zoo.remote_workers:
            return f"cannot resume worker {resume}: not a remote slot"
        if self.liveness.is_evicted(resume):
            return (f"worker {resume} was evicted (lease expired); its "
                    "round-clock history is retired — register fresh")
        if session and self._sessions.get(session) == resume:
            return None  # the same client reclaiming its own slot
        held = self._leased.get(resume)
        if held is msg._conn:
            return None  # replayed register on the same connection
        if held is None:
            # unleased: a restarted server (empty lease table) or a
            # gracefully-freed slot; account it as taken
            if idx >= self._next_remote:
                for skipped in range(self._next_remote, idx):
                    self._free_slots.append(base + skipped)
                self._next_remote = idx + 1
            elif resume in self._free_slots:
                self._free_slots.remove(resume)
            else:
                return f"worker slot {resume} is not resumable"
            return None
        return f"worker slot {resume} is leased to another client"

    def _register_reply(self, msg: Message, payload: Any) -> None:
        reply = Message(src=msg.dst, dst=msg.src,
                        type=MsgType.Control_Reply_Register,
                        msg_id=msg.msg_id, req_id=msg.req_id,
                        data=wire.encode(payload))
        self._dedup_store(msg.req_id, reply)
        self._net.send_via(msg._conn, reply)

    def _register_client(self, msg: Message) -> None:
        info = wire.decode(msg.data)
        info = info if isinstance(info, dict) else {}
        session = int(info.get("session", 0))
        resume = int(info.get("resume", -1))
        base = self._zoo.num_workers - self._zoo.remote_workers
        with self._wid_lock:
            if resume >= 0:
                refusal = self._resume_slot(session, resume, msg)
                if refusal is not None:
                    self._register_reply(msg, {"error": refusal})
                    return
                worker_id = resume
            elif self._free_slots:
                worker_id = self._free_slots.pop()
            elif self._next_remote >= self._zoo.remote_workers:
                # refuse: an out-of-range worker id would alias slot-0
                # per-worker state and bypass the BSP clocks
                self._register_reply(msg, {"error": (
                    f"all {self._zoo.remote_workers} remote worker slots "
                    "are taken (raise the remote_workers flag at init)")})
                return
            else:
                worker_id = base + self._next_remote
                self._next_remote += 1
            self._leased[worker_id] = msg._conn
            if session:
                self._sessions[session] = worker_id
        self.liveness.register(worker_id)
        directory = []
        # snapshot: create_table on the main thread mutates the dict
        for table_id, table in list(self._zoo.server._tables.items()):
            spec = table.remote_spec()
            if spec is not None:
                entry = {"table_id": table_id, **spec}
                offset = int(getattr(table, "row_offset", 0) or 0)
                if offset:
                    # range-sharded member: this table's rows/keys sit at
                    # [offset, offset + local size) of the global table —
                    # introspection for routers and operators
                    entry["row_offset"] = offset
                directory.append(entry)
        self._register_reply(msg, {"worker_id": worker_id,
                                   "num_workers": self._zoo.num_workers,
                                   "tables": directory})


# -- one-shot control probes --------------------------------------------------

def control_probe(endpoint: str, request_type: MsgType,
                  reply_type: MsgType, timeout: float = 10.0,
                  what: str = "probe", payload: Any = None) -> Any:
    """Dial ``endpoint``, send one control frame, return the decoded
    reply payload. The shared skeleton under the stats and layout RPCs —
    deliberately NOT a RemoteClient: no worker slot, no lease, no chaos
    transport, because a diagnostic/bootstrap probe must work when the
    data plane is the thing being diagnosed. A ``Reply_Error`` answer
    (e.g. asking a non-member for a shard layout) raises RuntimeError
    with the server's message."""
    net = TcpNet()
    net.rank = -1
    net.connect([endpoint])
    msg_id = next_msg_id()
    got = threading.Event()
    box: Dict[str, Message] = {}

    def pump() -> None:
        try:
            while True:
                msg = net.recv()
                if msg is None:
                    return
                if msg.msg_id == msg_id:
                    box["reply"] = msg
                    got.set()
                    return
        except ConnectionError:
            got.set()

    threading.Thread(target=pump, daemon=True,
                     name=f"mv-{what}-probe").start()
    try:
        net.send(Message(src=-1, dst=0, type=request_type, msg_id=msg_id,
                         data=wire.encode(payload)
                         if payload is not None else []))
        if not got.wait(timeout):
            raise TimeoutError(f"{what} probe to {endpoint} timed out "
                               f"after {timeout:.1f}s")
    finally:
        net.finalize()
    reply = box.get("reply")
    if reply is None:
        raise ConnectionError(f"{what} probe to {endpoint}: connection "
                              "lost before the reply")
    if reply.type == MsgType.Reply_Error:
        raise RuntimeError(f"{what} probe to {endpoint} refused: "
                           f"{wire.decode(reply.data)}")
    if reply.type != reply_type:
        raise RuntimeError(f"{what} probe to {endpoint}: unexpected reply "
                           f"{reply.type}")
    return wire.decode(reply.data)


def fetch_watermark(endpoint: str, timeout: float = 10.0) -> Dict[str, Any]:
    """One-shot watermark probe: ``{"role": "primary"|"replica",
    "watermark": <applied/append seq>, "primary_watermark": <append seq
    observed>, "lag": <records behind>}`` — the staleness position of any
    serving endpoint (primary or read replica), slot-free."""
    return control_probe(endpoint, MsgType.Control_Watermark,
                         MsgType.Control_Reply_Watermark,
                         timeout=timeout, what="watermark")


def fetch_traces(endpoint: str, timeout: float = 10.0) -> Dict[str, Any]:
    """One-shot trace pull: ``{"role", "endpoint", "t_reply_ns",
    "traces": {req_id: [[stage, t_ns], ...]}}`` from any serving process
    (primary or replica), slot-free. Wire keys arrive as strings/ints
    depending on codec; the collector normalizes."""
    return control_probe(endpoint, MsgType.Control_Traces,
                         MsgType.Control_Reply_Traces,
                         timeout=timeout, what="traces")


def fetch_profile(endpoint: str, timeout: float = 10.0) -> Dict[str, Any]:
    """One-shot profile pull: ``{"role", "endpoint", "t_reply_ns",
    "profile": <SamplingProfiler.report()>}`` from any serving process
    (primary or replica), slot-free. The report is empty-but-valid when
    the remote runs without ``profile_continuous``."""
    return control_probe(endpoint, MsgType.Control_Profile,
                         MsgType.Control_Reply_Profile,
                         timeout=timeout, what="profile")


def fetch_stats(endpoint: str, timeout: float = 10.0) -> StatsSnapshot:
    """One-shot live stats RPC: the server's dashboard as a
    :class:`StatsSnapshot` (histograms rebuilt from their bucket arrays,
    so p50/p95/p99 compute caller-side on the server's exact counts)."""
    return StatsSnapshot(control_probe(endpoint, MsgType.Control_Stats,
                                       MsgType.Control_Reply_Stats,
                                       timeout=timeout, what="stats"))


def fetch_digest(endpoint: str, timeout: float = 30.0) -> Dict[str, Any]:
    """One-shot state-digest probe: ``{"role", "endpoint", "watermark",
    "layout_version", "tables": {tid: {"digest", "rows"}}}`` from any
    serving process — primary, replica, or standby serving reads —
    computed under its dispatcher seam so the (digest, watermark) pair
    is exact. Slot-free. The fleet auditor (obs/audit.py) compares
    these across roles at a common watermark."""
    return control_probe(endpoint, MsgType.Control_Digest,
                         MsgType.Control_Reply_Digest,
                         timeout=timeout, what="digest")


def fetch_cut(endpoint: str, cut_id: str, timeout: float = 120.0,
              kill: str = "") -> Dict[str, Any]:
    """One-shot consistent-cut marker: ask a shard primary to snapshot
    every table at its WAL fence into ``cut_<cut_id>/`` and reply
    ``{"cut_id", "fence", "segment", "cut_dir", "digests", "tables",
    "dedup_count"}``. ``kill="shard"`` rides the payload for the
    MV_CUT_KILL chaos drill (the shard dies after its snapshot, before
    replying — the coordinator must fail the whole cut)."""
    return control_probe(endpoint, MsgType.Control_Cut,
                         MsgType.Control_Reply_Cut, timeout=timeout,
                         what="cut", payload={"cut_id": str(cut_id),
                                              "kill": kill or ""})


# -- client side -------------------------------------------------------------

class RemoteChannel:
    """WorkerTable request channel that frames requests over TCP."""

    def __init__(self, client: "RemoteClient") -> None:
        self._client = client

    def worker_id(self) -> int:
        return self._client.worker_id

    def submit(self, table_id: int, msg_type: MsgType, request: Any,
               msg_id: int, completion: Completion) -> None:
        self._client._send(table_id, msg_type, request, msg_id, completion)

    def post(self, table_id: int, msg_type: MsgType) -> None:
        self._client._send(table_id, msg_type, None, next_msg_id(), None)


class DeadlineMinter:
    """Mints the absolute monotonic deadline stamped on every correlated
    Get/Add from the ``request_deadline_seconds`` budget.

    With ``deadline_tighten_ratio`` > 0 the minted budget tracks the SLO
    burn engine: while any objective fires, each mint shrinks the
    effective budget geometrically (``_STEP`` per mint) toward the floor
    ``ratio x budget`` — backlog age follows the error budget instead of
    queueing 30-second hopes behind a burning fleet — and when the burn
    clears, mints recover geometrically back to the full budget. Both
    transitions are flight-recorded (``deadline_tighten`` /
    ``deadline_recovered``), every tightened mint counts
    ``DEADLINE_TIGHTENED``, and the live scale is the ``DEADLINE_SCALE``
    gauge.

    With ``ratio <= 0`` (the default) ``mint()`` evaluates exactly the
    legacy expression — bit-identical minting, no metrics touched."""

    _STEP = 0.7  # geometric per-mint step toward the floor (and back)

    def __init__(self, budget: float, ratio: float = 0.0,
                 burn: Optional[Callable[[], bool]] = None) -> None:
        self.budget = float(budget)
        self.ratio = min(1.0, float(ratio))
        self.scale = 1.0
        # test seam; None = probe the process-global SLO engine
        self._burn = burn

    def _burning(self) -> bool:
        if self._burn is not None:
            return bool(self._burn())
        import multiverso_tpu_torch as mvt
        engine = mvt.slo_engine()
        return bool(engine is not None and engine.firing())

    def mint(self) -> float:
        """The absolute monotonic deadline for one request (0.0 =
        no deadline)."""
        if self.ratio <= 0 or self.budget <= 0:
            return (time.monotonic() + self.budget
                    if self.budget > 0 else 0.0)
        scale = self.scale
        if self._burning():
            tightened = max(self.ratio, scale * self._STEP)
            if scale >= 1.0 and tightened < 1.0:
                flight_dump("deadline_tighten", budget=self.budget,
                            floor=self.ratio, scale=tightened)
            scale = tightened
        elif scale < 1.0:
            scale = min(1.0, scale / self._STEP)
            if scale >= 1.0:
                flight_dump("deadline_recovered", budget=self.budget)
        if scale < 1.0:
            count("DEADLINE_TIGHTENED")
        if scale != self.scale:
            self.scale = scale
            gauge_set("DEADLINE_SCALE", scale)
        return time.monotonic() + self.budget * scale


class _Inflight:
    """One outstanding correlated request: the framed message (for
    retransmission) plus its retry clock. ``first`` is the issue time —
    the request-latency histogram measures from here, so retransmits
    lengthen (never reset) the observed latency."""

    __slots__ = ("msg", "sent", "first", "attempts")

    def __init__(self, msg: Message, sent: float) -> None:
        self.msg = msg
        self.sent = sent
        self.first = sent
        self.attempts = 0


class RemoteClient:
    """Table client of a serving process: register → worker id + table
    directory.

    Survives faults (``docs/fault_tolerance.md``): correlated requests are
    kept in an inflight set and retransmitted on reply timeout
    (``request_retry_seconds``) or after reconnect-and-resume
    (``reconnect_deadline_seconds``); the server's dedup window keeps every
    replay idempotent. A maintenance thread renews the worker's lease with
    heartbeats. ``reconnect_deadline_seconds=0`` restores the fail-fast
    posture: any connection loss fails all pending requests immediately.

    Read tier: with ``read_endpoints`` (serving read replicas) and a
    non-primary ``read_preference``, Gets and queries route through
    :class:`~multiverso_tpu_torch.runtime.read.ReadRouter` — client cache,
    then budget-admitted replicas (hedged optionally), then the primary as
    the transparent fallback. Adds always go to the primary. Pipelined
    tables bypass the tier (their Gets depend on per-worker server state a
    replica does not track)."""

    def __init__(self, endpoint: str, timeout: float = 30.0,
                 read_endpoints: Optional[List[str]] = None,
                 read_preference: Optional[str] = None) -> None:
        self._net = make_net()
        self._net.rank = -1
        self._net.connect([endpoint])
        self._pending: Dict[int, Completion] = {}
        self._inflight: Dict[int, _Inflight] = {}
        self._lock = threading.Lock()
        self._compress = bool(config.get_flag("wire_compression"))
        self._trace = bool(config.get_flag("trace_requests"))
        # 31-bit nonzero session nonce: req_id = (session << 32) | seq
        # stays within the header's signed 64-bit field
        self._session = random.getrandbits(31) | 1
        self._req_seq = itertools.count(1)
        self._closed = False
        self._recovering = False
        self._recover_lock = threading.Lock()
        self._stop_maint = threading.Event()
        self._hb_period = float(config.get_flag("heartbeat_seconds"))
        self._rto = float(config.get_flag("request_retry_seconds"))
        # overload survival (fault/retry.py): deadline budget stamped on
        # every correlated request (0 = none), a success-refilled retry
        # budget governing retransmits + read hedges, and a circuit
        # breaker that fails writes fast while the server is suspect.
        # Defaults leave all three inert.
        self._deadline_budget = float(
            config.get_flag("request_deadline_seconds"))
        self._minter = DeadlineMinter(
            self._deadline_budget,
            float(config.get_flag("deadline_tighten_ratio")))
        self._retry_budget = RetryBudget.from_flags()
        self._breaker = CircuitBreaker.from_flags()
        # set BEFORE the pump starts (the pump observes reply watermarks
        # through it); the router itself is built after registration
        self._read_router = None
        self._read_ok: Dict[int, bool] = {}
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True, name="mv-remote-client")
        self._pump_thread.start()
        self.worker_id = -1
        self.directory: List[Dict[str, Any]] = []
        self.num_workers = 0
        try:
            self._register(timeout)
        except BaseException:
            self._net.finalize()
            raise
        self._channel = RemoteChannel(self)
        preference = (read_preference if read_preference is not None
                      else str(config.get_flag("read_preference")))
        if read_endpoints and preference != "primary":
            from multiverso_tpu_torch.runtime.read import ReadRouter

            def primary_submit(table_id, request, completion):
                self._send(table_id, MsgType.Request_Get, request,
                           next_msg_id(), completion, direct=True)

            def primary_query_submit(table_id, request, completion):
                self._send(table_id, MsgType.Request_Query, request,
                           next_msg_id(), completion, direct=True)

            self._read_router = ReadRouter(
                list(read_endpoints), preference, primary_submit,
                req_id_source=(self._next_req_id if self._trace else None),
                watermark_confirm=(
                    self._confirm_watermark
                    if self._trace
                    and bool(config.get_flag("trace_read_confirm"))
                    else None),
                retry_budget=self._retry_budget,
                primary_query_submit=primary_query_submit)
        self._start_maintenance()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop_maint.set()
        if self._read_router is not None:
            self._read_router.close()
        try:
            self._net.send(Message(src=self.worker_id, dst=0,
                                   type=MsgType.Control_Deregister,
                                   msg_id=next_msg_id()))
        except OSError:
            pass  # server already gone; slot stays leased (static membership)
        self._net.finalize()

    def _next_req_id(self) -> int:
        return (self._session << 32) | (next(self._req_seq) & 0xFFFFFFFF)

    def _confirm_watermark(self, req_id: int) -> None:
        """Read-tier trace confirm: fire one slot-free Control_Watermark
        at the primary stamped with a replica-served Get's req_id. The
        reply both extends the trace across the primary and advances the
        read cache's horizon off the authoritative append watermark.
        Fire-and-forget: a lost frame just shortens the trace."""
        try:
            self._net.send(Message(
                src=self.worker_id, dst=0, type=MsgType.Control_Watermark,
                msg_id=next_msg_id(), req_id=req_id, trace=True))
        except OSError:
            pass  # diagnostics never trip recovery; the read already won

    def _register(self, timeout: float, resume: bool = False) -> None:
        """Register (or resume) this client's worker slot. The request is
        re-sent once a second until the reply lands or ``timeout`` passes —
        registration rides the same lossy wire as everything else, and the
        server's dedup window makes the replay idempotent."""
        msg_id = next_msg_id()
        completion = Completion()
        with self._lock:
            self._pending[msg_id] = completion
        payload: Dict[str, Any] = {"session": self._session}
        if resume:
            payload["resume"] = self.worker_id
        msg = Message(src=self.worker_id if resume else -1, dst=0,
                      type=MsgType.Control_Register, msg_id=msg_id,
                      req_id=self._next_req_id(), data=wire.encode(payload))
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._net.send(msg)
                info = completion.wait(
                    min(1.0, max(0.05, deadline - time.monotonic())))
                break
            except TimeoutError:  # before OSError: TimeoutError IS one
                if time.monotonic() >= deadline:
                    with self._lock:
                        self._pending.pop(msg_id, None)
                    raise TimeoutError(
                        "remote registration timed out") from None
            except OSError:
                with self._lock:
                    self._pending.pop(msg_id, None)
                raise  # caller's retry loop owns the backoff
        if "error" in info:
            raise RuntimeError(f"remote registration refused: {info['error']}")
        self.worker_id = int(info["worker_id"])
        self.num_workers = int(info["num_workers"])
        self.directory = info["tables"]

    # -- request path --------------------------------------------------------
    def _read_tier_ok(self, table_id: int) -> bool:
        """Tables whose Gets may route through the read tier: everything
        except pipelined tables (their Gets read per-worker server state
        — what THIS worker has seen — which replicas don't track)."""
        ok = self._read_ok.get(table_id)
        if ok is None:
            spec = next((s for s in self.directory
                         if int(s.get("table_id", -1)) == int(table_id)),
                        None)
            ok = spec is not None and not spec.get("is_pipelined", False)
            self._read_ok[table_id] = ok
        return ok

    def _send(self, table_id: int, msg_type: MsgType, request: Any,
              msg_id: int, completion: Optional[Completion],
              direct: bool = False, watermark: int = -1,
              deadline: Optional[float] = None) -> int:
        """Returns the req_id the request was issued under (0 for
        fire-and-forget posts) so callers a layer up — the shard router —
        can append their own hops to the same trace. ``direct`` skips the
        read tier (its primary fallback leg). ``watermark`` is the layout
        version a shard router stamps (-1: a plain client, never fenced).
        ``deadline`` is an absolute monotonic instant (None = mint one
        from the request_deadline_seconds flag; 0.0 = explicitly none)."""
        if self._read_router is not None and not direct:
            if (msg_type == MsgType.Request_Get and completion is not None
                    and self._read_tier_ok(table_id)):
                return self._read_router.submit_get(table_id, request,
                                                    completion)
            if (msg_type == MsgType.Request_Query and completion is not None
                    and self._read_tier_ok(table_id)):
                # top-k pushdown rides the same read tier: replica-first
                # with budget admission, caching and hedging, primary
                # fallback via direct=True
                return self._read_router.submit_query(table_id, request,
                                                      completion)
            if msg_type == MsgType.Request_Add:
                # this client just changed the table: its cached reads of
                # it are suspect (write-through invalidation)
                self._read_router.note_local_write(table_id)
        if completion is not None and msg_type in (MsgType.Request_Get,
                                                   MsgType.Request_Add,
                                                   MsgType.Request_Query):
            if deadline is None:
                deadline = self._minter.mint()
            if deadline > 0 and deadline <= time.monotonic():
                # the caller's budget is already gone: spending a round
                # trip to learn that would be the overload amplifier this
                # layer exists to remove
                count("DEADLINE_EXPIRED_AT_SEND")
                completion.fail(RuntimeError(
                    f"deadline_exceeded: {msg_type.name} expired before "
                    "send"))
                return 0
            if not self._breaker.allow():
                # tripped breaker: fail fast with the truth instead of
                # queueing onto a server we believe is down
                count("BREAKER_FAST_FAILS")
                completion.fail(RuntimeError(
                    "circuit open: server connection suspect after "
                    "consecutive failures; failing fast (half-open probe "
                    f"in <= {self._breaker.reset_seconds:.1f}s)"))
                return 0
        data = [] if request is None and msg_type not in (
            MsgType.Request_Get, MsgType.Request_Add) else wire.encode(
                request, compress=self._compress)
        msg = Message(src=self.worker_id, dst=0, type=msg_type,
                      table_id=table_id, msg_id=msg_id,
                      deadline=deadline if deadline is not None else 0.0,
                      req_id=self._next_req_id() if completion is not None
                      else 0,
                      trace=self._trace and completion is not None,
                      # a shard router stamps its layout version here so a
                      # mid-migration donor refuses (Reply_WrongShard)
                      # instead of applying a possibly-misrouted request;
                      # plain clients leave -1 (never fenced)
                      watermark=watermark,
                      data=data)
        with self._lock:
            if completion is not None:
                self._pending[msg_id] = completion
                self._inflight[msg_id] = _Inflight(msg, time.monotonic())
                gauge_set("CLIENT_INFLIGHT", len(self._inflight))
                hop(msg.req_id, "client_send")
                if msg_type in (MsgType.Request_Get, MsgType.Request_Add,
                                MsgType.Request_Query):
                    # chargeback plane: stamp the span with its tenant and
                    # meter the payload bytes it pushed onto the wire
                    tenant = resolve_tenant(table_id)
                    tag_tenant(msg.req_id, tenant)
                    count(f"TENANT_{tenant}_BYTES",
                          sum(int(getattr(b, "nbytes", 0) or len(b))
                              for b in data))
            if self._recovering:
                # recovery retransmits the whole inflight set (in req_id
                # order) once re-registered; sending now would race it
                return msg.req_id
        try:
            self._net.send(msg)
        except OSError:
            if completion is None:
                raise  # fire-and-forget posts keep the fail-loud contract
            self._start_recovery()  # the request stays inflight; recovery
            # (or its deadline) settles the completion
        return msg.req_id

    def _pump(self) -> None:
        while True:
            try:
                msg = self._net.recv()
            except ConnectionError:
                if not self._closed:
                    self._start_recovery()
                continue
            if msg is None:
                self._fail_all(ConnectionError("remote client shut down"))
                return
            if self._read_router is not None and msg.watermark >= 0:
                # primary replies advertise the append watermark: the
                # cache horizon advances (and a regression — a new
                # primary incarnation — flushes it)
                self._read_router.observe_primary_watermark(msg.watermark)
            if msg.type == MsgType.Control_Reply_Watermark:
                # the read tier's trace confirm coming home: no pending
                # completion (fire-and-forget), but the hop closes the
                # client-primary request/reply pair
                hop(msg.req_id, "client_watermark_reply")
                continue
            with self._lock:
                completion = self._pending.pop(msg.msg_id, None)
                flight = self._inflight.pop(msg.msg_id, None)
                gauge_set("CLIENT_INFLIGHT", len(self._inflight))
            if completion is None:
                continue  # duplicate reply (retransmit + dedup): settled
            # ANY correlated reply — success or server-side error — proves
            # the connection lives: refill the retry budget, feed the
            # breaker (its failure signal is silence, not error payloads)
            self._retry_budget.on_success()
            self._breaker.record_success()
            if flight is not None:
                # end-to-end request latency, retransmits included — the
                # distribution mv.stats() reports as CLIENT_REQUEST_SECONDS
                observe("CLIENT_REQUEST_SECONDS",
                        time.monotonic() - flight.first)
            hop(msg.req_id, "client_reply")
            try:
                if msg.type == MsgType.Reply_Error:
                    text = wire.decode(msg.data)
                    if (isinstance(text, str) and text.startswith("shed:")
                            and flight is not None
                            and flight.msg.type == MsgType.Request_Add):
                        # admission-shed training write: the graceful-
                        # degradation contract — the delta is DROPPED (a
                        # lost async gradient, Downpour-tolerated), the
                        # caller is not errored, the shed is counted
                        count("CLIENT_ADDS_SHED")
                        completion.done(None)
                    else:
                        completion.fail(RuntimeError(
                            f"server-side failure: {text}"))
                elif msg.type == MsgType.Reply_WrongShard:
                    refusal = wire.decode(msg.data)
                    completion.fail(WrongShardError(
                        refusal.get("layout_version", 0),
                        refusal.get("manifest")))
                elif msg.type == MsgType.Reply_Add:
                    completion.done(None)
                else:
                    completion.done(wire.decode(msg.data))
            except Exception as exc:  # noqa: BLE001 — a malformed reply must
                # fail its waiter, not kill the pump (which would hang every
                # later request forever)
                completion.fail(exc)

    # -- fault recovery ------------------------------------------------------
    def _start_recovery(self) -> None:
        # connection loss is the strongest failure signal the breaker gets
        self._breaker.record_failure()
        with self._recover_lock:
            if self._recovering or self._closed:
                return
            self._recovering = True
        threading.Thread(target=self._recover, daemon=True,
                         name="mv-remote-reconnect").start()

    def _recover(self) -> None:
        """Reconnect-and-resume: re-register under the same session (the
        server re-leases the same worker id) with backoff until the
        deadline, then retransmit every inflight request in issue order —
        the server's dedup window drops the ones that already applied.
        Deadline exhaustion (or a refusal — evicted slot, capacity) fails
        all pending requests with a clean error: the fail-fast
        behavior, just ``reconnect_deadline_seconds`` later."""
        policy = RetryPolicy.from_flags()
        last_error: BaseException = ConnectionError("connection lost")
        resumed = False
        try:
            for _attempt, remaining in policy.attempts():
                if self._closed:
                    return
                try:
                    self._register(timeout=min(2.0, max(0.1, remaining)),
                                   resume=True)
                except RuntimeError as exc:
                    self._fail_all(exc)  # refused: permanent, stop retrying
                    return
                except (OSError, TimeoutError) as exc:
                    last_error = exc
                    continue
                with self._lock:
                    backlog = sorted(self._inflight.values(),
                                     key=lambda f: f.msg.req_id)
                    # cleared under _lock: a concurrent _send either saw
                    # _recovering and left its message to this backlog, or
                    # runs after the backlog went out — never both
                    self._recovering = False
                    resumed = True
                    now = time.monotonic()
                    for flight in backlog:
                        flight.attempts += 1
                        flight.sent = now
                        hop(flight.msg.req_id, "client_resume_retransmit")
                        try:
                            self._net.send(flight.msg)
                        except OSError as exc:
                            # died again mid-resume: the pump's next
                            # sentinel starts a fresh recovery; unsent
                            # entries stay inflight for it
                            last_error = exc
                            break
                count("CLIENT_RECONNECTS")
                log.info("remote client %d: reconnected, %d request(s) "
                         "retransmitted", self.worker_id, len(backlog))
                return
            self._fail_all(ConnectionError(
                "server connection lost; reconnect gave up after "
                f"{policy.deadline:.1f}s (last error: {last_error!r})"))
        finally:
            if not resumed:
                with self._recover_lock:
                    self._recovering = False

    def _start_maintenance(self) -> None:
        """Heartbeats (lease renewal) + reply-timeout retransmission; no
        thread at all when both are disabled."""
        periods = [p for p in (self._hb_period, self._rto) if p > 0]
        if not periods:
            return
        tick = max(0.05, min(min(periods) / 4.0, 1.0))
        threading.Thread(target=self._maintain, args=(tick,), daemon=True,
                         name="mv-remote-maint").start()

    def _maintain(self, tick: float) -> None:
        last_beat = 0.0
        while not self._stop_maint.wait(tick):
            if self._closed:
                return
            if self._recovering:
                continue  # recovery owns the connection right now
            now = time.monotonic()
            if (self._hb_period > 0 and self.worker_id >= 0
                    and now - last_beat >= self._hb_period):
                last_beat = now
                try:
                    self._net.send(Message(
                        src=self.worker_id, dst=0,
                        type=MsgType.Control_Heartbeat,
                        msg_id=next_msg_id()))
                except OSError:
                    self._start_recovery()
                    continue
            if self._rto > 0:
                self._retransmit_stale(now)

    def _retransmit_stale(self, now: float) -> None:
        """Re-send correlated requests whose reply is overdue (per-request
        exponential backoff on the timeout). Safe against legitimately
        slow replies — a BSP-gated Get, a busy dispatcher — because the
        server's dedup window swallows the replay."""
        with self._lock:
            if self._recovering:
                return
            stale = []
            for f in self._inflight.values():
                if now - f.sent < self._rto * min(2 ** f.attempts, 16):
                    continue
                # every overdue reply is a failure datapoint for the
                # breaker whether or not the retransmit is admitted
                self._breaker.record_failure()
                if not self._retry_budget.allow():
                    # dry retry budget DEFERS (never fails): sent/attempts
                    # stay put, so the flight re-qualifies next tick and
                    # retries once successes refill the bucket
                    break
                f.attempts += 1
                f.sent = now
                stale.append(f)
        for flight in stale:
            count("CLIENT_RETRIES")
            hop(flight.msg.req_id, "client_retransmit")
            log.debug("remote client %d: retransmitting %s (attempt %d)",
                      self.worker_id, flight.msg.type, flight.attempts)
            try:
                self._net.send(flight.msg)
            except OSError:
                self._start_recovery()
                return

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            self._inflight.clear()
            gauge_set("CLIENT_INFLIGHT", 0)
        if pending:
            # unclean end of session: every in-flight request dies with
            # this error — capture the hop traces while they are fresh
            flight_dump("client_fail_all", worker=self.worker_id,
                        pending=len(pending), error=repr(exc))
        for completion in pending:
            completion.fail(exc)

    # -- table proxies -------------------------------------------------------
    def table(self, table_id: int) -> WorkerTable:
        """Build the worker proxy matching the server table's directory
        entry. Proxies share all shaping code with the in-process workers."""
        spec = next((s for s in self.directory
                     if s["table_id"] == table_id), None)
        if spec is None:
            raise KeyError(f"no remotable table with id {table_id}; "
                           f"directory: {self.directory}")
        kind = spec["kind"]
        if kind == "array":
            return _RemoteArrayWorker(spec, table_id, self._channel)
        if kind == "matrix":
            return _RemoteMatrixWorker(spec, table_id, self._channel)
        if kind == "kv":
            return _RemoteKVWorker(spec, table_id, self._channel)
        if kind == "sparse":
            return _RemoteSparseWorker(spec, table_id, self._channel)
        raise KeyError(f"unknown remote table kind {kind!r}")

    def tables(self) -> List[WorkerTable]:
        return [self.table(s["table_id"]) for s in self.directory]


def _make_error_feedback(shape, dtype) -> Optional[Any]:
    """Per-proxy ErrorFeedback when -wire_quant_bits is set (float32
    tables only — quantization targets gradient-delta payloads)."""
    bits = int(config.get_flag("wire_quant_bits"))
    if bits <= 0 or np.dtype(dtype) != np.float32:
        return None
    from multiverso_tpu_torch.utils.quantization import ErrorFeedback
    return ErrorFeedback(shape, bits)


class _RemoteArrayWorker(ArrayWorker):
    """ArrayWorker shaping over the wire (no server construction)."""

    def __init__(self, spec, table_id: int, channel: RemoteChannel) -> None:
        WorkerTable.__init__(self, channel=channel)
        self.table_id = table_id
        self.size = int(spec["size"])
        self.dtype = np.dtype(spec["dtype"])
        self._ef = _make_error_feedback((self.size,), self.dtype)

    def _submit(self, msg_type, request):
        # quantize ADD deltas on the way out (error feedback keeps the
        # lost precision in the client residual) — the server decodes to
        # plain float32 before process_add
        if (self._ef is not None and msg_type == MsgType.Request_Add
                and isinstance(request, tuple) and len(request) >= 2
                and isinstance(request[0], np.ndarray)
                and request[0].dtype == np.float32):
            request = (self._ef.compress(request[0]),) + request[1:]
        return super()._submit(msg_type, request)

    # device IO is in-process only (a remote hop IS a host hop); without
    # this override the class attribute inherited from ArrayWorker would
    # send per-leaf device requests over TCP
    supports_device_io = False

    def get_device(self):
        raise RuntimeError("get_device() needs the table in this process; "
                           "remote clients hold no table state — use get()")

    def get_device_async(self, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "get/get_async (host arrays)")

    def add_device_async(self, delta, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "add/add_async (host arrays)")

    def sync_leaves_async(self, delta_leaves, option=None, last_leaves=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "add/add_async (host arrays)")

    def push_leaves_async(self, new_leaves, last_leaves, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "add/add_async (host arrays)")

    def get_leaves_async(self, template_leaves, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "get/get_async (host arrays)")


class _RemoteMatrixWorker(MatrixWorker):
    """MatrixWorker shaping (row buckets, sparse cache, option defaults)
    over the wire. Device IO is in-process only (the whole point is
    skipping the host hop; a remote hop IS a host hop) — callers branch on
    ``supports_device_io``."""

    supports_device_io = False

    def get_device_async(self, row_ids, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "get/get_async (host arrays)")

    def transact_device_async(self, fn, others, args=(), touched=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "add/add_async (host arrays)")

    def add_device_async(self, values, row_ids, option=None):
        log.fatal("device IO is in-process only; remote tables use "
                  "add/add_async (host arrays)")

    def __init__(self, spec, table_id: int, channel: RemoteChannel) -> None:
        WorkerTable.__init__(self, channel=channel)
        self.table_id = table_id
        self.num_row = int(spec["num_row"])
        self.num_col = int(spec["num_col"])
        self.dtype = np.dtype(spec["dtype"])
        self._ef = _make_error_feedback((self.num_row, self.num_col),
                                        self.dtype)
        self.is_sparse = bool(spec.get("is_sparse", False))
        self._init_client_state(bool(spec.get("is_pipelined", False)),
                                int(spec.get("num_workers", 1)))

    def _submit(self, msg_type, request):
        # quantize row-delta ADDs with per-row error feedback (whole-table
        # adds use ids=None -> full-shape residual)
        if (self._ef is not None and msg_type == MsgType.Request_Add
                and isinstance(request, tuple) and len(request) == 3
                and isinstance(request[1], np.ndarray)
                and request[1].dtype == np.float32):
            ids, values, option = request
            if ids is not None:
                ids, values = merge_duplicate_rows(ids, values)
            request = (ids, self._ef.compress(values, ids), option)
        return super()._submit(msg_type, request)

    def get_device(self):
        raise RuntimeError("get_device() needs the table in this process; "
                           "remote clients hold no table state — use get()")


class _RemoteKVWorker(KVWorker):
    def __init__(self, spec, table_id: int, channel: RemoteChannel) -> None:
        WorkerTable.__init__(self, channel=channel)
        self.table_id = table_id
        self.value_dtype = np.dtype(spec["dtype"])
        self._raw: Dict[int, Any] = {}


class _RemoteSparseWorker(SparseWorker):
    """Sparse-key table shaping (O(nnz) get/add, counters) over the wire."""

    def __init__(self, spec, table_id: int, channel: RemoteChannel) -> None:
        WorkerTable.__init__(self, channel=channel)
        self.table_id = table_id
        self.key_space = int(spec["key_space"])
        self.width = int(spec["width"])
        self.dtype = np.dtype(spec["dtype"])
        self.elements_pushed = 0
        self.elements_pulled = 0
