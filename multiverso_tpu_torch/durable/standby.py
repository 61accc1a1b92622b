"""Warm-standby failover: a second process that tails the primary's WAL
(port of ``multiverso_tpu/durable/standby.py``; the replication frames are
the JAX package's, so a standby of either package tails a primary of
either package).

Dean et al. (NIPS 2012) motivate the warm replica: async training at real
traffic cannot afford a cold restart — the replacement must already hold
the tables when the primary dies. :class:`WarmStandby` delivers that on
the existing wire machinery:

1. **Subscribe** — dial the primary and send ``Control_Replicate``; the
   reply is a quiesced full-state transfer (every table's checkpoint
   bytes + the Add half of the req-id dedup window).
2. **Tail** — the primary forwards every durable WAL append as a
   ``Control_Wal_Record`` frame; the standby applies it to its own tables
   on its dispatcher thread and accumulates the ``(req_id, worker,
   msg_id)`` seeds. Because the primary writes the replication frame
   before the client's ACK frame, an acknowledged Add is always on the
   standby's socket before the primary can die.
3. **Detect** — the primary's liveness rides a lease
   (:class:`~multiverso_tpu_torch.fault.detector.LivenessDetector`): every
   record or heartbeat renews it; on connection loss the standby
   re-subscribes (full state transfer again — cheap insurance against a
   blip) while the lease keeps ticking.
4. **Take over** — when the lease expires, the standby binds the service
   endpoint (``mv.serve``) with its accumulated dedup seeds. Existing
   client retry/reconnect logic resumes against it transparently: resume
   claims are granted (fresh lease table), in-flight Adds retransmit, and
   the seeded dedup window keeps every replayed Add exactly-once.

The service endpoint must be one the clients can re-dial — same host:port
(this module's tests), a VIP, or DNS that fails over with the role.

**Serving read replica** (docs/serving.md): the standby already holds a
live, record-lag-fresh copy of every table — ``serve_reads()`` promotes
it into a read replica. A small listener answers slot-free
``Request_Read`` frames (no worker slot, no lease, no dedup entry),
serialized with the replay applies, each reply stamped with the replay
watermark (the WAL record sequence the replica has applied through). The
staleness contract is Ho et al.'s SSP bound generalized from clocks to
reads: a request carrying a staleness budget of B records is answered
only while ``primary append watermark − replay watermark ≤ B`` —
otherwise the replica refuses and the client falls back to the primary.
Every replicated record carries its append sequence, so a stream gap
(a chaos-dropped frame) is DETECTED and forces a resubscribe instead of
silently under-reporting the lag. ``takeover=False`` builds a pure read
replica (several can tail one primary; none races to bind its endpoint
when it dies — budget-bound reads refuse instead).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.dashboard import Dashboard, count, gauge_set, observe
from multiverso_tpu_torch.fault.detector import LivenessDetector
from multiverso_tpu_torch.obs.trace import flight_dump, hop
from multiverso_tpu_torch.fault.inject import make_net
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.contracts import slot_free
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id
# the reply codec takes host arrays; remote's import also defines the
# wire_compression flag the read server reads
from multiverso_tpu_torch.runtime.remote import _host_reply
from multiverso_tpu_torch.utils.backoff import Backoff

_PRIMARY = 0  # the lease id the primary is tracked under


class WarmStandby:
    """Replicates a serving primary and takes over its endpoint on death.

    Construct AFTER ``mv.init`` + ``mv.create_table`` (same flags and
    table order as the primary, so table ids and worker-slot arithmetic
    line up), then ``start()``. ``wait_failover()`` blocks until takeover;
    ``stop()`` abandons the standby role cleanly.
    """

    def __init__(self, primary_endpoint: str, service_endpoint: str,
                 tables: Optional[List[Any]] = None,
                 lease_seconds: Optional[float] = None,
                 takeover: bool = True) -> None:
        from multiverso_tpu_torch.runtime.zoo import Zoo
        self._zoo = Zoo.instance()
        if not self._zoo.started or self._zoo.server is None:
            log.fatal("WarmStandby: init() the PS runtime first")
        self._primary_endpoint = primary_endpoint
        self._service_endpoint = service_endpoint
        self.takeover = bool(takeover)
        source = tables if tables is not None else self._zoo._worker_tables
        self._tables: Dict[int, Any] = {}
        for table in source:
            server_table = getattr(table, "_server_table", table)
            self._tables[int(getattr(server_table, "table_id", 0))] = \
                server_table
        self._detector = LivenessDetector(
            float(lease_seconds if lease_seconds is not None
                  else config.get_flag("lease_seconds")))
        self._seeds: List[Tuple[int, int, int]] = []
        self.records_applied = 0
        self.endpoint: Optional[str] = None
        self.took_over = threading.Event()
        self.synced = threading.Event()
        self._stop = threading.Event()
        self._net = None
        self._threads: List[threading.Thread] = []
        # -- watermark state (read-replica tier) --
        # applied_watermark: last WAL record sequence APPLIED to the local
        # tables (the replay watermark stamped on read replies);
        # received_watermark: last sequence RECEIVED off the stream (may
        # run ahead of applied while the tail is held); primary_watermark:
        # the primary's append sequence as last advertised (records,
        # heartbeats, the transfer) — the lag read admission compares
        # against. All -1 until the first state transfer lands.
        self.applied_watermark = -1
        self.received_watermark = -1
        self.primary_watermark = -1
        self.last_contact = time.monotonic()
        # True once the primary's lease expired with takeover=False: the
        # lag is unbounded from here, budget-bound reads refuse
        self.primary_dead = False
        # test/ops seam ("artificially held-back tail"): while set,
        # records are received (watermarks advance, lag grows) but not
        # applied — release_tail() applies the backlog
        self.hold_tail = threading.Event()
        self._held: List[Message] = []
        # chaos seam: called inside the serialized block of every state
        # transfer, right after the load (shard/_child.py's audit drill
        # re-plants its divergence there, so a resubscribe cannot heal it
        # between two digests)
        self.after_transfer: Optional[Callable[[], Any]] = None
        self._awaiting_transfer = False
        # records that arrived while a state transfer was pending: the
        # primary forwards records from the dispatcher thread while the
        # transfer reply rides the pump thread, so records can reach us
        # BEFORE the snapshot that may or may not contain them. They are
        # buffered and the suffix past the transfer's watermark replays
        # after it loads — applying them early would be wiped by the
        # snapshot (acknowledged-Add loss on failover).
        self._pretransfer: List[Message] = []
        self._read_server: Optional[ReplicaReadServer] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WarmStandby":
        self._net = make_net()
        self._net.rank = -1
        self._net.connect([self._primary_endpoint])
        self._send_subscribe()  # raises if the primary is unreachable now
        self._detector.register(_PRIMARY)
        for name, target in (("mv-standby-pump", self._pump),
                             ("mv-standby-watch", self._watch)):
            thread = threading.Thread(target=target, daemon=True, name=name)
            thread.start()
            self._threads.append(thread)
        return self

    def stop(self) -> None:
        """Abandon the standby role (no takeover)."""
        self._stop.set()
        if self._read_server is not None:
            self._read_server.stop()
            self._read_server = None
        if self._net is not None:
            self._net.finalize()
        for thread in self._threads:
            thread.join(timeout=10)
        self._threads.clear()

    def serve_reads(self, endpoint: str = "127.0.0.1:0") -> str:
        """Promote this standby into a serving read replica: bind a
        listener answering slot-free ``Request_Read`` / ``Control_Stats``
        / ``Control_Watermark`` frames, replies stamped with the replay
        watermark. Returns the dialable read endpoint."""
        if self._read_server is None:
            self._read_server = ReplicaReadServer(self, endpoint)
        return self._read_server.endpoint

    @property
    def read_endpoint(self) -> Optional[str]:
        return (self._read_server.endpoint
                if self._read_server is not None else None)

    def lag_records(self) -> int:
        """Records the replica's APPLIED state trails the primary's
        advertised append watermark by (0 when fully caught up)."""
        if self.applied_watermark < 0 or self.primary_watermark < 0:
            return 0
        return max(0, self.primary_watermark - self.applied_watermark)

    def release_tail(self) -> None:
        """Apply the records ``hold_tail`` buffered (test/ops seam)."""
        self.hold_tail.clear()
        held, self._held = self._held, []
        for msg in held:
            self._apply(msg)

    def wait_failover(self, timeout: Optional[float] = None) -> str:
        """Block until takeover; returns the bound service endpoint."""
        if not self.took_over.wait(timeout):
            raise TimeoutError("standby: no failover within the timeout "
                               "(primary still alive?)")
        return self.endpoint

    # -- replication stream --------------------------------------------------
    def _send_subscribe(self) -> None:
        # from here until the transfer reply lands, records buffer in
        # _pretransfer (the snapshot may or may not contain them; the
        # reply's watermark decides what replays — _load_state)
        self._awaiting_transfer = True
        self._net.send(Message(src=-1, dst=0,
                               type=MsgType.Control_Replicate,
                               msg_id=next_msg_id()))

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._net.recv()
            except ConnectionError:
                if self._stop.is_set():
                    return
                self._awaiting_transfer = False
                self._pretransfer.clear()
                self._resubscribe()
                continue
            if msg is None:
                return
            self._detector.beat(_PRIMARY)
            self.last_contact = time.monotonic()
            try:
                if msg.type == MsgType.Control_Wal_Record:
                    self._on_record(msg)
                elif msg.type == MsgType.Control_Reply_Replicate:
                    self._awaiting_transfer = False
                    self._load_state(wire.decode(msg.data))
                elif msg.type == MsgType.Control_Heartbeat:
                    # heartbeats advertise the primary's append
                    # watermark: the lag estimate stays honest while
                    # the WAL idles
                    if msg.watermark > self.primary_watermark:
                        self.primary_watermark = msg.watermark
                        self._lag_gauges()
                elif msg.type == MsgType.Reply_Error:
                    log.error("standby: primary refused replication: %s",
                              wire.decode(msg.data) if msg.data else "?")
            except Exception as exc:  # noqa: BLE001 — a dead pump thread
                # stops lease renewal and fakes a primary death; recover
                # by resubscribing (full transfer) instead of dying
                log.error("standby: pump failed on %s (%r) — "
                          "resubscribing", msg.type, exc)
                try:
                    self._send_subscribe()
                except OSError:
                    pass  # conn dying; the ConnectionError path redials

    def _on_record(self, msg: Message) -> None:
        """One replicated record: advance the primary-side watermarks,
        then apply — or buffer it while a state transfer is pending (the
        transfer's snapshot may already contain it; applying it now
        would be wiped by the snapshot load)."""
        seq = int(msg.watermark)
        if seq > self.primary_watermark:
            self.primary_watermark = seq
            self._lag_gauges()
        if self._awaiting_transfer or self.received_watermark < 0:
            self._pretransfer.append(msg)
            return
        self._accept_record(msg)

    def _accept_record(self, msg: Message) -> None:
        """Gap-check and apply one post-transfer record (or buffer it
        under a held tail)."""
        seq = int(msg.watermark)
        if seq >= 0 and self.received_watermark >= 0:
            if seq <= self.received_watermark:
                return  # duplicate (chaos dup action): already applied
            if seq != self.received_watermark + 1:
                # a record vanished from the stream (chaos drop): the
                # local copy has a hole — resubscribe for a fresh
                # transfer rather than silently under-reporting the lag
                count("REPLICA_GAP_RESYNCS")
                log.error("standby: replication gap (have %d, got %d) — "
                          "resubscribing for a full state transfer",
                          self.received_watermark, seq)
                self._held.clear()
                self._pretransfer.clear()
                self._awaiting_transfer = True
                try:
                    self._send_subscribe()
                except OSError:
                    pass  # conn is dying; _resubscribe redials
                return
        self.received_watermark = max(self.received_watermark, seq)
        if self.hold_tail.is_set():
            self._held.append(msg)
            return
        self._apply(msg)

    def _resubscribe(self) -> None:
        """Connection loss: redial while the lease is still live. Success
        triggers a fresh full-state transfer — records missed during the
        blip are covered by the new snapshot."""
        bo = Backoff(base=0.2, cap=2.0, cancel=self._stop)
        while not self._detector.is_evicted(_PRIMARY):
            if not bo.wait():
                return  # _stop fired mid-sleep
            # re-check after the sleep: _failover sets _stop BEFORE binding
            # the service endpoint, so this cannot redial our own takeover
            # server and subscribe a stream nobody will ever read
            if self._stop.is_set() or self._detector.is_evicted(_PRIMARY):
                return
            try:
                self._send_subscribe()  # _socket_for redials lazily
                log.info("standby: replication stream re-established")
                return
            except OSError:
                continue

    def _run(self, fn):
        """Apply on the dispatcher thread, serialized with any local
        traffic (the standby's tables are normally quiet, but the seam is
        the same one checkpoint restore uses)."""
        server = self._zoo.server
        if server is None or not hasattr(server, "run_serialized"):
            return fn()
        return server.run_serialized(fn)

    def _load_state(self, payload: Any) -> None:
        tables = payload.get("tables", {})
        dedup = payload.get("dedup", [])
        watermark = int(payload.get("watermark", -1))

        def run():
            for table_id, blob in tables.items():
                server_table = self._tables.get(int(table_id))
                if server_table is None:
                    log.error("standby: state transfer names unknown table "
                              "%s — create tables in the primary's order",
                              table_id)
                    continue
                data = bytes(np.ascontiguousarray(
                    np.asarray(blob, dtype=np.uint8)))
                # loads into the table's existing tensors (Table.load)
                server_table.load(mv_io.MemoryStream(data))
            # the transfer IS the state at `watermark`: adopt it as both
            # the received and applied position inside the serialized
            # block, so a read serialized behind us sees them together
            self.applied_watermark = watermark
            self.received_watermark = watermark
            if self.after_transfer is not None:
                self.after_transfer()

        self._run(run)
        self._held.clear()
        if watermark > self.primary_watermark:
            self.primary_watermark = watermark
        self._seeds = [tuple(int(x) for x in entry) for entry in dedup]
        # records that raced the transfer onto the wire: replay the
        # suffix the snapshot does NOT contain (seq > watermark), in
        # order; the rest were already in the snapshot
        backlog = sorted(self._pretransfer,
                         key=lambda m: int(m.watermark))
        self._pretransfer = []
        self._lag_gauges()
        self.synced.set()
        log.info("standby: state transfer complete (%d table(s), %d dedup "
                 "seed(s), watermark %d, %d raced record(s))", len(tables),
                 len(self._seeds), watermark, len(backlog))
        for msg in backlog:
            if int(msg.watermark) > watermark:
                self._accept_record(msg)

    def _apply(self, msg: Message) -> None:
        server_table = self._tables.get(msg.table_id)
        if server_table is None:
            log.error("standby: WAL record for unknown table %d dropped",
                      msg.table_id)
            return
        request = wire.decode(msg.data)
        seq = int(msg.watermark)

        def run():
            server_table.process_add(request)
            if seq >= 0:
                # advanced inside the serialized block: a read serialized
                # behind this apply observes state and watermark together
                self.applied_watermark = seq

        self._run(run)
        self._seeds.append((msg.req_id, msg.src, msg.msg_id))
        self.records_applied += 1
        self._lag_gauges()

    def _lag_gauges(self) -> None:
        """REPLICA_WATERMARK / REPLICA_LAG_RECORDS — the replay-lag
        telemetry the slot-free stats RPC serves (docs/observability.md).
        A replica that knows its shard (metrics_shard identity) also
        publishes the shard-labeled twin, so a merged stats fan-out (and
        the Prometheus exposition) reads per-shard pressure without
        joining on endpoint lists."""
        lag = self.lag_records()
        gauge_set("REPLICA_WATERMARK", max(self.applied_watermark, 0))
        gauge_set("REPLICA_LAG_RECORDS", lag)
        try:
            shard = int(config.get_flag("metrics_shard"))
        except Exception:  # noqa: BLE001 — gauge before flag definition
            shard = -1
        if shard >= 0:
            gauge_set(f"REPLICA_SHARD{shard}_LAG_RECORDS", lag)

    # -- failover ------------------------------------------------------------
    def _alive_probe(self) -> bool:
        """Can the primary still accept a TCP connection? The guard
        against FALSE lease expiry: on an oversubscribed host the pump
        thread can starve past the lease while the primary is perfectly
        healthy — taking over then would bind against a live primary and
        fork the service. A genuinely dead primary refuses instantly."""
        import socket as socket_mod
        host, port = self._primary_endpoint.rsplit(":", 1)
        try:
            probe = socket_mod.create_connection(
                (host, int(port)),
                timeout=max(0.5, (self._detector.lease_seconds or 1.0) / 2))
            probe.close()
            return True
        except OSError:
            return False

    # a wedged-but-accepting primary must still fail over eventually:
    # the probe may veto at most this many consecutive lease expiries
    _MAX_PROBE_VETOES = 3

    def _watch(self) -> None:
        period = max(0.05, (self._detector.lease_seconds or 1.0) / 4.0)
        vetoes = 0
        while not self._stop.wait(period):
            if _PRIMARY not in self._detector.reap():
                vetoes = 0  # lease healthy again: stall passed
            else:
                if (vetoes < self._MAX_PROBE_VETOES
                        and self._alive_probe()):
                    vetoes += 1
                    count("STANDBY_FALSE_LEASE_EXPIRY")
                    log.error("standby: lease expired but the primary at "
                              "%s still accepts connections — re-arming "
                              "the lease (%d/%d; scheduling stall, not "
                              "death)", self._primary_endpoint, vetoes,
                              self._MAX_PROBE_VETOES)
                    self._detector.register(_PRIMARY)
                    # the stream itself may be half-dead even though the
                    # primary accepts: a fresh subscribe either refreshes
                    # the state (harmless duplicate on a live stream) or
                    # fails and kicks the dial-level reconnect machinery
                    try:
                        self._send_subscribe()
                    except OSError:
                        pass  # the pump's conn-drop path takes it from here
                    continue
                if self.takeover:
                    self._failover()
                else:
                    # pure read replica: nobody races to bind the dead
                    # primary's endpoint. The lag is unbounded from here,
                    # so budget-bound reads refuse (unbounded-staleness
                    # reads keep serving the last-known state).
                    self.primary_dead = True
                    count("REPLICA_PRIMARY_LOST")
                    log.error("replica: primary lease expired after %d "
                              "replicated record(s) — serving reads with "
                              "UNBOUNDED staleness only", self.records_applied)
                return

    def _failover(self) -> None:
        import multiverso_tpu_torch as mv
        log.info("standby: primary lease expired after %d replicated "
                 "record(s) — taking over %s", self.records_applied,
                 self._service_endpoint)
        count("FAILOVERS")
        if self._read_server is not None:
            # the replica is becoming the primary: its read listener (and
            # the replay watermark it stamps) retires with the role —
            # read clients fall back / re-route on the connection loss
            self._read_server.stop()
            self._read_server = None
        # post-mortem before state changes hands: what was in flight and
        # what the dashboard looked like when the primary's lease expired
        flight_dump("standby_failover", primary=self._primary_endpoint,
                    records_applied=self.records_applied)
        self._stop.set()
        self._net.finalize()
        self._zoo._dedup_seeds = list(self._seeds)
        # the dead primary's port can linger for a beat while the kernel
        # tears the old socket down — retry the bind briefly
        bo = Backoff(base=0.2, cap=1.0, deadline=time.monotonic() + 15.0)
        while True:
            try:
                self.endpoint = mv.serve(self._service_endpoint)
                break
            except OSError as exc:
                if not bo.wait():
                    log.error("standby: could not bind %s after failover: "
                              "%r", self._service_endpoint, exc)
                    raise
        self.took_over.set()
        log.info("standby: serving on %s — clients resume via their "
                 "reconnect path", self.endpoint)


class ReplicaReadServer:
    """The replica's slot-free read listener (docs/serving.md).

    Answers exactly eight frame types — ``Request_Read`` (a watermark-
    stamped Get, admission-checked against the request's staleness
    budget), ``Request_Query`` (slot-free top-k retrieval pushdown,
    admission-checked exactly like a Read), ``Control_Watermark``,
    ``Control_Stats``, ``Control_Traces``, ``Control_Profile``,
    ``Control_Digest`` (the fleet auditor's state-digest probe,
    obs/audit.py) and heartbeats — and refuses everything else
    loudly: a replica is not a write target, and a misdirected Add must
    fail visibly rather than fork state.
    Reads run through the standby's dispatcher-serialized seam, so they
    interleave cleanly with the replay applies and the watermark each
    reply carries is exact for the state it observed."""

    def __init__(self, standby: WarmStandby,
                 endpoint: str = "127.0.0.1:0") -> None:
        self._standby = standby
        self._net = make_net()
        self.endpoint = self._net.bind(0, endpoint)
        if not str(config.get_flag("metrics_role")):
            # serving reads makes this process a replica in the fleet's
            # labeled metrics (unless a launcher already stamped a role)
            config.set_flag("metrics_role", "replica")
        self._compress = bool(config.get_flag("wire_compression"))
        hb = float(config.get_flag("heartbeat_seconds"))
        # freshness window: with heartbeats on, a replica that has heard
        # NOTHING from its primary for this long cannot bound its lag
        # (records may be piling up behind a partition) — budget reads
        # refuse until contact resumes
        self._fresh_window = max(3.0 * hb, 1.0) if hb > 0 else 0.0
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="mv-replica-reads")
        self._thread.start()
        log.info("replica: serving reads on %s", self.endpoint)

    def stop(self) -> None:
        self._net.finalize()
        self._thread.join(timeout=10)

    # -- pump ----------------------------------------------------------------
    def _pump(self) -> None:
        while True:
            try:
                msg = self._net.recv()
            except ConnectionError:
                continue  # a read client went away; nothing to clean up
            if msg is None:
                return
            try:
                self._handle(msg)
            except Exception as exc:  # noqa: BLE001 — keep serving
                log.error("replica: error on %s: %r", msg.type, exc)
                self._reply_error(msg, repr(exc))

    def _handle(self, msg: Message) -> None:
        if msg.type == MsgType.Control_Heartbeat:
            return
        if msg.type == MsgType.Request_Read:
            self._serve_read(msg)
        elif msg.type == MsgType.Request_Query:
            self._serve_query(msg)
        elif msg.type == MsgType.Control_Watermark:
            self._reply_watermark(msg)
        elif msg.type == MsgType.Control_Stats:
            self._net.send_via(msg._conn, Message(
                src=0, dst=msg.src, type=MsgType.Control_Reply_Stats,
                msg_id=msg.msg_id, req_id=msg.req_id,
                data=wire.encode(Dashboard.snapshot())))
        elif msg.type == MsgType.Control_Traces:
            from multiverso_tpu_torch.obs.trace import TRACES
            n = max(1, int(config.get_flag("trace_export_max")))
            self._net.send_via(msg._conn, Message(
                src=0, dst=msg.src, type=MsgType.Control_Reply_Traces,
                msg_id=msg.msg_id, req_id=msg.req_id,
                data=wire.encode({"role": "replica",
                                  "endpoint": self.endpoint or "",
                                  "t_reply_ns": time.time_ns(),
                                  "traces": TRACES.export(n)})))
        elif msg.type == MsgType.Control_Profile:
            from multiverso_tpu_torch.obs.profiler import PROFILER
            self._net.send_via(msg._conn, Message(
                src=0, dst=msg.src, type=MsgType.Control_Reply_Profile,
                msg_id=msg.msg_id, req_id=msg.req_id,
                data=wire.encode({"role": "replica",
                                  "endpoint": self.endpoint or "",
                                  "t_reply_ns": time.time_ns(),
                                  "profile": PROFILER.report()})))
        elif msg.type == MsgType.Control_Digest:
            self._reply_digest(msg)
        else:
            self._reply_error(msg, f"replica serves reads only (got "
                                   f"{msg.type.name}); writes go to the "
                                   "primary")

    # -- read path -----------------------------------------------------------
    @slot_free
    def _refusal(self, budget: int) -> Optional[str]:
        """Why this replica may NOT answer a read with staleness budget
        ``budget`` right now (None = admitted). Budget < 0 is unbounded:
        any synced replica answers."""
        s = self._standby
        if s.applied_watermark < 0:
            return "replica-refused: not yet synced with its primary"
        if budget < 0:
            return None
        if s.primary_dead:
            return ("replica-refused: primary lease expired — staleness "
                    "is unbounded")
        lag = s.lag_records()
        if lag > budget:
            return (f"replica-refused: replay lag {lag} records exceeds "
                    f"the staleness budget {budget}")
        if (self._fresh_window
                and time.monotonic() - s.last_contact > self._fresh_window):
            return ("replica-refused: no primary contact within the "
                    "freshness window — lag cannot be bounded")
        return None

    @slot_free
    def _serve_read(self, msg: Message) -> None:
        if 0.0 < msg.deadline < time.monotonic():
            # the caller's budget is gone: serving would burn a replay-
            # serialized gather on an answer nobody is waiting for
            count("DEADLINE_EXPIRED_DROPS")
            self._reply_error(msg, "deadline_exceeded: read expired "
                                   "before the replica served it")
            return
        refusal = self._refusal(int(msg.watermark))
        if refusal is not None:
            count("REPLICA_READ_REFUSALS")
            self._reply_error(msg, refusal)
            return
        server_table = self._standby._tables.get(msg.table_id)
        if server_table is None:
            self._reply_error(msg, f"replica has no table {msg.table_id}")
            return
        request = wire.decode(msg.data)
        hop(msg.req_id, "replica_serve_read")

        def run():
            # state + watermark observed atomically w.r.t. replay applies;
            # the result is read to host arrays here, inside the block, so
            # a later replay apply cannot show through the reply
            return (_host_reply(server_table.process_get(request)),
                    self._standby.applied_watermark)

        result, watermark = self._standby._run(run)
        count("READS_SERVED_REPLICA")
        hop(msg.req_id, "replica_read_reply_sent")
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Reply_Read,
            table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
            trace=msg.trace, watermark=int(watermark),
            data=wire.encode(result, compress=self._compress)))

    @slot_free
    def _serve_query(self, msg: Message) -> None:
        """Request_Query on a replica: the same admission gate as a
        Request_Read (deadline, staleness budget vs replay lag), then
        the top-k scan runs under the replay-serialized seam so the
        watermark stamped on the Reply_Query names exactly the state
        the scan observed. Cold-tier scans never promote rows — a
        replica's tier residency must track its primary's, not its
        query traffic."""
        if 0.0 < msg.deadline < time.monotonic():
            count("DEADLINE_EXPIRED_DROPS")
            self._reply_error(msg, "deadline_exceeded: query expired "
                                   "before the replica served it")
            return
        refusal = self._refusal(int(msg.watermark))
        if refusal is not None:
            count("REPLICA_READ_REFUSALS")
            self._reply_error(msg, refusal)
            return
        server_table = self._standby._tables.get(msg.table_id)
        if server_table is None:
            self._reply_error(msg, f"replica has no table {msg.table_id}")
            return
        from multiverso_tpu_torch.query import query_table
        request = wire.decode(msg.data)
        hop(msg.req_id, "replica_serve_query")

        def run():
            return (_host_reply(query_table(server_table, request)),
                    self._standby.applied_watermark)

        result, watermark = self._standby._run(run)
        count("QUERIES_SERVED_REPLICA")
        hop(msg.req_id, "replica_query_reply_sent")
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Reply_Query,
            table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
            trace=msg.trace, watermark=int(watermark),
            data=wire.encode(result, compress=self._compress)))

    @slot_free
    def _reply_watermark(self, msg: Message) -> None:
        s = self._standby
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Watermark,
            msg_id=msg.msg_id, req_id=msg.req_id,
            watermark=s.applied_watermark,
            data=wire.encode({"role": "replica",
                              "watermark": s.applied_watermark,
                              "primary_watermark": s.primary_watermark,
                              "lag": s.lag_records(),
                              "primary_dead": bool(s.primary_dead)})))

    @slot_free
    def _reply_digest(self, msg: Message) -> None:
        """Control_Digest: per-table content digests at this replica's
        EXACT applied watermark — computed under the replay-serialized
        seam, so the (digest, watermark) pair names one precise state.
        The fleet auditor compares it against the primary's digest at
        the same watermark; a mismatch is real divergence, not skew."""
        from multiverso_tpu_torch.obs.audit import digest_payload
        s = self._standby
        t0 = time.perf_counter()

        def run():
            return digest_payload(
                s._tables, role="replica", endpoint=self.endpoint or "",
                watermark=int(s.applied_watermark), layout_version=-1)

        payload = s._run(run)
        observe("AUDIT_DIGEST_SECONDS", time.perf_counter() - t0)
        self._net.send_via(msg._conn, Message(
            src=0, dst=msg.src, type=MsgType.Control_Reply_Digest,
            msg_id=msg.msg_id, req_id=msg.req_id,
            watermark=int(payload.get("watermark", -1)),
            data=wire.encode(payload)))

    @slot_free
    def _reply_error(self, msg: Message, text: str) -> None:
        try:
            self._net.send_via(msg._conn, Message(
                src=0, dst=msg.src, type=MsgType.Reply_Error,
                table_id=msg.table_id, msg_id=msg.msg_id, req_id=msg.req_id,
                watermark=self._standby.applied_watermark,
                data=wire.encode(text)))
        except OSError:
            pass  # probing client already gone
