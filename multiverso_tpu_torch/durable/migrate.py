"""Range-filtered WAL tailing for live key-range migration (port of
``multiverso_tpu/durable/migrate.py``; translated records apply through the
recipient's ``process_add``, so on the card they run the scatter kernel).

The recipient half of the shard tier's split/merge/move protocol
(``shard/reshard.py``, docs/sharding.md §migration): a joining shard
subscribes to each donor's WAL stream restricted to the id ranges it is
taking over, absorbs a quiesced raw-value transfer of exactly those
ranges, then tails ``Control_Wal_Record`` frames — translating each Add
from donor-local to recipient-local ids and dropping the parts outside
its ranges — until the coordinator's cutover watermark is reached.

Zero-acknowledged-Add-loss inherits the warm-standby argument
(``durable/standby.py``): the donor writes every replication frame to
the subscriber's socket BEFORE the client's ACK, records carry their
append sequence for gap detection, and records that race the transfer
reply buffer until the transfer's watermark decides which suffix
replays. A detected gap resubscribes for a fresh transfer — safe here
because ``absorb_range`` overwrites raw values (idempotent), unlike an
incremental add replay.

What deliberately does NOT migrate: updater state (momentum/adagrad
accumulators reset on the recipient, like a v1 checkpoint restore) and
the donor's dedup window (a ``Reply_WrongShard`` refusal strictly
implies not-applied, so the router re-issues under a FRESH req_id — no
replayed-id collision is possible on the recipient).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count, gauge_set
from multiverso_tpu_torch.fault.detector import LivenessDetector
from multiverso_tpu_torch.fault.inject import make_net
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id

_DONOR = 0  # the lease id the donor is tracked under


def translate_add(kind: str, request: Any, donor_lo: int, donor_hi: int,
                  rcpt_start: int, rcpt_size: int = 0,
                  num_col: int = 0) -> Optional[Any]:
    """Rewrite one donor-coordinate Add request into recipient
    coordinates, restricted to the migrating donor-local range
    [donor_lo, donor_hi). Returns None when nothing overlaps. Pure — unit
    tested standalone (tests/test_reshard.py).

    ``rcpt_start`` is the recipient-local id the range lands at;
    ``rcpt_size`` (array) / ``num_col`` (matrix) shape the rewritten
    payload. Whole-span donor adds become explicit-id (matrix) or
    zero-padded whole-span (array) recipient adds — both exact under the
    commutative-Add contract."""
    span = donor_hi - donor_lo
    if kind == "matrix":
        row_ids, values, option = request
        values = np.asarray(values)
        if row_ids is None:
            rows = values.reshape(-1, num_col)
            if donor_lo >= rows.shape[0]:
                return None
            hi = min(donor_hi, rows.shape[0])
            ids = np.arange(hi - donor_lo, dtype=np.int32) + rcpt_start
            return ids, rows[donor_lo:hi], option
        row_ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
        mask = (row_ids >= donor_lo) & (row_ids < donor_hi)
        if not mask.any():
            return None
        ids = (row_ids[mask] - donor_lo + rcpt_start).astype(np.int32)
        return ids, values.reshape(len(row_ids), -1)[mask], option
    if kind == "array":
        delta = np.asarray(request[0]).reshape(-1)
        option = request[1]
        if donor_lo >= delta.size:
            return None
        hi = min(donor_hi, delta.size)
        out = np.zeros(rcpt_size, dtype=delta.dtype)
        out[rcpt_start:rcpt_start + (hi - donor_lo)] = delta[donor_lo:hi]
        if not out.any():
            return None
        return out, option
    log.fatal("translate_add: unsupported table kind %r", kind)
    return None


class RangeTailer:
    """Tails ONE donor's WAL for the migrating ranges of a joining shard.

    ``specs`` is a list of per-table dicts::

        {"table_id": <donor table id>, "server_table": <recipient table>,
         "kind": "matrix"|"array", "donor_lo": .., "donor_hi": ..,
         "rcpt_start": .., "rcpt_size": .., "num_col": ..}

    with donor_lo/donor_hi DONOR-local ids and rcpt_start the
    recipient-local id the range lands at. Construct inside the joining
    process (after its tables exist), then ``start()``; the coordinator
    cuts the donor over and hands the watermark to ``wait_watermark``.
    """

    def __init__(self, donor_endpoint: str, specs: List[Dict[str, Any]],
                 zoo=None, lease_seconds: Optional[float] = None) -> None:
        from multiverso_tpu_torch.runtime.zoo import Zoo
        self._zoo = zoo if zoo is not None else Zoo.instance()
        self.donor_endpoint = donor_endpoint
        self._specs = {int(s["table_id"]): s for s in specs}
        self._detector = LivenessDetector(
            float(lease_seconds if lease_seconds is not None
                  else config.get_flag("lease_seconds")))
        self.applied_watermark = -1
        self.received_watermark = -1
        self.donor_watermark = -1
        self.records_applied = 0
        # the last range transfer: its raw bytes, and the seconds from the
        # subscribe to the absorbed values
        self.transfer_bytes = 0
        self.transfer_seconds = 0.0
        self._t_subscribe = 0.0
        self.synced = threading.Event()
        self.failed = threading.Event()
        self.error: str = ""
        self._stop = threading.Event()
        self._awaiting_transfer = False
        self._pretransfer: List[Message] = []
        self._net = None
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RangeTailer":
        self._net = make_net()
        self._net.rank = -1
        self._net.connect([self.donor_endpoint])
        self._send_subscribe()  # raises if the donor is unreachable now
        self._detector.register(_DONOR)
        for name, target in (("mv-migrate-pump", self._pump),
                             ("mv-migrate-watch", self._watch)):
            thread = threading.Thread(target=target, daemon=True, name=name)
            thread.start()
            self._threads.append(thread)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._net is not None:
            self._net.finalize()
        for thread in self._threads:
            thread.join(timeout=10)
        self._threads.clear()

    def lag_records(self) -> int:
        if self.applied_watermark < 0 or self.donor_watermark < 0:
            return 0
        return max(0, self.donor_watermark - self.applied_watermark)

    def wait_watermark(self, watermark: int, timeout: float) -> None:
        """Block until every record through ``watermark`` has applied —
        the catch-up barrier between the donor's cutover reply and the
        recipient starting to serve."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.applied_watermark >= watermark:
                return
            if self.failed.is_set():
                raise ConnectionError(
                    f"migration tail of {self.donor_endpoint} failed: "
                    f"{self.error or 'donor lost'}")
            time.sleep(0.01)
        raise TimeoutError(
            f"migration catch-up to watermark {watermark} timed out "
            f"(applied {self.applied_watermark})")

    # -- replication stream --------------------------------------------------
    def _send_subscribe(self) -> None:
        self._awaiting_transfer = True
        self._t_subscribe = time.monotonic()
        ranges = {tid: [int(s["donor_lo"]), int(s["donor_hi"])]
                  for tid, s in self._specs.items()}
        self._net.send(Message(src=-1, dst=0, type=MsgType.Control_Migrate,
                               msg_id=next_msg_id(),
                               data=wire.encode({"tables": ranges})))

    def _fail(self, why: str) -> None:
        self.error = why
        self.failed.set()

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
            self._detector.beat(_DONOR)
            try:
                if msg.type == MsgType.Control_Wal_Record:
                    self._on_record(msg)
                elif msg.type == MsgType.Control_Reply_Migrate:
                    self._awaiting_transfer = False
                    self._load_transfer(wire.decode(msg.data))
                elif msg.type == MsgType.Control_Heartbeat:
                    if msg.watermark > self.donor_watermark:
                        self.donor_watermark = msg.watermark
                        self._lag_gauge()
                elif msg.type == MsgType.Reply_Error:
                    self._fail("donor refused migration subscribe: "
                               f"{wire.decode(msg.data) if msg.data else '?'}")
                    return
            except Exception as exc:  # noqa: BLE001 — a dead pump fakes a
                # donor death; resubscribe (absorb is idempotent)
                log.error("migrate: pump failed on %s (%r) — resubscribing",
                          msg.type, exc)
                try:
                    self._send_subscribe()
                except OSError:
                    pass  # conn dying; the ConnectionError path redials

    def _on_record(self, msg: Message) -> None:
        seq = int(msg.watermark)
        if seq > self.donor_watermark:
            self.donor_watermark = seq
            self._lag_gauge()
        if self._awaiting_transfer or self.received_watermark < 0:
            self._pretransfer.append(msg)
            return
        self._accept_record(msg)

    def _accept_record(self, msg: Message) -> None:
        seq = int(msg.watermark)
        if seq >= 0 and self.received_watermark >= 0:
            if seq <= self.received_watermark:
                return  # duplicate: already applied
            if seq != self.received_watermark + 1:
                # stream gap: the local range copy has a hole. Resync via
                # a fresh transfer — absorb_range overwrites raw values,
                # so re-absorbing plus re-tailing is exact
                count("MIGRATION_GAP_RESYNCS")
                log.error("migrate: replication gap (have %d, got %d) — "
                          "resubscribing", self.received_watermark, seq)
                self._pretransfer.clear()
                self._awaiting_transfer = True
                try:
                    self._send_subscribe()
                except OSError:
                    pass  # conn is dying; _resubscribe redials
                return
        self.received_watermark = max(self.received_watermark, seq)
        self._apply(msg)

    def _resubscribe(self) -> None:
        while (not self._stop.is_set()
               and not self._detector.is_evicted(_DONOR)):
            time.sleep(0.2)
            if self._stop.is_set() or self._detector.is_evicted(_DONOR):
                break
            try:
                self._send_subscribe()
                log.info("migrate: donor stream re-established")
                return
            except OSError:
                continue
        if not self._stop.is_set():
            self._fail("donor connection lost past the lease")

    def _run(self, fn):
        server = self._zoo.server
        if server is None or not hasattr(server, "run_serialized"):
            return fn()
        return server.run_serialized(fn)

    def _load_transfer(self, payload: Any) -> None:
        tables = payload.get("tables", {})
        watermark = int(payload.get("watermark", -1))

        def run():
            for table_id, values in tables.items():
                spec = self._specs.get(int(table_id))
                if spec is None:
                    continue
                spec["server_table"].absorb_range(int(spec["rcpt_start"]),
                                                  values)
            self.applied_watermark = watermark
            self.received_watermark = watermark

        self._run(run)
        self.transfer_seconds = time.monotonic() - self._t_subscribe
        self.transfer_bytes = sum(int(np.asarray(v).nbytes)
                                  for v in tables.values())
        if watermark > self.donor_watermark:
            self.donor_watermark = watermark
        backlog = sorted(self._pretransfer, key=lambda m: int(m.watermark))
        self._pretransfer = []
        self._lag_gauge()
        self.synced.set()
        log.info("migrate: range transfer complete (%d table(s), "
                 "watermark %d, %d raced record(s))", len(tables),
                 watermark, len(backlog))
        for msg in backlog:
            if int(msg.watermark) > watermark:
                self._accept_record(msg)

    def _apply(self, msg: Message) -> None:
        seq = int(msg.watermark)
        spec = self._specs.get(int(msg.table_id))
        translated = None
        if spec is not None:
            request = wire.decode(msg.data)
            translated = translate_add(
                spec["kind"], request, int(spec["donor_lo"]),
                int(spec["donor_hi"]), int(spec["rcpt_start"]),
                rcpt_size=int(spec.get("rcpt_size", 0)),
                num_col=int(spec.get("num_col", 0)))
        if translated is None:
            # outside the migrating ranges (or an untracked table): the
            # watermark still advances — catch-up measures stream
            # position, not payload relevance
            if seq >= 0:
                self.applied_watermark = max(self.applied_watermark, seq)
            self._lag_gauge()
            return
        table = spec["server_table"]

        def run():
            table.process_add(translated)
            if seq >= 0:
                self.applied_watermark = seq

        self._run(run)
        self.records_applied += 1
        self._lag_gauge()

    def _lag_gauge(self) -> None:
        gauge_set("MIGRATION_LAG_RECORDS", self.lag_records())

    def _watch(self) -> None:
        period = max(0.05, (self._detector.lease_seconds or 1.0) / 4.0)
        while not self._stop.wait(period):
            if _DONOR in self._detector.reap():
                self._fail("donor lease expired mid-migration")
                return
