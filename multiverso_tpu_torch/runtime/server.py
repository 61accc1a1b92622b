"""Server runtime: the dispatcher that owns table state and applies requests
(port of the async ``Server`` of ``multiverso_tpu/runtime/server.py``).

One dispatcher thread per process pulls typed messages from an in-process
queue and applies them in arrival order; "apply an Add" is an in-place
update of the table's device tensors, "answer a Get" a row gather plus a
host copy. Each drain micro-batches queued Adds per table into one fused
apply (the Downpour-tolerated reordering, see :meth:`Server._dispatch_batch`).

The consistency servers keep the JAX package's contracts exactly:
:class:`DeterministicServer` applies Adds in (round, worker) order and
acknowledges them at enqueue; :class:`SyncServer` is BSP with two-sided
per-worker vector clocks (*every worker's i-th Get observes exactly i
rounds of every worker's Adds*), backup workers and a stall watchdog;
:class:`SSPServer` bounds how many add-rounds a worker may lead the
slowest. None of them fuses Adds. A top-k query (``Request_Query``) is
served on the dispatcher like a Get but passes every round gate.

Around each drain the dispatcher does what the JAX one does: a profiler
wait site (``dispatcher_drain``) around the queue pop, a stable sort into
priority lanes (``priority_lanes``; not on the deterministic server), and
the admission filter (``_admit``): expired-deadline Gets and Adds fail with
:class:`DeadlineExceeded`, refusals of the gate (backlog shedding, tenant
quotas) with :class:`ShedError`. Wire requests leave trace hops at apply,
serve and the round gates. The sync watchdog reaps expired remote leases
(``liveness``, attached by the remote server) and evicts the dead worker
from the round gates with a flight-recorder dump. In-process requests carry
``req_id == 0`` and no deadline, so the admission filter and the traces
pass them untouched. Every Get and Add records its wait from
:meth:`Server.send` to the start of its apply (``SERVER_QUEUE_WAIT_GET`` /
``SERVER_QUEUE_WAIT_ADD``; a fused batch's Adds each up to the fused
apply). The lane sort does reorder: a query, or a Get from
the administrative context (worker id -1), drained together with queued
Adds is answered before them, as the JAX dispatcher does by default.

Write-ahead log hooks (``durable/wal.py``): when ``mv.serve`` runs with
the ``wal_dir`` flag, ``wal`` holds the log and every wire Add is appended
(``_wal_append``) on this thread right before it is applied, or, on the
deterministic server, when it is accepted, so the log's order is the
apply order. A fused micro-batch appends each of its Adds before the one
fused apply (``_apply_fused``). The read tier's primary reads
(``Request_Read``) reach the dispatcher as slot-free Gets.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import (Dashboard, count, gauge_set,
                                            log_bounds, monitor, observe)
from multiverso_tpu_torch.obs.profiler import clear_wait, mark_wait
from multiverso_tpu_torch.obs.trace import flight_dump, hop
from multiverso_tpu_torch.runtime.admission import (AdmissionGate,
                                                    DeadlineExceeded,
                                                    ShedError, lane_order)
from multiverso_tpu_torch.runtime.contracts import dispatcher_only
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.utils import MtQueue


def _apply_metrics():
    """Apply-path metric objects (Dashboard.reset zeroes them in place, so
    the references stay live). APPLY_BATCH_ROWS is count-valued: unit-based
    geometric bounds, not the 1µs latency default."""
    return (Dashboard.counter("APPLY_FUSED_CALLS"),
            Dashboard.counter("APPLY_BATCHED_MSGS"),
            Dashboard.histogram("APPLY_BATCH_ROWS", bounds=log_bounds(lowest=1.0)),
            Dashboard.gauge("SERVER_QUEUE_DEPTH"))


def _queue_wait(msg: Message, name: str) -> None:
    """Record ``msg``'s wait from :meth:`Server.send` to now, the start of
    its own apply: its time in the queue and behind the earlier messages
    of its drain. Into the ``name`` monitor and histogram."""
    if msg.sent_at:
        waited = time.perf_counter() - msg.sent_at
        Dashboard.get(name).observe(waited)
        observe(name, waited)


class _NullCompletion:
    """Fire-and-forget completion for dispatcher work the runtime makes
    itself (watchdog evictions): the dispatcher's guard logs errors,
    nobody waits."""

    __slots__ = ()

    def done(self, result) -> None:
        pass

    def fail(self, error: BaseException) -> None:
        pass


class _ExecWaiter:
    """Minimal completion for :meth:`Server.run_serialized`."""

    __slots__ = ("_event", "result", "error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def done(self, result) -> None:
        self.result = result
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._event.set()

    def wait(self, timeout: Optional[float]):
        if not self._event.wait(timeout):
            raise TimeoutError("dispatcher execution timed out (server "
                               "stopped?)")
        if self.error is not None:
            raise self.error
        return self.result


class Server:
    """Async parameter server dispatcher (reference: async ``Server``).

    One background thread applies requests in arrival order. ``add_async``
    returns once the message is queued; the device update happens on the
    dispatcher thread, overlapping the caller's compute.
    """

    # Capability flags (same meaning as in the JAX package). gates_gets:
    # Gets wait behind round clocks (BSP/SSP), so a fused add+get reply
    # cannot honour the round contract. defers_adds: Adds complete at
    # enqueue and apply later (deterministic order). fuses_adds: the drain
    # loop may micro-batch queued Adds into one fused table apply; the
    # gated and deterministic servers keep it False and apply per message.
    gates_gets = False
    defers_adds = False
    fuses_adds = True
    # reorders_lanes: the drain may stably sort a drained batch into
    # priority lanes (serving reads > control > training writes). The
    # deterministic server keeps it False, as in the JAX package (its
    # arrival order is the log's order there).
    reorders_lanes = True

    @property
    def plain_async(self) -> bool:
        """True iff fused add+get replies are trustworthy and cross-table
        device transactions are admissible."""
        return not (self.gates_gets or self.defers_adds)

    @property
    def supports_named_transact(self) -> bool:
        """Named (registry-resolved) transactions are admissible exactly
        when raw ones are."""
        return self.plain_async

    def __init__(self, num_workers: int) -> None:
        self.num_workers = num_workers
        self._tables: Dict[int, object] = {}  # table_id -> ServerTable
        self._queue: MtQueue[Message] = MtQueue()
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        # micro-batch cap: how many queued Adds one drain may fuse into a
        # single table apply (0 = per-message dispatch); live through the
        # config watch seam
        self._apply_batch_cap = max(0, int(config.get_flag("apply_batch_msgs")))
        self._flag_unsub = config.FLAGS.on_change(
            "apply_batch_msgs", self._on_batch_cap_change)
        # heartbeat/lease tracker of the remote workers, attached by the
        # RemoteServer when it starts serving (fault/detector.py); only
        # the sync watchdog acts on it
        self.liveness = None
        # write-ahead log (durable/wal.py), attached by mv.serve() when the
        # wal_dir flag is set; None = no durability. Wire Adds carry their
        # raw blobs in msg._wal and are appended via _wal_append on this
        # dispatcher thread before the add is applied/ACKed
        self.wal = None
        # overload survival (runtime/admission.py): the drain-time gate
        # (backlog shedding, tenant write quotas) and the lane sort; flags
        # read once here, and the defaults admit everything
        self.admission = AdmissionGate.from_flags()
        self._lane_sort = (self.reorders_lanes
                           and bool(config.get_flag("priority_lanes")))

    def _on_batch_cap_change(self, _name: str, value) -> None:
        self._apply_batch_cap = max(0, int(value))

    @dispatcher_only
    def _wal_append(self, msg: Message) -> None:
        """Append a wire Add's WAL entry (attached by the RemoteServer)
        immediately before it is applied, so WAL order equals apply order
        and recovery replay reproduces the table. The entry is popped so a
        deferred message re-dispatched by a drain loop appends exactly
        once. Runs on the dispatcher thread: appends serialize with
        applies."""
        entry = getattr(msg, "_wal", None)
        if entry is not None and self.wal is not None:
            msg._wal = None
            self.wal.append(*entry)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._main, name="mv-server", daemon=True)
        self._thread.start()
        self._started.wait()

    def stop(self) -> None:
        if self._flag_unsub is not None:
            self._flag_unsub()
            self._flag_unsub = None
        self._queue.exit()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def run_serialized(self, fn: Callable, timeout: Optional[float] = 300.0):
        """Execute ``fn`` on the dispatcher thread, serialized with table
        traffic, and return its result. Re-entrant (runs inline when
        already on the dispatcher thread). ``timeout=None`` waits as long
        as the dispatcher lives."""
        thread = self._thread
        if threading.current_thread() is thread:
            return fn()
        waiter = _ExecWaiter()
        self.send(Message(src=-1, dst=-1, type=MsgType.Server_Execute,
                          data=[fn, waiter]))
        if timeout is not None:
            return waiter.wait(timeout)
        while not waiter._event.wait(10.0):
            if thread is None or not thread.is_alive():
                raise TimeoutError(
                    "dispatcher exited with the serialized execution "
                    "still pending (server stopped?)")
        return waiter.wait(0)

    def register_table(self, server_table) -> int:
        table_id = len(self._tables)
        server_table.table_id = table_id
        self._tables[table_id] = server_table
        return table_id

    def table(self, table_id: int):
        return self._tables[table_id]

    # -- client side -------------------------------------------------------
    def send(self, msg: Message) -> None:
        msg.sent_at = time.perf_counter()
        self._queue.push(msg)

    # -- dispatcher --------------------------------------------------------
    def _main(self) -> None:
        self._started.set()
        queue_gauge = _apply_metrics()[3]
        while True:
            fuse = self.fuses_adds and self._apply_batch_cap > 0
            # profiler wait site: an idle dispatcher parks here
            prev_wait = mark_wait("dispatcher_drain")
            try:
                msgs = self._queue.pop_all()
            finally:
                clear_wait(prev_wait)
            if msgs is None:
                return
            # depth AFTER the drain = requests that arrived behind this batch
            queue_gauge.set(self._queue.size())
            if self._lane_sort and len(msgs) > 1:
                msgs = lane_order(msgs)
            msgs = self._admit(msgs)
            if fuse and len(msgs) > 1:
                self._dispatch_batch(msgs)
            else:
                for msg in msgs:
                    self._dispatch_guarded(msg)
            # park holding no request: a whole-model sync's tensors (its
            # baseline, 3.75 GB for DeepSeek-V2-Lite's share) are freed
            # when its caller drops them, not when the next message comes
            msgs = msg = None

    def _admit(self, msgs: List[Message]) -> List[Message]:
        """Drain-time overload filter: drop expired-deadline Gets and Adds
        (their caller stopped waiting) and ask the admission gate about the
        rest. Both refusals answer the completion truthfully
        (``deadline_exceeded: ...`` / ``shed: ...``). Depth is this batch
        plus what queued behind it."""
        depth = len(msgs) + self._queue.size()
        now = time.monotonic()
        admitted: List[Message] = []
        for msg in msgs:
            if 0.0 < msg.deadline < now and msg.type in (
                    MsgType.Request_Get, MsgType.Request_Add):
                count("DEADLINE_EXPIRED_DROPS")
                hop(msg.req_id, "deadline_drop")
                if msg.data and hasattr(msg.data[-1], "fail"):
                    msg.data[-1].fail(DeadlineExceeded(
                        f"deadline_exceeded: {msg.type.name} expired "
                        f"{now - msg.deadline:.3f}s before apply "
                        f"(backlog {depth})"))
                continue
            text = self.admission.refusal(msg, depth)
            if text is not None:
                if msg.data and hasattr(msg.data[-1], "fail"):
                    msg.data[-1].fail(ShedError(text))
                continue
            admitted.append(msg)
        return admitted

    def _dispatch_guarded(self, msg: Message) -> None:
        try:
            self._dispatch(msg)
        except Exception as exc:  # keep the dispatcher alive; fail the waiter
            log.error("server dispatcher error on %s: %r", msg.type, exc)
            if msg.data and hasattr(msg.data[-1], "fail"):
                msg.data[-1].fail(exc)

    @staticmethod
    def _fusable_add(msg: Message) -> bool:
        """Plain table Adds. Device transactions (request[0] is a tag
        string) read/write several tables — they are full barriers."""
        if msg.type != MsgType.Request_Add or not msg.data:
            return False
        request = msg.data[0]
        return not (isinstance(request, tuple) and request
                    and isinstance(request[0], str))

    def _dispatch_batch(self, msgs: List[Message]) -> None:
        """Micro-batched drain: walk the backlog in arrival order, holding
        plain Adds back in per-table groups; a Get flushes ITS table's group
        first (a worker's own earlier Adds are always visible to its Get),
        any other message is a full barrier. Within one flushed group, Adds
        from different workers reorder into a single fused apply — the
        commutative-Add reordering Downpour SGD (Dean et al., NIPS 2012)
        tolerates."""
        pending: Dict[int, List[Message]] = {}

        def flush(table_id: Optional[int] = None) -> None:
            if table_id is None:
                for tid in list(pending):
                    flush(tid)
                return
            batch = pending.pop(table_id, None)
            if batch:
                self._apply_add_batch(table_id, batch)

        for msg in msgs:
            if self._fusable_add(msg):
                pending.setdefault(msg.table_id, []).append(msg)
                continue
            if msg.type == MsgType.Request_Get:
                flush(msg.table_id)
            else:
                flush()
            self._dispatch_guarded(msg)
        flush()

    def _apply_add_batch(self, table_id: int, msgs: List[Message]) -> None:
        cap = self._apply_batch_cap
        while msgs:
            consumed = self._apply_add_chunk(table_id, msgs[:cap])
            msgs = msgs[consumed:]

    def _apply_add_chunk(self, table_id: int, msgs: List[Message]) -> int:
        """Fuse-and-apply a prefix of ``msgs``; returns how many messages
        were handled (the table's merge may consume fewer than offered to
        bound the fused-apply size)."""
        if len(msgs) == 1:
            self._dispatch_guarded(msgs[0])
            return 1
        table = self._tables.get(table_id)
        merged = None
        if table is not None:
            try:
                # timed: a merge that consumes one request is thrown away
                with monitor("SERVER_MERGE_ADDS"):
                    merged = table.merge_add_requests([m.data[0] for m in msgs])
            except Exception as exc:  # merge must never sink the batch
                log.error("server: merge_add_requests failed on table %d "
                          "(%r); applying per message", table_id, exc)
                merged = None
        if merged is None:
            # the FIRST request cannot merge: dispatch it alone and offer
            # the rest again
            self._dispatch_guarded(msgs[0])
            return 1
        request, rows, consumed = merged
        consumed = max(1, min(int(consumed), len(msgs)))
        if consumed == 1:
            self._dispatch_guarded(msgs[0])
            return 1
        msgs = msgs[:consumed]
        # WAL entries per Add, in arrival order, BEFORE the fused apply (an
        # ACKed Add is always recoverable); recovery replays the records
        # one by one, which sums to the same state for the commutative
        # Adds that merged at all
        for msg in msgs:
            self._wal_append(msg)
            hop(msg.req_id, "apply_add")
            _queue_wait(msg, "SERVER_QUEUE_WAIT_ADD")
        fused_c, batched_c, rows_h, _gauge = _apply_metrics()
        try:
            with monitor("SERVER_PROCESS_ADD_MSG"):
                self._apply_fused(table, request)
        except Exception as exc:
            # process_add validates before it mutates, so a raised error
            # means nothing applied: retry per message
            log.error("server: fused apply of %d adds on table %d failed "
                      "(%r); retrying per message", len(msgs), table_id, exc)
            for msg in msgs:
                try:
                    with monitor("SERVER_PROCESS_ADD_MSG"):
                        msg.data[-1].done(table.process_add(msg.data[0]))
                except Exception as per_exc:
                    msg.data[-1].fail(per_exc)
            return consumed
        fused_c.add(1)
        batched_c.add(len(msgs))
        rows_h.observe(rows)
        for msg in msgs:
            msg.data[-1].done(None)
        return consumed

    def _apply_fused(self, table, request) -> None:
        """The fused apply: a named seam, so a crash-point drill can kill
        the process between a batch's WAL appends and its apply."""
        table.process_add(request)

    def _dispatch(self, msg: Message) -> None:
        if msg.type == MsgType.Request_Add:
            self._process_add(msg)
        elif msg.type == MsgType.Request_Get:
            self._process_get(msg)
        elif msg.type == MsgType.Request_Query:
            self._process_query(msg)
        elif msg.type == MsgType.Server_Execute:
            # administrative callable, serialized with table traffic:
            # never clocked, identical on every server flavor
            fn, completion = msg.data
            completion.done(fn())
        elif msg.type == MsgType.Server_Finish_Train:
            self._process_finish_train(msg)
        else:
            log.error("server: unhandled message type %s", msg.type)

    def _process_add(self, msg: Message) -> None:
        _queue_wait(msg, "SERVER_QUEUE_WAIT_ADD")
        with monitor("SERVER_PROCESS_ADD_MSG"):
            request, completion = msg.data
            self._wal_append(msg)
            hop(msg.req_id, "apply_add")
            # process_add may return a fused-get payload (ArrayTable's
            # add+get sync path); plain adds return None
            completion.done(self._tables[msg.table_id].process_add(request))

    def _process_get(self, msg: Message) -> None:
        _queue_wait(msg, "SERVER_QUEUE_WAIT_GET")
        with monitor("SERVER_PROCESS_GET_MSG"):
            request, completion = msg.data
            hop(msg.req_id, "serve_get")
            completion.done(self._tables[msg.table_id].process_get(request))

    @dispatcher_only
    def _process_query(self, msg: Message) -> None:
        """Request_Query: top-k retrieval pushdown (``query/``). Serialized
        with applies like a Get, so a query sees every Add queued before
        it, but never clocked: on every server flavor it passes the round
        gates as ``Server_Execute`` does."""
        from multiverso_tpu_torch.query import query_table
        with monitor("SERVER_PROCESS_QUERY_MSG"):
            request, completion = msg.data
            hop(msg.req_id, "serve_query")
            completion.done(query_table(self._tables[msg.table_id], request))

    def _process_finish_train(self, msg: Message) -> None:
        pass  # the async server has no clocks to drain


class DeterministicServer(Server):
    """Async server with a deterministic apply order (the ``deterministic``
    flag). Adds are buffered per (table, worker) and applied in
    (round, worker_id) order: round-r deltas apply only once every
    unfinished worker's round-r delta has arrived, then in ascending worker
    id. The final table state is therefore bitwise reproducible run to run
    regardless of thread scheduling (float addition is not associative;
    plain async applies in arrival order). Gets are served immediately.

    Contract: workers issue the same number of Adds per table between
    ``finish_train`` calls; ``finish_train`` releases a finished worker's
    hold on later rounds. Add completions fire at ENQUEUE, not at apply:
    completing at apply would deadlock two workers adding to two tables in
    opposite orders, each waiting for the round-mate Add the other is about
    to send. Apply-time errors therefore surface in the log, not in the
    caller (as with ``add_async``).
    """

    defers_adds = True
    fuses_adds = False
    reorders_lanes = False

    def __init__(self, num_workers: int) -> None:
        super().__init__(num_workers)
        self._add_queues: Dict[int, List[List[Message]]] = {}
        self._det_finished: List[bool] = [False] * num_workers

    def register_table(self, server_table) -> int:
        table_id = super().register_table(server_table)
        self._add_queues[table_id] = [[] for _ in range(self.num_workers)]
        return table_id

    def _process_add(self, msg: Message) -> None:
        if not 0 <= msg.src < self.num_workers:
            super()._process_add(msg)  # administrative: apply immediately
            return
        # WAL entry at ENQUEUE (arrival order), matching the ACK-at-enqueue
        # contract: recovery replays in arrival order, so exactly-once
        # holds across a crash, but the (round, worker) apply order, and
        # with it bitwise run-to-run reproducibility, does not survive a
        # mid-training restart
        self._wal_append(msg)
        self._add_queues[msg.table_id][msg.src].append(msg)
        msg.data[-1].done(None)  # accepted; applies in round order below
        self._drain_adds(msg.table_id)

    def _drain_adds(self, table_id: int) -> None:
        queues = self._add_queues[table_id]
        while any(queues) and all(
                q or self._det_finished[w] for w, q in enumerate(queues)):
            for w, q in enumerate(queues):
                if q:
                    msg = q.pop(0)
                    request, _ = msg.data
                    _queue_wait(msg, "SERVER_QUEUE_WAIT_ADD")
                    try:
                        with monitor("SERVER_PROCESS_ADD_MSG"):
                            self._tables[table_id].process_add(request)
                    except Exception as exc:  # keep the round draining
                        log.error("deterministic add from worker %d on table"
                                  " %d failed at apply time: %r", w,
                                  table_id, exc)

    def _process_finish_train(self, msg: Message) -> None:
        if 0 <= msg.src < self.num_workers:
            self._det_finished[msg.src] = True
        for tid in list(self._tables):
            self._drain_adds(tid)


class SyncServer(Server):
    """BSP dispatcher: per-worker vector clocks and deferred request caches.
    A worker's round-(i+1) Add waits until every worker has finished its
    round-i Get; its round-i Get waits until every worker's round-i Add is
    applied. So each worker's rounds open with an Add."""

    gates_gets = True
    # the two-sided clock defers and releases every Add itself: per-message
    # dispatch is the gate (SSPServer inherits: its Adds bump per-worker
    # clocks that a fused apply could not account)
    fuses_adds = False

    def __init__(self, num_workers: int) -> None:
        super().__init__(num_workers)
        # per-table clocks: adds applied / gets served, per worker
        self._add_clock: Dict[int, List[int]] = {}
        self._get_clock: Dict[int, List[int]] = {}
        self._finished: List[bool] = [False] * num_workers
        self._pending_add: Dict[int, List[Message]] = {}
        self._pending_get: Dict[int, List[Message]] = {}
        # straggler tolerance: the slowest floor(ratio * num_workers)
        # workers' clocks are ignored by the round gates
        self._backup_count = int(
            config.get_flag("backup_worker_ratio") * num_workers)
        # stall watchdog: every `sync_stall_seconds` with no clock progress
        # while requests sit deferred, log WHICH workers hold the round
        self.last_stall: Optional[str] = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        # guards dict INSERTS (register_table, user thread) against the
        # watchdog's iteration; in-place clock list updates never resize
        self._register_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        super().start()
        period = float(config.get_flag("sync_stall_seconds"))
        if period > 0:
            self._watch_thread = threading.Thread(
                target=self._watch_stalls, args=(period,),
                name="mv-sync-watchdog", daemon=True)
            self._watch_thread.start()

    def stop(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=10)
            self._watch_thread = None
        super().stop()

    def _watch_stalls(self, period: float) -> None:
        last_snap = None
        while not self._watch_stop.wait(period):
            self._reap_leases()
            with self._register_lock:
                tids = list(self._add_clock)
                snap_add = {t: list(self._add_clock[t]) for t in tids}
                snap_get = {t: list(self._get_clock[t]) for t in tids}
            pending = {tid: (len(self._pending_add[tid]),
                             len(self._pending_get[tid]))
                       for tid in tids}
            snap = (snap_add, snap_get, pending)
            if last_snap == snap and any(a or g for a, g in pending.values()):
                for tid, (n_add, n_get) in pending.items():
                    if n_add or n_get:
                        self._report_stall(tid, n_add, n_get, period)
            last_snap = snap

    def _reap_leases(self) -> None:
        """Evict every remote worker whose lease expired. The detector
        reports each expiry once; the eviction changes clocks, so it runs
        on the dispatcher thread, serialized with table traffic."""
        liveness = self.liveness
        if liveness is None:
            return
        for worker in liveness.reap():
            if not 0 <= worker < self.num_workers:
                continue
            log.error("sync: lease expired for worker %d — evicting it "
                      "from the round gates", worker)
            self.send(Message(
                src=-1, dst=-1, type=MsgType.Server_Execute,
                data=[lambda w=worker: self._evict_worker(w),
                      _NullCompletion()]))

    @dispatcher_only
    def _evict_worker(self, worker: int) -> None:
        """Remove a dead worker from every clock gate: mark it finished so
        the gates stop waiting on its clocks, fail its own deferred
        requests (their replies have nowhere to go), drain so the
        survivors' rounds proceed, and dump the flight recorder. The
        evicted slot stays retired."""
        if self._finished[worker]:
            return
        self._finished[worker] = True
        count("WORKER_EVICTIONS")
        exc = ConnectionError(
            f"worker {worker} evicted: lease expired (crashed or "
            "partitioned beyond lease_seconds)")
        for tid in list(self._tables):
            for pending in (self._pending_add, self._pending_get):
                mine = [m for m in pending[tid] if m.src == worker]
                if mine:
                    pending[tid] = [m for m in pending[tid]
                                    if m.src != worker]
                    for msg in mine:
                        hop(msg.req_id, "gate_failed_eviction")
                        msg.data[-1].fail(exc)
            self._drain(tid)
        flight_dump("worker_evicted", worker=worker)

    def _report_stall(self, tid: int, n_add: int, n_get: int,
                      period: float) -> None:
        adds, gets = self._add_clock[tid], self._get_clock[tid]
        # blockers: unfinished workers at the minimum clock with NO
        # deferred request of their own (a worker whose request sits in the
        # pending queue is waiting, not holding the round)
        waiting = ({m.src for m in self._pending_add[tid]}
                   | {m.src for m in self._pending_get[tid]})
        unfin = [w for w in range(self.num_workers) if not self._finished[w]]
        if not unfin:
            return
        min_add = min(adds[w] for w in unfin)
        min_get = min(gets[w] for w in unfin)
        at_min = [w for w in unfin if adds[w] == min_add or gets[w] == min_get]
        lag = sorted(w for w in at_min if w not in waiting) or sorted(at_min)
        report = (f"sync stall: table {tid} has {n_add} deferred adds / "
                  f"{n_get} deferred gets with no progress for {period:.1f}s; "
                  f"waiting on worker(s) {lag} (add clocks {adds}, get clocks "
                  f"{gets})")
        self.last_stall = report
        log.error("%s", report)

    # gate-wait telemetry: a deferred request's queue time is the tail the
    # BSP/SSP contract creates, stamped at defer and observed at release
    @staticmethod
    def _gate_defer(msg: Message) -> None:
        msg._gated_at = time.perf_counter()
        hop(msg.req_id, "gate_deferred")

    @staticmethod
    def _gate_release(msg: Message) -> None:
        gated_at = getattr(msg, "_gated_at", None)
        if gated_at is not None:
            observe("SYNC_GATE_WAIT_SECONDS", time.perf_counter() - gated_at)
        hop(msg.req_id, "gate_released")

    def register_table(self, server_table) -> int:
        table_id = super().register_table(server_table)
        with self._register_lock:
            self._add_clock[table_id] = [0] * self.num_workers
            self._get_clock[table_id] = [0] * self.num_workers
            self._pending_add[table_id] = []
            self._pending_get[table_id] = []
        return table_id

    # clock helpers: finished workers never hold anyone back, and the
    # slowest `_backup_count` unfinished workers are ignored
    def _gate(self, vals: List[int]) -> int:
        if not vals:
            return 1 << 60
        k = min(self._backup_count, len(vals) - 1)
        return sorted(vals)[k]

    def _min_gets(self, table_id: int) -> int:
        return self._gate([g for g, f in zip(self._get_clock[table_id],
                                             self._finished) if not f])

    def _min_adds(self, table_id: int) -> int:
        return self._gate([a for a, f in zip(self._add_clock[table_id],
                                             self._finished) if not f])

    def _is_admin(self, worker: int) -> bool:
        """Administrative access (no worker context, worker id -1)
        bypasses the clocks."""
        return not 0 <= worker < self.num_workers

    def _apply_add(self, msg: Message) -> None:
        """Apply a released Add; its completion carries ``process_add``'s
        return value (a fused add+get reply where the table gives one)."""
        request, completion = msg.data
        self._wal_append(msg)
        hop(msg.req_id, "apply_add")
        _queue_wait(msg, "SERVER_QUEUE_WAIT_ADD")
        with monitor("SERVER_PROCESS_ADD_MSG"):
            completion.done(self._tables[msg.table_id].process_add(request))

    def _serve_get(self, msg: Message) -> None:
        request, completion = msg.data
        hop(msg.req_id, "serve_get")
        _queue_wait(msg, "SERVER_QUEUE_WAIT_GET")
        with monitor("SERVER_PROCESS_GET_MSG"):
            completion.done(self._tables[msg.table_id].process_get(request))

    def _process_add(self, msg: Message) -> None:
        tid, worker = msg.table_id, msg.src
        if self._is_admin(worker):
            super()._process_add(msg)
            return
        round_ = self._add_clock[tid][worker] + 1
        # round-r Adds wait until every worker has finished its round-(r-1) Gets
        if self._min_gets(tid) >= round_ - 1:
            self._apply_add(msg)
            self._add_clock[tid][worker] = round_
            self._drain(tid)
        else:
            self._gate_defer(msg)
            self._pending_add[tid].append(msg)

    def _process_get(self, msg: Message) -> None:
        tid, worker = msg.table_id, msg.src
        if self._is_admin(worker):
            super()._process_get(msg)
            return
        round_ = self._get_clock[tid][worker] + 1
        # round-i Gets wait until every worker's round-i Add is applied
        if self._min_adds(tid) >= round_:
            self._serve_get(msg)
            self._get_clock[tid][worker] = round_
            self._drain(tid)
        else:
            self._gate_defer(msg)
            self._pending_get[tid].append(msg)

    def _process_finish_train(self, msg: Message) -> None:
        if self._is_admin(msg.src):
            return
        self._finished[msg.src] = True
        for tid in list(self._tables):
            self._drain(tid)

    def _drain(self, table_id: int) -> None:
        """Release deferred messages whose clock condition now holds."""
        progressed = True
        while progressed:
            progressed = False
            # gets first (they unblock next-round adds)
            still: List[Message] = []
            for msg in self._pending_get[table_id]:
                round_ = self._get_clock[table_id][msg.src] + 1
                if self._min_adds(table_id) >= round_:
                    self._gate_release(msg)
                    self._serve_get(msg)
                    self._get_clock[table_id][msg.src] = round_
                    progressed = True
                else:
                    still.append(msg)
            self._pending_get[table_id] = still
            still = []
            for msg in self._pending_add[table_id]:
                round_ = self._add_clock[table_id][msg.src] + 1
                if self._min_gets(table_id) >= round_ - 1:
                    self._gate_release(msg)
                    self._apply_add(msg)
                    self._add_clock[table_id][msg.src] = round_
                    progressed = True
                else:
                    still.append(msg)
            self._pending_add[table_id] = still


class SSPServer(SyncServer):
    """Stale-synchronous-parallel dispatcher: a worker that has completed
    ``r`` Adds on a table may Get it only once EVERY unfinished worker has
    completed at least ``r - staleness`` Adds, so the fastest worker runs
    at most ``staleness`` rounds ahead of the slowest. ``staleness=0`` is a
    BSP-like read gate. Adds are never deferred: applying a straggler's
    delta cannot break anyone's bound, it only advances the gate.
    ``backup_worker_ratio`` composes as in BSP."""

    def __init__(self, num_workers: int, staleness: int) -> None:
        super().__init__(num_workers)
        self.staleness = int(staleness)

    def _process_add(self, msg: Message) -> None:
        tid, worker = msg.table_id, msg.src
        if self._is_admin(worker):
            Server._process_add(self, msg)
            return
        self._apply_add(msg)
        self._add_clock[tid][worker] += 1
        # observed staleness: how many add-rounds this worker now leads the
        # slowest unfinished worker by (0 = in lockstep)
        gauge_set(f"SSP_STALENESS_W{worker}",
                  self._add_clock[tid][worker] - self._min_adds(tid))
        self._drain(tid)

    def _gate_round(self, tid: int, worker: int) -> int:
        """The add-round this worker's next Get requires every unfinished
        (non-backup) worker to have reached."""
        return self._add_clock[tid][worker] - self.staleness

    def _process_get(self, msg: Message) -> None:
        tid, worker = msg.table_id, msg.src
        if self._is_admin(worker):
            Server._process_get(self, msg)
            return
        if self._min_adds(tid) >= self._gate_round(tid, worker):
            self._serve_get(msg)
            self._get_clock[tid][worker] += 1
        else:
            self._gate_defer(msg)
            self._pending_get[tid].append(msg)

    def _drain(self, table_id: int) -> None:
        still: List[Message] = []
        for msg in self._pending_get[table_id]:
            if self._min_adds(table_id) >= self._gate_round(table_id, msg.src):
                self._gate_release(msg)
                self._serve_get(msg)
                self._get_clock[table_id][msg.src] += 1
            else:
                still.append(msg)
        self._pending_get[table_id] = still


def make_server(num_workers: int) -> Server:
    """Factory keyed on the consistency flags (reference:
    ``Server::GetServer``): ``sync`` → BSP, ``ssp_staleness >= 0`` →
    bounded staleness, ``deterministic`` → reproducible-apply-order async
    (sync mode is already deterministic through its clocks)."""
    if config.get_flag("sync"):
        return SyncServer(num_workers)
    ssp = int(config.get_flag("ssp_staleness"))
    if ssp >= 0:
        return SSPServer(num_workers, ssp)
    if config.get_flag("deterministic"):
        return DeterministicServer(num_workers)
    return Server(num_workers)
