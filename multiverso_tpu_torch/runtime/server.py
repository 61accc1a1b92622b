"""Server runtime: the dispatcher that owns table state and applies requests
(port of the async ``Server`` of ``multiverso_tpu/runtime/server.py``).

One dispatcher thread per process pulls typed messages from an in-process
queue and applies them in arrival order; "apply an Add" is an in-place
update of the table's device tensors, "answer a Get" a row gather plus a
host copy. Each drain micro-batches queued Adds per table into one fused
apply (the Downpour-tolerated reordering, see :meth:`Server._dispatch_batch`).

Not yet ported, each for its own slice: the BSP / SSP / deterministic
servers (:func:`make_server` refuses their flags), admission control,
priority lanes, deadlines, the write-ahead log, trace hops and profiler
wait sites. With their defaults those admit every message in arrival
order, so leaving them out changes no result.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import Dashboard, log_bounds, monitor
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

    # Capability flags read by clients (same meaning as in the JAX package):
    # this server neither gates Gets behind round clocks nor defers Adds,
    # and it fuses queued Adds.
    gates_gets = False
    defers_adds = False
    fuses_adds = True

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

    def _on_batch_cap_change(self, _name: str, value) -> None:
        self._apply_batch_cap = max(0, int(value))

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
        self._queue.push(msg)

    # -- dispatcher --------------------------------------------------------
    def _main(self) -> None:
        self._started.set()
        queue_gauge = _apply_metrics()[3]
        while True:
            fuse = self.fuses_adds and self._apply_batch_cap > 0
            msgs = self._queue.pop_all()
            if msgs is None:
                return
            # depth AFTER the drain = requests that arrived behind this batch
            queue_gauge.set(self._queue.size())
            if fuse and len(msgs) > 1:
                self._dispatch_batch(msgs)
            else:
                for msg in msgs:
                    self._dispatch_guarded(msg)

    def _dispatch_guarded(self, msg: Message) -> None:
        try:
            with monitor("SERVER_DISPATCH_MSG"):
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
        fused_c, batched_c, rows_h, _gauge = _apply_metrics()
        try:
            with monitor("SERVER_PROCESS_ADD_MSG"):
                table.process_add(request)
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

    def _dispatch(self, msg: Message) -> None:
        if msg.type == MsgType.Request_Add:
            self._process_add(msg)
        elif msg.type == MsgType.Request_Get:
            self._process_get(msg)
        elif msg.type == MsgType.Server_Execute:
            fn, completion = msg.data
            completion.done(fn())
        elif msg.type == MsgType.Server_Finish_Train:
            pass  # the async server has no clocks to drain
        else:
            log.error("server: unhandled message type %s", msg.type)

    def _process_add(self, msg: Message) -> None:
        with monitor("SERVER_PROCESS_ADD_MSG"):
            request, completion = msg.data
            # process_add may return a fused-get payload (ArrayTable's
            # add+get sync path); plain adds return None
            completion.done(self._tables[msg.table_id].process_add(request))

    def _process_get(self, msg: Message) -> None:
        with monitor("SERVER_PROCESS_GET_MSG"):
            request, completion = msg.data
            completion.done(self._tables[msg.table_id].process_get(request))


def make_server(num_workers: int) -> Server:
    """Factory keyed on the consistency flags (reference:
    ``Server::GetServer``). Only the async server is ported so far."""
    for flag, on in (("sync", bool(config.get_flag("sync"))),
                     ("ssp_staleness", int(config.get_flag("ssp_staleness")) >= 0),
                     ("deterministic", bool(config.get_flag("deterministic")))):
        if on:
            log.fatal("the %s server is not yet ported to multiverso_tpu_torch "
                      "(only the async server is); unset -%s", flag, flag)
    return Server(num_workers)
