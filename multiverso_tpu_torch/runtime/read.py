"""Client-side read tier: bounded-staleness cache + replica/hedged routing
(port of ``multiverso_tpu/runtime/read.py``; host-only, a client of either
package reads from replicas of either package).

The read half of the serving story (docs/serving.md). Heavy-user-traffic
serving is read-dominated, yet every Get used to burn a worker slot on
the one primary per shard. This module lets a
:class:`~multiverso_tpu_torch.runtime.remote.RemoteClient` route Gets through
three layers, cheapest first:

1. :class:`ReadCache` — a byte-bounded LRU keyed by (table, ids). A hit
   never touches the wire. Entries carry the watermark they were served
   at; they invalidate the instant the client observes a primary append
   watermark more than the staleness budget ahead (watermark
   invalidation), and expire after ``read_lease_seconds`` of wall clock
   regardless (the lease bounds the blind window during which the client
   hears nothing from the serving tier).
2. :class:`ReplicaReader` — slot-free ``Request_Read`` frames to a
   serving read replica (durable/standby.py). The replica admission-
   checks the request's staleness budget against its replay lag and
   stamps the reply with its replay watermark.
3. The primary — the pre-replica path, used when the preference is
   ``primary``, when no replica is fresh enough, or as the transparent
   fallback when replicas refuse, die, or time out. Fallback is silent:
   a caller never sees a replica failure, only (at worst) primary
   latency.

``hedged`` preference (the tail-tolerance policy): fire the first-choice
replica, arm a timer at the p95 of recent read latencies, and fire the
second choice when it expires with no reply. First reply wins; the loser
is cancelled (its late reply is dropped on the floor, its in-flight
entry reaped).

Consistency contract, spelled out: a Get answered through this tier is
at most ``read_staleness_records`` WAL records staler than the primary's
append watermark as observed by the serving replica (the generalized
SSP bound, Ho et al. NIPS'13) — plus, for cache hits only, at most
``read_lease_seconds`` of wall clock during which the client heard
nothing newer. Callers that need the primary's exact present read with
``read_preference=primary`` (the default — this whole tier is opt-in).

``Request_Query`` (server-side top-k retrieval pushdown, query/) rides
the same three layers under the same budgets: a namespaced cache key
(query bytes + k + metric), replica admission against the staleness
budget, p95-derived hedging, silent primary fallback. A separate
``QUERY_*`` counter family keeps retrieval traffic legible apart from
training Gets.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count, gauge_add, gauge_set
from multiverso_tpu_torch.fault.inject import make_net
from multiverso_tpu_torch.obs.trace import hop, tag_tenant
from multiverso_tpu_torch.runtime.admission import resolve_tenant
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id

READ_PREFERENCES = ("primary", "replica", "hedged")


def validate_read_preference(value: str) -> str:
    value = str(value).strip().lower()
    if value not in READ_PREFERENCES:
        log.fatal("read_preference must be one of %s, got %r",
                  "|".join(READ_PREFERENCES), value)
    return value


# -- cache keying -------------------------------------------------------------

def _key_part(x: Any) -> Any:
    from multiverso_tpu_torch.updaters import GetOption
    if x is None or isinstance(x, (int, float, str, bytes, bool)):
        return x
    if isinstance(x, np.ndarray):
        # exact bytes, not a hash: a digest collision would silently
        # serve the wrong rows. Hot-key id arrays are small.
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_key_part(e) for e in x)
    if isinstance(x, GetOption):
        # worker identity does not shape a plain Get's result; keying it
        # out lets one client's threads share entries
        return "GetOption"
    raise TypeError(f"uncacheable request part {type(x)!r}")


def cache_key(table_id: int, request: Any) -> Optional[Tuple]:
    """Hashable cache key for a Get request, or None when the request
    shape is not cacheable (unknown envelope types)."""
    try:
        return (int(table_id), _key_part(request))
    except TypeError:
        return None


def _result_nbytes(value: Any) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes) + 64
    if isinstance(value, (list, tuple)):
        return 64 + sum(_result_nbytes(v) for v in value)
    if isinstance(value, dict):
        return 64 + sum(_result_nbytes(v) for v in value.values())
    return 64


def _copy_result(value: Any) -> Any:
    """Defensive copy both ways (store and serve): cached arrays must not
    alias buffers the caller may mutate."""
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, tuple):
        return tuple(_copy_result(v) for v in value)
    if isinstance(value, list):
        return [_copy_result(v) for v in value]
    if isinstance(value, dict):
        return {k: _copy_result(v) for k, v in value.items()}
    return value


class _CacheEntry:
    __slots__ = ("value", "watermark", "stamp", "nbytes")

    def __init__(self, value: Any, watermark: int, stamp: float,
                 nbytes: int) -> None:
        self.value = value
        self.watermark = watermark
        self.stamp = stamp
        self.nbytes = nbytes


class ReadCache:
    """Bounded-staleness client read cache: LRU by (table, ids), byte-
    capped, lease + watermark invalidation (module docstring for the
    contract)."""

    def __init__(self, capacity_bytes: int,
                 lease_seconds: Optional[float] = None) -> None:
        self.capacity = int(capacity_bytes)
        self.lease = float(lease_seconds if lease_seconds is not None
                           else config.get_flag("read_lease_seconds"))
        self._lru: "OrderedDict[Tuple, _CacheEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # newest PRIMARY append watermark observed (any reply from the
        # primary carries it); the horizon entries age against
        self.horizon = -1

    # -- watermark horizon ---------------------------------------------------
    def observe_primary(self, watermark: int) -> None:
        """A reply from the PRIMARY advertised its append watermark. A
        REGRESSION means a different primary incarnation (failover /
        restart — sequences restart at 0): nothing cached is comparable,
        flush everything."""
        if watermark < 0:
            return
        with self._lock:
            if watermark < self.horizon:
                self._lru.clear()
                self._bytes = 0
                count("READ_CACHE_EPOCH_FLUSHES")
            self.horizon = watermark
        gauge_set("READ_CACHE_BYTES", self._bytes)

    def observe_replica(self, watermark: int) -> None:
        """A replica reply's replay watermark: a lower bound on the
        primary's append watermark — advance-only (a lagging replica must
        not look like a failover)."""
        if watermark < 0:
            return
        with self._lock:
            if watermark > self.horizon:
                self.horizon = watermark

    # -- lookup / store ------------------------------------------------------
    def lookup(self, key: Tuple, budget: int) -> Optional[Any]:
        now = time.monotonic()
        with self._lock:
            entry = self._lru.get(key)
            if entry is None:
                return None
            stale = (now - entry.stamp > self.lease
                     or (budget >= 0 and entry.watermark >= 0
                         and self.horizon >= 0
                         and self.horizon - entry.watermark > budget))
            if stale:
                del self._lru[key]
                self._bytes -= entry.nbytes
                return None
            self._lru.move_to_end(key)
            return _copy_result(entry.value)

    def store(self, key: Tuple, value: Any, watermark: int) -> None:
        nbytes = _result_nbytes(value)
        if nbytes > self.capacity:
            return  # a single whale must not evict the whole working set
        value = _copy_result(value)
        now = time.monotonic()
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._lru[key] = _CacheEntry(value, watermark, now, nbytes)
            self._bytes += nbytes
            while self._bytes > self.capacity and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= evicted.nbytes
        gauge_set("READ_CACHE_BYTES", self._bytes)

    def resize(self, capacity_bytes: int) -> None:
        """Live capacity change (flag watch seam): shrinking evicts the
        LRU tail immediately, growing just raises the bar."""
        with self._lock:
            self.capacity = int(capacity_bytes)
            while self._bytes > self.capacity and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= evicted.nbytes
        gauge_set("READ_CACHE_BYTES", self._bytes)

    def invalidate_table(self, table_id: int) -> None:
        """Write-through invalidation: this client wrote to the table, so
        its own cached reads of it are suspect (read-your-writes at cache
        granularity)."""
        with self._lock:
            doomed = [k for k in self._lru if k[0] == int(table_id)]
            for k in doomed:
                self._bytes -= self._lru.pop(k).nbytes
        gauge_set("READ_CACHE_BYTES", self._bytes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)


# -- replica reader -----------------------------------------------------------

class _Refused(RuntimeError):
    """The replica declined the read (stale / unsynced / lost primary) —
    a routing signal, never surfaced to the caller."""


class _PendingRead:
    __slots__ = ("cb", "t0")

    def __init__(self, cb: Callable, t0: float) -> None:
        self.cb = cb
        self.t0 = t0


class ReplicaReader:
    """One replica read connection: slot-free ``Request_Read`` frames
    correlated by msg_id. No worker slot, no lease, no retransmission —
    failures report to the router, which owns failover (next replica,
    then primary). Keeps a small latency ring for the hedged policy's
    p95-derived delay, and availability state (dead/stale backoff) for
    the router's round-robin."""

    DEAD_BACKOFF = 0.5    # redial a dead replica at most this often
    STALE_BACKOFF = 0.2   # skip a just-refused replica this long

    def __init__(self, endpoint: str) -> None:
        self.endpoint = endpoint
        self._net = None
        self._net_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: Dict[int, _PendingRead] = {}
        self.latencies: deque = deque(maxlen=128)
        self.dead_until = 0.0
        self.stale_until = 0.0
        self._compress = bool(config.get_flag("wire_compression"))
        # deadline budget stamped on each Request_Read (0 = none): a
        # replica drowning in reads drops the expired ones at drain
        # instead of serving answers nobody is waiting for
        self._deadline_budget = float(
            config.get_flag("request_deadline_seconds"))
        self._closed = False

    def available(self, now: float) -> bool:
        return not self._closed and now >= max(self.dead_until,
                                               self.stale_until)

    # -- lifecycle -----------------------------------------------------------
    def _ensure_net(self):
        with self._net_lock:
            if self._net is None:
                if self._closed:
                    raise OSError("reader closed")
                net = make_net()
                net.rank = -1
                net.connect([self.endpoint])
                self._net = net
                threading.Thread(target=self._pump, args=(net,),
                                 daemon=True,
                                 name="mv-replica-read-pump").start()
            return self._net

    def close(self) -> None:
        self._closed = True
        with self._net_lock:
            net, self._net = self._net, None
        if net is not None:
            net.finalize()
        self._fail_all(ConnectionError("reader closed"))

    # -- read path -----------------------------------------------------------
    def read_async(self, table_id: int, request: Any, budget: int,
                   cb: Callable, req_id: int = 0,
                   trace: bool = False, query: bool = False
                   ) -> Optional[int]:
        """Fire one read; ``cb(result, watermark, error)`` exactly once
        unless the token is cancelled first. Returns the cancellation
        token (msg_id), or None when the send itself failed (the reader
        marks itself dead; the router moves on). ``req_id``/``trace``
        thread the caller's span through the slot-free frame so the
        replica's hops land under the same trace id. ``query`` sends a
        ``Request_Query`` (top-k pushdown) instead — same slot-free
        frame shape, same admission, Reply_Query correlated identically."""
        msg_id = next_msg_id()
        with self._lock:
            self._pending[msg_id] = _PendingRead(cb, time.monotonic())
        msg = Message(src=-1, dst=0,
                      type=(MsgType.Request_Query if query
                            else MsgType.Request_Read),
                      table_id=table_id, msg_id=msg_id,
                      req_id=int(req_id), trace=bool(trace),
                      watermark=int(budget),
                      deadline=(time.monotonic() + self._deadline_budget
                                if self._deadline_budget > 0 else 0.0),
                      data=wire.encode(request, compress=self._compress))
        try:
            self._ensure_net().send(msg)
        except OSError:
            with self._lock:
                self._pending.pop(msg_id, None)
            self._mark_dead()
            return None
        return msg_id

    def cancel(self, token: int) -> None:
        """Loser-cancel: the late reply (if it ever lands) is dropped."""
        with self._lock:
            self._pending.pop(token, None)

    def _mark_dead(self) -> None:
        self.dead_until = time.monotonic() + self.DEAD_BACKOFF
        with self._net_lock:
            net, self._net = self._net, None
        if net is not None:
            net.finalize()

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for pend in pending:
            pend.cb(None, -1, exc)

    def _pump(self, net) -> None:
        while True:
            try:
                msg = net.recv()
            except ConnectionError:
                if net is self._net:
                    self._mark_dead()
                self._fail_all(ConnectionError(
                    f"replica {self.endpoint} connection lost"))
                return
            if msg is None:
                self._fail_all(ConnectionError("reader shut down"))
                return
            with self._lock:
                pend = self._pending.pop(msg.msg_id, None)
            if pend is None:
                continue  # cancelled (hedge loser) or unknown: drop
            latency = time.monotonic() - pend.t0
            self.latencies.append(latency)
            if msg.type in (MsgType.Reply_Read, MsgType.Reply_Query):
                try:
                    pend.cb(wire.decode(msg.data), int(msg.watermark), None)
                except Exception as exc:  # noqa: BLE001 — a decode bug must
                    # surface as a failed read, not kill the pump
                    pend.cb(None, -1, exc)
            elif msg.type == MsgType.Reply_Error:
                text = str(wire.decode(msg.data)) if msg.data else "error"
                if text.startswith("replica-refused"):
                    self.stale_until = (time.monotonic()
                                        + self.STALE_BACKOFF)
                    pend.cb(None, int(msg.watermark), _Refused(text))
                else:
                    pend.cb(None, -1, RuntimeError(text))
            else:
                pend.cb(None, -1,
                        RuntimeError(f"unexpected read reply {msg.type}"))


# -- scheduler (hedge timers + read deadlines) --------------------------------

class _Scheduler:
    """One timer thread per router: a heap of (when, fn) — hedge fires
    and per-attempt deadlines. Callbacks run on the timer thread and must
    be quick/non-blocking (they only flip attempt state and fire sends)."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-read-timers")
        self._thread.start()

    def at(self, when: float, fn: Callable) -> None:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (when, self._seq, fn))
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if self._heap:
                        self._cv.wait(max(0.0, self._heap[0][0]
                                          - time.monotonic()))
                    else:
                        self._cv.wait()
                if self._closed:
                    return
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 — timers must survive
                log.error("read scheduler callback failed: %r", exc)


# -- router -------------------------------------------------------------------

class ReadRouter:
    """Routes one client's Gets per the read preference: cache, then
    budget-admitted replicas (round-robin, hedged optionally), then the
    primary — transparently, so the caller's completion only ever fails
    if the PRIMARY path fails (the acceptance property of the
    replica-kill drill)."""

    def __init__(self, endpoints: List[str], preference: str,
                 primary_submit: Callable[[int, Any, Any], None],
                 budget: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 req_id_source: Optional[Callable[[], int]] = None,
                 watermark_confirm: Optional[Callable[[int], None]] = None,
                 retry_budget: Optional[object] = None,
                 primary_query_submit: Optional[
                     Callable[[int, Any, Any], None]] = None) -> None:
        self.preference = validate_read_preference(preference)
        # shared per-connection retry budget (fault/retry.py RetryBudget
        # or None): hedges are retries in the budget's ledger — a dry
        # bucket skips the hedge (the first fire still runs), so hedging
        # pressure decays with the success rate under overload
        self.retry_budget = retry_budget
        self.budget = int(budget if budget is not None
                          else config.get_flag("read_staleness_records"))
        self._primary_submit = primary_submit
        # queries fall back through their own primary leg (a direct
        # Request_Query, not a Get); None = queries are not routable
        # through this router and submit_query refuses loudly
        self._primary_query_submit = primary_query_submit
        # Tracing seams (both optional so bare routers stay valid): a
        # req_id source makes every routed Get a traced span; the
        # watermark-confirm callback fires after a REPLICA-served success
        # so the primary records a hop under the same span (the stitched
        # trace's third process) and re-advertises its append watermark.
        self._req_id_source = req_id_source
        self._watermark_confirm = watermark_confirm
        self._readers = [ReplicaReader(e) for e in endpoints]
        self._rr = 0
        self._rr_lock = threading.Lock()
        cap = int(cache_bytes if cache_bytes is not None
                  else config.get_flag("client_cache_bytes"))
        self.cache = ReadCache(cap) if cap > 0 else None
        self.timeout = float(config.get_flag("read_timeout_seconds"))
        # hedge delay pin: cached for the hot path but kept LIVE through
        # the config watch seam — a runtime set_flag("read_hedge_ms")
        # (operator or autotuner) takes effect on the next hedge instead
        # of being silently ignored until the router is rebuilt
        self._hedge_ms = float(config.get_flag("read_hedge_ms"))
        self._unsubscribe = [config.FLAGS.on_change(
            "read_hedge_ms", self._on_hedge_ms_change)]
        if cache_bytes is None:
            # the cache capacity is flag-derived too: grow/shrink/create
            # it live (an explicit constructor cap stays pinned)
            self._unsubscribe.append(config.FLAGS.on_change(
                "client_cache_bytes", self._on_cache_bytes_change))
        self._scheduler = _Scheduler()

    def _on_hedge_ms_change(self, _name: str, value) -> None:
        self._hedge_ms = float(value)

    def _on_cache_bytes_change(self, _name: str, value) -> None:
        cap = int(value)
        cache = self.cache
        if cap <= 0:
            self.cache = None
        elif cache is None:
            self.cache = ReadCache(cap)
        else:
            cache.resize(cap)

    def close(self) -> None:
        for unsub in getattr(self, "_unsubscribe", ()):
            unsub()
        self._unsubscribe = []
        self._scheduler.close()
        for reader in self._readers:
            reader.close()

    # -- policy helpers ------------------------------------------------------
    def active(self) -> bool:
        return self.preference != "primary" and bool(self._readers)

    def note_local_write(self, table_id: int) -> None:
        if self.cache is not None:
            self.cache.invalidate_table(table_id)

    def observe_primary_watermark(self, watermark: int) -> None:
        if self.cache is not None:
            self.cache.observe_primary(watermark)

    def next_reader(self, exclude: List[ReplicaReader]
                    ) -> Optional[ReplicaReader]:
        now = time.monotonic()
        with self._rr_lock:
            n = len(self._readers)
            for i in range(n):
                reader = self._readers[(self._rr + i) % n]
                if reader not in exclude and reader.available(now):
                    self._rr = (self._rr + i + 1) % n
                    return reader
        return None

    def hedge_delay(self) -> float:
        """p95 of recent replica read latencies (pooled), clamped to
        [1 ms, read_timeout]; the read_hedge_ms flag pins it. The
        derived value is exported as the READ_HEDGE_DELAY_SECONDS gauge
        — the effective hedging posture operators (and the autopilot's
        pressure sensors) read."""
        if self._hedge_ms > 0:
            delay = min(self._hedge_ms / 1000.0, self.timeout)
        else:
            samples: List[float] = []
            for reader in self._readers:
                samples.extend(reader.latencies)
            if not samples:
                delay = min(0.01, self.timeout)
            else:
                samples.sort()
                p95 = samples[min(len(samples) - 1,
                                  int(0.95 * len(samples)))]
                delay = max(0.001, min(p95, self.timeout))
        gauge_set("READ_HEDGE_DELAY_SECONDS", delay)
        return delay

    # -- entry point ---------------------------------------------------------
    def submit_get(self, table_id: int, request: Any, completion) -> int:
        """Serve one Get through the read tier. Settles ``completion``
        exactly once — from the cache, a replica, or the primary
        fallback. Returns the span's req_id (0 untraced) so callers a
        layer up — the shard router — can append their own hops."""
        req_id = self._req_id_source() if self._req_id_source else 0
        hop(req_id, "client_read_submit")
        tag_tenant(req_id, resolve_tenant(table_id))
        key = (cache_key(table_id, request)
               if self.cache is not None else None)
        if key is not None:
            hit = self.cache.lookup(key, self.budget)
            if hit is not None:
                count("READ_CACHE_HITS")
                hop(req_id, "client_read_cache_hit")
                completion.done(hit)
                return req_id
            count("READ_CACHE_MISSES")
        _ReadAttempt(self, table_id, request, key, completion,
                     req_id).start()
        return req_id

    def submit_query(self, table_id: int, request: Any, completion) -> int:
        """Serve one top-k query (``Request_Query``) through the same
        cache → replica → primary ladder as :meth:`submit_get`, counted
        under ``QUERY_*`` so retrieval traffic reads apart from training
        Gets on a dashboard. The cache key is namespaced under a
        ``"query"`` sentinel — (query bytes, k, metric) can never
        collide with a Get entry — and write-through invalidation,
        lease expiry and watermark aging apply unchanged."""
        if self._primary_query_submit is None:
            completion.fail(RuntimeError(
                "read tier has no primary query leg (router built "
                "without primary_query_submit)"))
            return 0
        req_id = self._req_id_source() if self._req_id_source else 0
        hop(req_id, "client_query_submit")
        tag_tenant(req_id, resolve_tenant(table_id))
        key = (cache_key(table_id, ("query", request))
               if self.cache is not None else None)
        if key is not None:
            hit = self.cache.lookup(key, self.budget)
            if hit is not None:
                count("QUERY_CACHE_HITS")
                hop(req_id, "client_query_cache_hit")
                completion.done(hit)
                return req_id
            count("QUERY_CACHE_MISSES")
        _ReadAttempt(self, table_id, request, key, completion,
                     req_id, query=True).start()
        return req_id


class _ReadAttempt:
    """One routed Get's life: replica attempts, the hedge, deadlines,
    and the primary fallback — settled exactly once."""

    __slots__ = ("_router", "_table_id", "_request", "_key", "_completion",
                 "_lock", "_settled", "_tried", "_inflight", "_hedged",
                 "_fell_back", "_req_id", "_query")

    def __init__(self, router: ReadRouter, table_id: int, request: Any,
                 key: Optional[Tuple], completion,
                 req_id: int = 0, query: bool = False) -> None:
        self._router = router
        self._table_id = table_id
        self._request = request
        self._key = key
        self._completion = completion
        self._req_id = int(req_id)
        self._query = bool(query)
        self._lock = threading.Lock()
        self._settled = False
        # queue depth of the read tier: attempts alive between submit
        # and settle. The exactly-once settle path is the exactly-once
        # decrement, so the gauge can never drift negative.
        gauge_add("READ_INFLIGHT", 1)
        self._tried: List[ReplicaReader] = []
        # live (reader, token) pairs — cancelled when someone wins
        self._inflight: List[Tuple[ReplicaReader, int]] = []
        self._hedged = False
        self._fell_back = False

    # -- firing --------------------------------------------------------------
    def start(self) -> None:
        if not self._fire_next():
            self._fallback()
            return
        if self._router.preference == "hedged":
            delay = self._router.hedge_delay()
            self._router._scheduler.at(time.monotonic() + delay,
                                       self._hedge_fire)

    def _fire_next(self) -> bool:
        """Fire the next untried, available replica; False when none."""
        reader = self._router.next_reader(self._tried)
        if reader is None:
            return False
        self._tried.append(reader)
        hop(self._req_id, "client_replica_send")
        token = reader.read_async(
            self._table_id, self._request, self._router.budget,
            lambda result, wm, err, reader=reader:
                self._on_reply(reader, result, wm, err),
            req_id=self._req_id, trace=bool(self._req_id),
            query=self._query)
        if token is None:
            return self._fire_next()  # send failed; try another
        with self._lock:
            if self._settled:
                reader.cancel(token)
                return True
            self._inflight.append((reader, token))
        self._router._scheduler.at(
            time.monotonic() + self._router.timeout,
            lambda reader=reader, token=token:
                self._on_deadline(reader, token))
        return True

    def _hedge_fire(self) -> None:
        with self._lock:
            if self._settled or self._hedged:
                return
            self._hedged = True
        budget = self._router.retry_budget
        if budget is not None and not budget.allow():
            return  # dry retry budget: the first fire keeps running,
            # only the speculative second copy is skipped (denial counted
            # by the budget)
        if self._query:
            count("QUERY_HEDGES")
        else:
            count("READ_HEDGES")
        if not self._fire_next():
            # no second replica available: hedge against the primary
            self._fallback(hedge=True)

    # -- settling ------------------------------------------------------------
    def _settle(self, result: Any = None,
                error: Optional[BaseException] = None,
                winner: Optional[Tuple[ReplicaReader, int]] = None) -> bool:
        with self._lock:
            if self._settled:
                return False
            self._settled = True
            losers = [p for p in self._inflight if p != winner]
            self._inflight.clear()
        gauge_add("READ_INFLIGHT", -1)
        for reader, token in losers:
            reader.cancel(token)
        if error is not None:
            self._completion.fail(error)
        else:
            self._completion.done(result)
        return True

    def _on_reply(self, reader: ReplicaReader, result: Any,
                  watermark: int, error: Optional[BaseException]) -> None:
        if error is None:
            router = self._router
            if router.cache is not None:
                router.cache.observe_replica(watermark)
                if self._key is not None:
                    router.cache.store(self._key, result, watermark)
            if self._settle(result=result,
                            winner=self._find_pair(reader)):
                if self._query:
                    count("QUERIES_VIA_REPLICA")
                else:
                    count("READS_VIA_REPLICA")
                hop(self._req_id, "client_read_reply")
                confirm = router._watermark_confirm
                if confirm is not None and self._req_id:
                    # replica-served span: ask the primary to stamp a
                    # watermark hop under the same req_id (the stitched
                    # trace's third process)
                    confirm(self._req_id)
                if self._hedged and len(self._tried) > 1 \
                        and reader is self._tried[-1]:
                    if self._query:
                        count("QUERY_HEDGE_WINS")
                    else:
                        count("READ_HEDGE_WINS")
            return
        if isinstance(error, _Refused):
            if self._query:
                count("QUERY_REPLICA_REFUSALS_SEEN")
            else:
                count("READ_REPLICA_REFUSALS_SEEN")
        with self._lock:
            if self._settled:
                return
            self._inflight = [p for p in self._inflight
                              if p[0] is not reader]
        if not self._fire_next():
            self._fallback()

    def _find_pair(self, reader: ReplicaReader
                   ) -> Optional[Tuple[ReplicaReader, int]]:
        with self._lock:
            for pair in self._inflight:
                if pair[0] is reader:
                    return pair
        return None

    def _on_deadline(self, reader: ReplicaReader, token: int) -> None:
        with self._lock:
            if self._settled or (reader, token) not in self._inflight:
                return
            self._inflight.remove((reader, token))
        reader.cancel(token)
        if self._query:
            count("QUERY_REPLICA_TIMEOUTS")
        else:
            count("READ_REPLICA_TIMEOUTS")
        if not self._fire_next():
            self._fallback()

    def _fallback(self, hedge: bool = False) -> None:
        """Route through the primary's normal Get path (its retry/
        reconnect machinery included) — the caller's completion fails
        only if THIS fails."""
        with self._lock:
            if self._settled or self._fell_back:
                return
            self._fell_back = True
        if self._query:
            count("QUERY_PRIMARY_FALLBACKS")
        else:
            count("READ_PRIMARY_FALLBACKS")
        # The primary path mints its own req_id (primary_submit's 3-arg
        # contract predates tracing); this hop marks the span break so a
        # collector knows the read continued under a fresh id.
        hop(self._req_id, "client_read_fallback")

        class _Settle:
            __slots__ = ("_attempt",)

            def __init__(self, attempt: "_ReadAttempt") -> None:
                self._attempt = attempt

            def done(self, result: Any) -> None:
                self._attempt._settle(result=result)

            def fail(self, error: BaseException) -> None:
                self._attempt._settle(error=error)

        submit = (self._router._primary_query_submit if self._query
                  else self._router._primary_submit)
        try:
            submit(self._table_id, self._request, _Settle(self))
        except Exception as exc:  # noqa: BLE001 — the submit itself died
            self._settle(error=exc)
