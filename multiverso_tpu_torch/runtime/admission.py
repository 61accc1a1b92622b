"""Priority lanes + admission control for the dispatcher drain.

The overload story before this module: every request that reached a
server's queue was applied, in arrival order, no matter how late. Under a
training write storm that is the worst possible policy — serving reads
queue behind bulk Adds until their callers have given up, then the
dispatcher burns applies on answers nobody is waiting for, which keeps
the queue deep, which expires more work. Load amplifies load.

Three mechanisms, all drain-time (they sit between ``pop_all()`` and
dispatch, on the dispatcher thread — no new locks on the apply path):

* **Lanes** (:func:`lane_of`): one drained batch is stably sorted
  serving reads > control > training writes. Serving reads are the
  admin/slot-free Gets the read tier forwards (``src < 0``); a WORKER's
  own Gets stay in the training lane so the per-worker FIFO invariant
  ("a worker's earlier Adds are visible to its own Get") survives — the
  sort is stable and never reorders two messages in the same lane.
  Control is an ALLOWLIST of order-insensitive probes (heartbeats,
  stats/layout/watermark reads): barrier-semantics messages such as
  ``Server_Execute`` ride the training lane so they still observe every
  write queued ahead of them. Fused-apply grouping runs on the sorted
  batch, so Add groups respect lane order for free.

* **Admission gate** (:class:`AdmissionGate`): the same shape as the
  replica read gate (``ReplicaReadServer._refusal`` in durable/standby.py)
  — a method that returns ``None`` (admitted) or a truthful refusal
  string, here prefixed ``"shed: "``. Sheds lowest-lane work first:
  training Adds refuse when the backlog passes ``admission_queue_limit``;
  serving Gets refuse only past
  ``_GET_SHED_FACTOR`` x that limit (brownout before blackout). Only
  WIRE requests (``req_id != 0``) are ever shed — in-process workers
  share a fate with their server and have no retry/degrade path.

* **Tenant quotas** (:class:`TenantQuotas`): per-tenant token buckets
  keyed by table namespace (the ``tenant_quota_spec`` flag maps table
  ids to named tenants with a write qps + burst). A tenant that exhausts
  its bucket has ITS Adds shed (``TENANT_<name>_SHED``) while other
  tenants' traffic — and the serving lane — are untouched: quota
  refusal happens before, and independent of, the global backlog checks.

A shed is not an error: the client maps the ``"shed: "`` reply onto a
dropped-update completion (counted, not raised) — the Downpour-style
degradation where a lost async gradient costs convergence time, not
correctness. An acked Add is NEVER shed: the gate runs before apply/ACK.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count
from multiverso_tpu_torch.obs.trace import DEFAULT_TENANT
from multiverso_tpu_torch.runtime.message import Message, MsgType

# lane ranks: lower drains first
LANE_SERVING, LANE_CONTROL, LANE_TRAINING = 0, 1, 2

# serving Gets shed only when the backlog is this multiple of the
# training-lane limit — the last lane to brown out
_GET_SHED_FACTOR = 4


class ShedError(RuntimeError):
    """An admission refusal. ``wire_text`` is the exact truthful string
    shipped in the Reply_Error payload (``"shed: ..."``) — clients key
    their graceful-degradation path on the prefix, so the payload must be
    the refusal itself, not an exception repr."""

    def __init__(self, text: str) -> None:
        super().__init__(text)
        self.wire_text = text


class DeadlineExceeded(RuntimeError):
    """Dropped at drain time because the caller's deadline already
    passed. Same wire_text contract as :class:`ShedError`."""

    def __init__(self, text: str) -> None:
        super().__init__(text)
        self.wire_text = text


# The ONLY types the control lane may lift over queued training writes:
# read-only probes and liveness signals whose answer is a point-in-stream
# snapshot (a watermark read at an earlier point is merely conservative).
# Everything else — Server_Execute (an explicit full barrier: checkpoint
# and multihost quiesce ride it), Finish_Train, cuts, digests, migration,
# WAL/replication records, deregistration — is state-coupled: its meaning
# depends on which earlier writes have applied, so it keeps its FIFO
# position in the training lane. Allowlist, not blocklist: a future
# message type defaults to NOT being reordered.
_CONTROL_LANE_TYPES = frozenset((
    MsgType.Control_Heartbeat,
    MsgType.Control_Stats,
    MsgType.Control_Layout,
    MsgType.Control_Shm,
    MsgType.Control_Watermark,
    MsgType.Control_Traces,
    MsgType.Control_Profile,
))


def lane_of(msg: Message) -> int:
    """Lane rank for one dispatcher-bound message. Admin/slot-free Gets
    (``src < 0`` — the read tier's forwards, stats-style probes riding
    the Get path) are the serving lane; worker Gets share the TRAINING
    lane with Adds so stable sorting preserves each worker's FIFO; only
    the ``_CONTROL_LANE_TYPES`` allowlist of order-insensitive probes
    takes the control lane — barrier-semantics messages (Server_Execute
    et al.) stay in arrival order relative to the writes they fence."""
    if msg.type == MsgType.Request_Get and msg.src < 0:
        return LANE_SERVING
    if msg.type == MsgType.Request_Query:
        # retrieval queries are slot-free serving traffic whoever sent
        # them (never clocked, never WAL'd) — they jump the training
        # backlog exactly like read-tier forwards
        return LANE_SERVING
    if msg.type in _CONTROL_LANE_TYPES:
        return LANE_CONTROL
    return LANE_TRAINING


def lane_order(msgs: List[Message]) -> List[Message]:
    """Stably sort one drained batch into lane order (serving > control >
    training). Stable: intra-lane arrival order — and with it the
    per-worker FIFO and the WAL-order-equals-apply-order property inside
    the training lane — is untouched."""
    return sorted(msgs, key=lane_of)


class TokenBucket:
    """Monotonic-clock token bucket: ``rate`` tokens/second, ``burst``
    cap. Thread-safe (the gate runs on the dispatcher thread today, but
    the bucket makes no such assumption)."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class TenantQuotas:
    """Per-tenant write-admission buckets keyed by table namespace.

    Spec DSL (the ``tenant_quota_spec`` flag): ``;``-separated entries of
    ``name:tables=<id>|<id>|...,qps=<rate>[,burst=<cap>]`` — e.g.
    ``ctr:tables=0|1,qps=500;ranker:tables=2,qps=100,burst=200``.
    Tables not claimed by any tenant belong to no bucket and are never
    quota-shed (quotas are opt-in per namespace, matching the flag's
    empty default). Malformed specs are config errors -> ``log.fatal``,
    mirroring ``parse_fault_spec``.
    """

    def __init__(self, buckets: Dict[int, Tuple[str, TokenBucket]]) -> None:
        self._buckets = buckets

    @classmethod
    def parse(cls, spec: str) -> "TenantQuotas":
        buckets: Dict[int, Tuple[str, TokenBucket]] = {}
        for entry in filter(None, (p.strip() for p in spec.split(";"))):
            name, _, body = entry.partition(":")
            name = name.strip()
            if not name or not body:
                log.fatal("tenant_quota_spec: entry %r is not "
                          "name:tables=...,qps=...", entry)
            tables: List[int] = []
            qps = 0.0
            burst = 0.0
            for kv in filter(None, (p.strip() for p in body.split(","))):
                key, _, val = kv.partition("=")
                key = key.strip()
                if key == "tables":
                    tables = [int(t) for t in val.split("|") if t.strip()]
                elif key == "qps":
                    qps = float(val)
                elif key == "burst":
                    burst = float(val)
                else:
                    log.fatal("tenant_quota_spec: unknown key %r in %r",
                              key, entry)
            if not tables or qps <= 0:
                log.fatal("tenant_quota_spec: entry %r needs tables=... "
                          "and qps>0", entry)
            bucket = TokenBucket(qps, burst if burst > 0 else qps)
            for tid in tables:
                if tid in buckets:
                    log.fatal("tenant_quota_spec: table %d claimed twice",
                              tid)
                buckets[tid] = (name, bucket)
        return cls(buckets)

    def refusal(self, table_id: int) -> Optional[str]:
        """Spend one write token for ``table_id``'s tenant. None =
        admitted (or unmetered table)."""
        entry = self._buckets.get(table_id)
        if entry is None:
            return None
        name, bucket = entry
        if bucket.allow():
            count(f"TENANT_{name}_ADMITTED")
            return None
        count(f"TENANT_{name}_SHED")
        return (f"shed: tenant '{name}' write quota exhausted "
                f"(table {table_id})")

    def tenant_of(self, table_id: int) -> str:
        """The tenant name claiming ``table_id``; unclaimed tables fold
        into ``DEFAULT_TENANT``."""
        entry = self._buckets.get(table_id)
        return entry[0] if entry is not None else DEFAULT_TENANT

    def metered(self, table_id: int) -> bool:
        return table_id in self._buckets

    def names(self) -> Dict[int, str]:
        """``{table_id: tenant name}`` for every claimed table — the
        resolution map :func:`resolve_tenant` caches."""
        return {tid: name for tid, (name, _) in self._buckets.items()}


# resolve_tenant's parse cache: {table_id: tenant}, or None when the
# spec flag changed since the last parse. Invalidation rides the config
# watch seam (no per-call flag read / spec compare — the per-request
# client path pays two dict hits).
_resolve_cache: Optional[Dict[int, str]] = None
_resolve_lock = threading.Lock()


def _invalidate_resolve(_name: str, _value) -> None:
    global _resolve_cache
    _resolve_cache = None


config.FLAGS.on_change("tenant_quota_spec", _invalidate_resolve)


def resolve_tenant(table_id: int) -> str:
    """Tenant name owning ``table_id`` under the CURRENT
    ``tenant_quota_spec`` flag — the shared client-side resolution the
    trace plane stamps onto spans (``obs/trace.tag_tenant``) at every
    submit site. Tables no tenant claims — and all traffic when the
    flag is empty — fold into ``DEFAULT_TENANT``. Purely a labeling
    read: no token is spent, and a spec that fails to parse resolves
    everything to the default tenant instead of raising on the request
    path (the serving gate's ``from_flags`` owns the loud failure)."""
    global _resolve_cache
    names = _resolve_cache
    if names is None:
        with _resolve_lock:
            names = _resolve_cache
            if names is None:
                try:
                    names = TenantQuotas.parse(
                        str(config.get_flag("tenant_quota_spec"))).names()
                except Exception:  # noqa: BLE001 — labeling must not raise
                    names = {}
                _resolve_cache = names
    return names.get(int(table_id), DEFAULT_TENANT)


class AdmissionGate:
    """Drain-time admission decision, shaped like the replica read gate:
    ``refusal(msg, depth) -> Optional[str]`` where a string is the
    truthful ``"shed: ..."`` reason shipped to the caller.

    ``queue_limit <= 0`` disables backlog shedding; an empty tenant spec
    disables quotas — the default gate built from default flags admits
    everything, bit-for-bit the pre-gate behavior. (The JAX gate's SLO
    burn signal waits for ``obs/slo.py``.)
    """

    def __init__(self, queue_limit: int = 0,
                 tenants: Optional[TenantQuotas] = None) -> None:
        self.queue_limit = int(queue_limit)
        self.tenants = tenants if tenants is not None else TenantQuotas({})

    @classmethod
    def from_flags(cls) -> "AdmissionGate":
        return cls(
            queue_limit=int(config.get_flag("admission_queue_limit")),
            tenants=TenantQuotas.parse(
                str(config.get_flag("tenant_quota_spec"))))

    def refusal(self, msg: Message, depth: int) -> Optional[str]:
        """None = admitted. Only wire requests (req_id != 0) are ever
        refused; lanes shed lowest-first (training Adds at the limit,
        serving Gets only at ``_GET_SHED_FACTOR`` x the limit)."""
        if msg.req_id == 0:
            return None
        if msg.type == MsgType.Request_Add:
            tenant = self.tenants.tenant_of(msg.table_id)
            text = self.tenants.refusal(msg.table_id)
            if text is not None:
                count("SHED_ADDS")
                return text
            if 0 < self.queue_limit < depth:
                count("SHED_ADDS")
                count(f"TENANT_{tenant}_SHED")
                return (f"shed: dispatcher backlog {depth} over "
                        f"admission_queue_limit {self.queue_limit} — "
                        "training writes shed first")
            if not self.tenants.metered(msg.table_id):
                # metered tables were counted inside TenantQuotas.refusal;
                # unmetered wire Adds fold into the default tenant so
                # every admitted write carries exactly one tenant verdict
                # (the chargeback plane's "Adds admitted" column)
                count(f"TENANT_{tenant}_ADMITTED")
        elif msg.type == MsgType.Request_Get:
            limit = self.queue_limit * _GET_SHED_FACTOR
            if 0 < limit < depth:
                count("SHED_GETS")
                count(f"TENANT_{self.tenants.tenant_of(msg.table_id)}"
                      "_SHED")
                return (f"shed: dispatcher backlog {depth} over "
                        f"{_GET_SHED_FACTOR}x admission_queue_limit — "
                        "shedding reads to stay live")
        return None
