"""Per-request tracing + the flight recorder.

The wire ``req_id`` (fault/retry.py's idempotency key) doubles as a span
id: every hop a correlated request takes — client send, frame decode,
server receive, dispatcher enqueue, WAL append, sync-gate defer/release,
apply, reply — appends ``(stage, t_ns)`` to a bounded in-memory trace.
In-process messages carry ``req_id == 0`` and are never traced, so the
hot local path pays nothing but a predicate.

The :class:`FlightRecorder` is the post-mortem half: on an anomalous
event (worker eviction, standby failover, frame CRC reject, a client
failing all pending requests) it appends the last N traces plus a full
dashboard snapshot to a JSONL file (the ``flight_recorder_path`` flag),
so the operator sees exactly which requests were in flight, hop by hop,
when the system misbehaved — without having had tracing "turned on" in
advance. Telemetry must never take down the data path: every dump is
fully guarded.

Stage names are catalogued in ``docs/observability.md``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

MAX_HOPS_PER_TRACE = 64

# The tenant every untagged span (and unclaimed table) folds into — the
# chargeback plane's catch-all bucket. Defined here (the lowest layer
# that stores tags) so admission, collector and chargeback all share one
# constant without import cycles.
DEFAULT_TENANT = "_default"

# Loss counters at the store's bounds, cached Counter objects so the hot
# path stays one dict hit (Dashboard import is deferred: dashboard.py
# imports config which must not cycle back through obs at import time).
_loss_counters: List[Any] = []


def _bound_counters():
    if not _loss_counters:
        from multiverso_tpu_torch.dashboard import Dashboard
        _loss_counters.append(Dashboard.counter("TRACE_EVICTED"))
        _loss_counters.append(Dashboard.counter("TRACE_DROPPED_HOPS"))
    return _loss_counters


class TraceStore:
    """Bounded req_id -> [(stage, t_ns), ...] map. Oldest-trace eviction
    keeps memory constant under sustained traffic; a trace that outgrows
    ``MAX_HOPS_PER_TRACE`` (a retransmit storm) stops growing rather than
    leaking. Both losses are counted (``TRACE_EVICTED`` /
    ``TRACE_DROPPED_HOPS``) so a collector knows its view is partial."""

    def __init__(self, max_traces: int = 512) -> None:
        self.max_traces = int(max_traces)
        self._traces: "OrderedDict[int, List[Tuple[str, int]]]" = \
            OrderedDict()
        # req_id -> tenant tag (only NON-default tags are stored; the
        # map is keyed on live traces, so trace eviction bounds it too)
        self._tenants: Dict[int, str] = {}
        self._lock = threading.Lock()

    def hop(self, req_id: int, stage: str,
            t_ns: Optional[int] = None) -> None:
        if not req_id:
            return
        if t_ns is None:
            t_ns = time.time_ns()
        evicted = dropped = 0
        with self._lock:
            hops = self._traces.get(req_id)
            if hops is None:
                hops = self._traces[req_id] = []
                while len(self._traces) > self.max_traces:
                    old_rid, _ = self._traces.popitem(last=False)
                    self._tenants.pop(old_rid, None)
                    evicted += 1
            if len(hops) < MAX_HOPS_PER_TRACE:
                hops.append((stage, t_ns))
            else:
                dropped = 1
        if evicted or dropped:
            ctr_evicted, ctr_dropped = _bound_counters()
            if evicted:
                ctr_evicted.add(evicted)
            if dropped:
                ctr_dropped.add(dropped)

    def get(self, req_id: int) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._traces.get(req_id, ()))

    def recent(self, n: int) -> List[Tuple[int, List[Tuple[str, int]]]]:
        """The last ``n`` traces in insertion order (oldest first)."""
        with self._lock:
            items = list(self._traces.items())
        return [(rid, list(hops)) for rid, hops in items[-n:]]

    def export(self, n: int) -> Dict[int, List[List[Any]]]:
        """The last ``n`` traces as a JSON/wire-safe dict — the
        ``Control_Traces`` reply payload a TraceCollector stitches."""
        return {rid: [[stage, t_ns] for stage, t_ns in hops]
                for rid, hops in self.recent(n)}

    def tag_tenant(self, req_id: int, tenant: str) -> None:
        """Stamp ``req_id``'s span with its tenant (the submit sites
        call this right after the first hop). Default-tenant tags are
        not stored — absence IS the default — and tags for unknown
        req_ids are dropped, which bounds the map by the trace bound."""
        if not req_id or not tenant or tenant == DEFAULT_TENANT:
            return
        with self._lock:
            if req_id in self._traces:
                self._tenants[req_id] = tenant

    def tenant_of(self, req_id: int) -> str:
        with self._lock:
            return self._tenants.get(req_id, DEFAULT_TENANT)

    def export_tenants(self, n: int) -> Dict[int, str]:
        """Tenant tags for the last ``n`` traces — rides next to
        ``export`` in the ``Control_Traces`` reply (legacy decoders
        ignore the extra key; legacy senders simply omit it)."""
        with self._lock:
            rids = list(self._traces)[-n:]
            return {rid: self._tenants[rid] for rid in rids
                    if rid in self._tenants}

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._tenants.clear()


# Process-global trace store — client and server hops of an in-process
# round trip land in the SAME store (one process), while cross-process
# deployments each record their own half.
TRACES = TraceStore()


def hop(req_id: int, stage: str) -> None:
    """Append one hop to ``req_id``'s trace (no-op for req_id 0)."""
    TRACES.hop(req_id, stage)


def tag_tenant(req_id: int, tenant: str) -> None:
    """Stamp ``req_id``'s span with its resolved tenant (no-op for
    req_id 0 / the default tenant)."""
    TRACES.tag_tenant(req_id, tenant)


class FlightRecorder:
    """Dump-on-anomaly ring: appends an event line, a dashboard snapshot
    line, and the last N trace lines to the ``flight_recorder_path`` JSONL
    file. Configuration is read at dump time (flags may be set after
    import); a missing/empty path disables dumping entirely."""

    def __init__(self, store: TraceStore = TRACES) -> None:
        self.store = store
        self._lock = threading.Lock()
        # reason -> monotonic time of its last written dump (rate limit)
        self._last: Dict[str, float] = {}

    def _suppressed(self, reason: str, path: str) -> Optional[str]:
        """Why this dump must NOT be written (None = write it): the
        per-reason rate limit or the output-file size cap — a flapping
        alert must not fill the disk with identical dumps."""
        from multiverso_tpu_torch import config
        min_interval = float(
            config.get_flag("flight_recorder_min_interval_seconds"))
        if min_interval > 0:
            last = self._last.get(reason)
            now = time.monotonic()
            if last is not None and now - last < min_interval:
                return (f"reason {reason!r} fired {now - last:.2f}s ago "
                        f"(< {min_interval:.2f}s min interval)")
        max_bytes = int(config.get_flag("flight_recorder_max_bytes"))
        if max_bytes > 0:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size >= max_bytes:
                return (f"{path} is {size} bytes "
                        f"(>= flight_recorder_max_bytes={max_bytes})")
        return None

    def dump(self, reason: str, **details: Any) -> Optional[str]:
        """Write one dump; returns the path written, or None when the
        recorder is disabled or the dump is suppressed (size cap /
        per-reason rate limit — counted in FLIGHT_DUMPS_SUPPRESSED).
        Never raises — a failing dump is logged and swallowed (telemetry
        must not take down the data path)."""
        from multiverso_tpu_torch import config, log
        try:
            path = str(config.get_flag("flight_recorder_path"))
            if not path:
                return None
            with self._lock:
                why = self._suppressed(reason, path)
                if why is None:
                    self._last[reason] = time.monotonic()
            if why is not None:
                from multiverso_tpu_torch.dashboard import count
                count("FLIGHT_DUMPS_SUPPRESSED")
                log.info("flight recorder: suppressed %r dump: %s",
                         reason, why)
                return None
            n = max(1, int(config.get_flag("flight_recorder_traces")))
            lines = self._render(reason, n, details)
            with self._lock:
                with open(path, "a", encoding="utf-8") as fp:
                    fp.write(lines)
        except Exception as exc:  # noqa: BLE001 — never propagate
            try:
                log.error("flight recorder: dump for %r failed: %r",
                          reason, exc)
            except Exception:  # noqa: BLE001
                pass
            return None
        from multiverso_tpu_torch.dashboard import count
        count("FLIGHT_DUMPS")
        log.info("flight recorder: dumped %r (+%d trace(s)) -> %s",
                 reason, min(n, len(self.store)), path)
        return path

    def _render(self, reason: str, n: int, details: Dict[str, Any]) -> str:
        from multiverso_tpu_torch.dashboard import Dashboard
        # details go first so a colliding key (e.g. kind=) can never
        # clobber the line-shape discriminator fields
        out = [json.dumps({**{k: _jsonable(v) for k, v in details.items()},
                           "kind": "event", "reason": reason,
                           "t_ns": time.time_ns()})]
        out.append(json.dumps({"kind": "snapshot",
                               **Dashboard.snapshot()}))
        for req_id, hops in self.store.recent(n):
            out.append(json.dumps({
                "kind": "trace", "req_id": req_id,
                "hops": [[stage, t_ns] for stage, t_ns in hops]}))
        return "\n".join(out) + "\n"


def _jsonable(value: Any) -> Any:
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


RECORDER = FlightRecorder()


def flight_dump(reason: str, **details: Any) -> Optional[str]:
    """Trigger a flight-recorder dump (module-level seam the runtime
    calls on eviction / failover / CRC reject / unclean shutdown)."""
    return RECORDER.dump(reason, **details)
