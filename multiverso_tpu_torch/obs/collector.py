"""Cross-process trace stitching (the observability plane's spine; port
of ``multiverso_tpu/obs/collector.py``).

Each process in a fleet — client, shard primaries, read replicas,
standbys, multihost leader — records its half of every traced request in
its own process-global :data:`~multiverso_tpu_torch.obs.trace.TRACES` store,
under the request's wire ``req_id``. The :class:`TraceCollector` pulls
those stores over the slot-free ``Control_Traces`` RPC, estimates each
remote process's clock offset, and merges the per-process hop lists into
end-to-end :class:`StitchedTrace` spans with causally-ordered corrected
timestamps.

Clock correction, spelled out: process wall clocks disagree (NTP skew,
VM drift), so raw ``time_ns`` hops from two processes do not order. For
every req_id recorded by BOTH the local store and a remote store, the
local first hop ``t_l0`` happened before the remote first hop ``t_r0``
(the request had to cross the wire to be recorded there) and the local
last hop ``t_l1`` happened after the remote last hop ``t_r1`` (the reply
had to cross back). The NTP-style estimate

    offset ~ ((t_r0 - t_l0) + (t_r1 - t_l1)) / 2

cancels the transit time to first order when the two legs are
symmetric; the per-process offset is the MEDIAN over all shared req_ids
(robust to the odd retransmitted outlier). Corrected remote timestamps
are ``t_ns - offset``, i.e. everything is expressed on the LOCAL clock.

The collector is a diagnostic reader: it never blocks the data path and
an unreachable endpoint degrades the view (recorded in
:attr:`TraceCollector.unreachable`) rather than failing the collect.
"""

from __future__ import annotations

import statistics
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch import config
from multiverso_tpu_torch.obs.trace import DEFAULT_TENANT

LOCAL_PROCESS = "local"


@dataclass
class StitchedTrace:
    """One request's end-to-end span, merged across processes.

    ``hops`` is the causally-ordered list of ``(process, stage,
    t_corrected_ns)`` — corrected onto the collector's local clock.
    ``processes`` is the distinct set of processes the span crossed.
    ``tenant`` is the chargeback label the submit site stamped on the
    span (``_default`` when no store tagged it).
    """

    req_id: int
    hops: List[Tuple[str, str, int]] = field(default_factory=list)
    tenant: str = DEFAULT_TENANT

    @property
    def processes(self) -> List[str]:
        seen: List[str] = []
        for proc, _, _ in self.hops:
            if proc not in seen:
                seen.append(proc)
        return seen

    @property
    def start_ns(self) -> int:
        return self.hops[0][2] if self.hops else 0

    @property
    def duration_ns(self) -> int:
        if len(self.hops) < 2:
            return 0
        return self.hops[-1][2] - self.hops[0][2]

    def stages(self) -> List[str]:
        return [stage for _, stage, _ in self.hops]

    def monotonic(self) -> bool:
        """Corrected timestamps never step backwards (the acceptance
        property of a correctly-stitched span)."""
        times = [t for _, _, t in self.hops]
        return all(a <= b for a, b in zip(times, times[1:]))

    def render(self) -> str:
        """One span, one line per hop, durations relative to the first."""
        if not self.hops:
            return f"trace {self.req_id}: <empty>"
        t0 = self.hops[0][2]
        lines = [f"trace {self.req_id}: {len(self.hops)} hop(s), "
                 f"{self.duration_ns / 1e6:.3f} ms, "
                 f"processes={','.join(self.processes)}"]
        for proc, stage, t in self.hops:
            lines.append(f"  +{(t - t0) / 1e6:9.3f} ms  "
                         f"{proc:<24s} {stage}")
        return "\n".join(lines)


def _normalize(traces: Any) -> Dict[int, List[Tuple[str, int]]]:
    """Wire payloads arrive with STRING req_id keys (the JSON-tree codec
    stringifies int dict keys) and list-shaped hops — normalize both."""
    out: Dict[int, List[Tuple[str, int]]] = {}
    if not isinstance(traces, dict):
        return out
    for key, hops in traces.items():
        try:
            rid = int(key)
        except (TypeError, ValueError):
            continue
        out[rid] = [(str(stage), int(t_ns)) for stage, t_ns in hops]
    return out


def _normalize_tenants(tags: Any) -> Dict[int, str]:
    """The optional ``tenants`` sibling key of a ``Control_Traces``
    payload (same stringified-int-key caveat as the traces dict); legacy
    senders omit it entirely — an absent/misshapen value is just {}."""
    out: Dict[int, str] = {}
    if not isinstance(tags, dict):
        return out
    for key, tenant in tags.items():
        try:
            out[int(key)] = str(tenant)
        except (TypeError, ValueError):
            continue
    return out


def estimate_offset(local: Dict[int, List[Tuple[str, int]]],
                    remote: Dict[int, List[Tuple[str, int]]]
                    ) -> Optional[int]:
    """Median NTP-style clock offset (remote minus local clock, ns) over
    req_ids both stores recorded; None when they share none."""
    samples: List[float] = []
    for rid, r_hops in remote.items():
        l_hops = local.get(rid)
        if not l_hops or not r_hops:
            continue
        t_l0, t_l1 = l_hops[0][1], l_hops[-1][1]
        t_r0, t_r1 = r_hops[0][1], r_hops[-1][1]
        samples.append(((t_r0 - t_l0) + (t_r1 - t_l1)) / 2.0)
    if not samples:
        return None
    return int(statistics.median(samples))


class TraceCollector:
    """Pulls per-process trace stores and stitches cross-process spans.

    ``endpoints`` may be given directly, or discovered from a shard
    layout manifest via :meth:`from_layout` (primaries + replicas +
    the manifest's own endpoint list). ``collect()`` fans requests out
    concurrently (one thread per endpoint, bounded by the per-endpoint
    timeout) and refreshes :attr:`offsets` / :attr:`unreachable`;
    :meth:`stitch` merges the collected stores into
    :class:`StitchedTrace` spans.
    """

    def __init__(self, endpoints: Sequence[str],
                 timeout: Optional[float] = None,
                 include_local: bool = True) -> None:
        # dedupe, keep order: layouts repeat endpoints across roles
        seen: Dict[str, None] = {}
        for ep in endpoints:
            if ep:
                seen.setdefault(str(ep))
        self.endpoints: List[str] = list(seen)
        self.timeout = float(timeout if timeout is not None
                             else config.get_flag("stats_timeout_seconds"))
        self.include_local = bool(include_local)
        # process name -> {req_id: [(stage, t_ns), ...]}
        self.stores: Dict[str, Dict[int, List[Tuple[str, int]]]] = {}
        # process name -> {req_id: tenant} (sparse: default omitted)
        self.tenant_tags: Dict[str, Dict[int, str]] = {}
        # process name -> role string advertised in the reply
        self.roles: Dict[str, str] = {}
        # process name -> estimated clock offset (ns, remote - local)
        self.offsets: Dict[str, int] = {}
        self.unreachable: List[str] = []

    @classmethod
    def from_layout(cls, layout: Dict[str, Any],
                    timeout: Optional[float] = None) -> "TraceCollector":
        """All trace-serving endpoints of a shard-group manifest: every
        shard primary plus every per-shard read replica."""
        eps: List[str] = [str(e) for e in layout.get("endpoints", ())]
        replicas = layout.get("replicas") or {}
        if isinstance(replicas, dict):
            for shard_eps in replicas.values():
                eps.extend(str(e) for e in (shard_eps or ()))
        else:
            for shard_eps in replicas:
                eps.extend(str(e) for e in (shard_eps or ()))
        return cls(eps, timeout=timeout)

    # -- gathering -----------------------------------------------------------
    def collect(self) -> "TraceCollector":
        """Fan one ``Control_Traces`` pull over every endpoint (plus the
        local store), then re-estimate clock offsets. Unreachable
        endpoints land in :attr:`unreachable`, never raise."""
        from multiverso_tpu_torch.runtime.remote import fetch_traces

        results: Dict[str, Optional[Dict[str, Any]]] = {}
        lock = threading.Lock()

        def pull(ep: str) -> None:
            try:
                payload = fetch_traces(ep, timeout=self.timeout)
            except (OSError, RuntimeError) as exc:
                payload = None
                from multiverso_tpu_torch import log
                log.info("trace collector: %s unreachable: %r", ep, exc)
            with lock:
                results[ep] = payload

        threads = [threading.Thread(target=pull, args=(ep,), daemon=True,
                                    name="mv-trace-pull")
                   for ep in self.endpoints]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout + 1.0)

        self.stores.clear()
        self.tenant_tags.clear()
        self.roles.clear()
        self.unreachable = []
        if self.include_local:
            from multiverso_tpu_torch.obs.trace import TRACES
            n = max(1, int(config.get_flag("trace_export_max")))
            self.stores[LOCAL_PROCESS] = _normalize(TRACES.export(n))
            self.tenant_tags[LOCAL_PROCESS] = dict(TRACES.export_tenants(n))
            self.roles[LOCAL_PROCESS] = "client"
        for ep in self.endpoints:
            payload = results.get(ep)
            if payload is None:
                self.unreachable.append(ep)
                continue
            role = str(payload.get("role", "unknown"))
            name = f"{role}@{ep}"
            self.stores[name] = _normalize(payload.get("traces"))
            self.tenant_tags[name] = _normalize_tenants(
                payload.get("tenants"))
            self.roles[name] = role
        self._estimate_offsets()
        return self

    def _estimate_offsets(self) -> None:
        self.offsets = {LOCAL_PROCESS: 0}
        local = self.stores.get(LOCAL_PROCESS, {})
        for name, store in self.stores.items():
            if name == LOCAL_PROCESS:
                continue
            offset = estimate_offset(local, store) if local else None
            # no shared span to estimate from: trust the remote clock
            # (same-host test fleets share one clock anyway)
            self.offsets[name] = 0 if offset is None else offset

    # -- stitching -----------------------------------------------------------
    def stitch(self, req_id: Optional[int] = None) -> List[StitchedTrace]:
        """Merge the collected stores into corrected, causally-ordered
        spans — all of them, or just ``req_id``'s. Sorted by start
        time."""
        rids: Dict[int, None] = {}
        for store in self.stores.values():
            for rid in store:
                if req_id is None or rid == req_id:
                    rids.setdefault(rid)
        spans: List[StitchedTrace] = []
        for rid in rids:
            hops: List[Tuple[str, str, int]] = []
            for name, store in self.stores.items():
                offset = self.offsets.get(name, 0)
                for stage, t_ns in store.get(rid, ()):
                    hops.append((name, stage, int(t_ns) - offset))
            # stable sort: equal corrected times keep per-process
            # recording order (hop lists are append-ordered already)
            hops.sort(key=lambda h: h[2])
            tenant = DEFAULT_TENANT
            for name in self.stores:
                tag = self.tenant_tags.get(name, {}).get(rid)
                if tag and tag != DEFAULT_TENANT:
                    tenant = tag  # first non-default tag wins (the
                    break         # client submit site tags first)
            spans.append(StitchedTrace(req_id=rid, hops=hops,
                                       tenant=tenant))
        spans.sort(key=lambda s: s.start_ns)
        return spans

    def render(self, n: int = 10) -> str:
        """The last ``n`` stitched spans, human-shaped."""
        spans = self.stitch()[-n:]
        head = (f"{len(spans)} stitched trace(s) from "
                f"{len(self.stores)} process(es)")
        if self.unreachable:
            head += f"; unreachable: {', '.join(self.unreachable)}"
        return "\n".join([head] + [s.render() for s in spans])


def collect_traces(endpoints: Sequence[str],
                   timeout: Optional[float] = None,
                   req_id: Optional[int] = None) -> List[StitchedTrace]:
    """One-shot convenience: collect + stitch (``mvt.traces``)."""
    collector = TraceCollector(endpoints, timeout=timeout)
    collector.collect()
    return collector.stitch(req_id)
