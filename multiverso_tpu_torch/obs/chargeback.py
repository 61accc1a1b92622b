"""Per-tenant chargeback over stitched traces (``mvt.chargeback``; port
of ``multiverso_tpu/obs/chargeback.py``).

The attribution layer (obs/critpath.py) answers *where* fleet time went
— dispatcher, wire, apply, WAL. This module answers the question a
shared parameter-server cluster gets asked first: *which tenant's
traffic bought which fraction of the machine*. Every stitched span
carries the tenant tag its client submit site stamped
(:func:`~multiverso_tpu_torch.runtime.admission.resolve_tenant` over the
``tenant_quota_spec`` flag; untagged traffic folds into ``_default``),
so chargeback is a partition of the same critical-path segments by
tenant: per-tenant share-of-fleet-time (shares sum to 1.0 by
construction), apply+WAL time (the write cost), p99 span latency, plus
the counter-plane columns — bytes pushed, Adds admitted, requests shed
— folded in from the ``TENANT_<t>_*`` families.

Like every diagnostic reader here, it degrades instead of failing:
unreachable endpoints are skipped, and a tenant visible only in
counters (all its spans evicted) still gets a row with zero time.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from multiverso_tpu_torch.obs.collector import StitchedTrace
from multiverso_tpu_torch.obs.critpath import segments
from multiverso_tpu_torch.obs.trace import DEFAULT_TENANT

# the segment endpoints that count as write cost: time flowing into or
# out of the WAL append and the apply stage (wire-straddling variants
# included — "wire:dispatch_enqueue->apply_add" is still apply pressure)
_APPLY_WAL = ("wal_append", "apply_add")


def _is_apply_wal(segment: str) -> bool:
    name = segment[5:] if segment.startswith("wire:") else segment
    a, _, b = name.partition("->")
    return a in _APPLY_WAL or b in _APPLY_WAL


class ChargebackReport:
    """Per-tenant cost table across many stitched spans.

    ``rows`` is sorted by total attributed time, each row a dict with
    ``tenant``, ``share`` (fraction of all attributed span time —
    summing to ~1.0 whenever any time was attributed), ``total_ms``,
    ``apply_wal_ms``, ``p99_ms``, ``spans`` and the counter-plane
    columns ``bytes`` / ``admitted`` / ``shed``.
    """

    def __init__(self, rows: List[Dict], traces: int,
                 quantile: Optional[float] = None) -> None:
        self.rows = rows
        self.traces = traces
        self.quantile = quantile

    def row(self, tenant: str) -> Optional[Dict]:
        for row in self.rows:
            if row["tenant"] == tenant:
                return row
        return None

    def to_dict(self) -> Dict:
        out = {"traces": self.traces, "rows": self.rows}
        if self.quantile is not None:
            out["quantile"] = self.quantile
        return out

    def render(self) -> str:
        head = "chargeback over %d trace(s)" % self.traces
        if self.quantile is not None:
            head += " (slowest p%g subset)" % (100.0 * self.quantile)
        if not self.rows:
            return head + ": <no tenant-attributable traces>"
        lines = [head,
                 "  %-16s %7s %12s %14s %10s %7s %12s %10s %8s"
                 % ("tenant", "share", "total_ms", "apply+wal_ms",
                    "p99_ms", "spans", "bytes", "admitted", "shed")]
        for row in self.rows:
            lines.append(
                "  %-16s %6.1f%% %12.3f %14.3f %10.3f %7d %12d %10d %8d"
                % (row["tenant"], 100.0 * row["share"], row["total_ms"],
                   row["apply_wal_ms"], row["p99_ms"], row["spans"],
                   row["bytes"], row["admitted"], row["shed"]))
        return "\n".join(lines)

    def display(self) -> str:
        """Print-and-return, the ``Dashboard.display()`` contract."""
        text = self.render()
        print(text, flush=True)
        return text


def charge(traces: Sequence[StitchedTrace],
           counters: Optional[Dict[str, Dict[str, int]]] = None,
           quantile: Optional[float] = None) -> ChargebackReport:
    """Partition span time across tenants.

    ``counters`` is ``{tenant: {"BYTES"|"ADMITTED"|"SHED": total}}`` —
    the counter-plane columns (see :func:`fleet_chargeback` for the
    fleet fold). With ``quantile`` only the slowest ``1 - quantile``
    fraction of spans is charged (tail chargeback), mirroring
    :func:`~multiverso_tpu_torch.obs.critpath.attribute`.
    """
    spans = [t for t in traces if len(t.hops) >= 2]
    if quantile is not None and spans:
        q = min(max(float(quantile), 0.0), 1.0)
        spans = sorted(spans, key=lambda s: s.duration_ns)
        cut = min(len(spans) - 1, int(math.floor(q * len(spans))))
        spans = spans[cut:]
    agg: Dict[str, Dict] = {}

    def row_of(tenant: str) -> Dict:
        return agg.setdefault(tenant, {
            "tenant": tenant, "total_ms": 0.0, "apply_wal_ms": 0.0,
            "spans": 0, "_durations_ms": [],
            "bytes": 0, "admitted": 0, "shed": 0})

    for span in spans:
        row = row_of(span.tenant or DEFAULT_TENANT)
        row["spans"] += 1
        row["_durations_ms"].append(span.duration_ns / 1e6)
        for name, sec in segments(span):
            row["total_ms"] += sec * 1e3
            if _is_apply_wal(name):
                row["apply_wal_ms"] += sec * 1e3
    for tenant, cols in (counters or {}).items():
        row = row_of(tenant)  # counter-only tenants still get a row
        row["bytes"] += int(cols.get("BYTES", 0))
        row["admitted"] += int(cols.get("ADMITTED", 0))
        row["shed"] += int(cols.get("SHED", 0))
    total_ms = sum(row["total_ms"] for row in agg.values())
    rows = sorted(agg.values(), key=lambda r: (-r["total_ms"],
                                               r["tenant"]))
    for row in rows:
        # shares sum to 1.0 by construction: each is this tenant's slice
        # of the SAME total every span contributed to
        row["share"] = (row["total_ms"] / total_ms) if total_ms > 0 else 0.0
        durations = sorted(row.pop("_durations_ms"))
        row["p99_ms"] = (durations[min(len(durations) - 1,
                                       int(0.99 * len(durations)))]
                         if durations else 0.0)
    return ChargebackReport(rows, traces=len(spans), quantile=quantile)


def _tenant_counters(endpoints: Sequence[str],
                     timeout: Optional[float] = None
                     ) -> Dict[str, Dict[str, int]]:
    """Fold the ``TENANT_<t>_<SUFFIX>`` counter families across the
    local dashboard (where the client-side BYTES series lives) and every
    reachable endpoint (where the admission-gate ADMITTED/SHED series
    live) into ``{tenant: {suffix: total}}``."""
    from multiverso_tpu_torch import config
    from multiverso_tpu_torch.dashboard import Dashboard, split_tenant
    from multiverso_tpu_torch.runtime.remote import fetch_stats
    t = float(timeout if timeout is not None
              else config.get_flag("stats_timeout_seconds"))
    merged: Dict[str, int] = dict(Dashboard.snapshot()["counters"])
    local_ep = None
    try:  # an IN-PROCESS server's registry IS the local dashboard —
        # probing it over the wire would double every column
        from multiverso_tpu_torch import Zoo
        local_ep = getattr(Zoo.instance().remote_server, "endpoint", None)
    except Exception:  # noqa: BLE001 — diagnostics degrade, never fail
        local_ep = None
    for ep in endpoints:
        if local_ep is not None and str(ep) == str(local_ep):
            continue
        try:
            snap = fetch_stats(ep, timeout=t)
        except (OSError, RuntimeError):
            continue  # diagnostics degrade, never fail
        for name, value in snap.counters.items():
            merged[name] = merged.get(name, 0) + int(value)
    out: Dict[str, Dict[str, int]] = {}
    for name, value in merged.items():
        tenant, suffix = split_tenant(name)
        if tenant is None:
            continue
        cols = out.setdefault(tenant, {})
        cols[suffix] = cols.get(suffix, 0) + int(value)
    return out


def fleet_chargeback(endpoints: Sequence[str],
                     timeout: Optional[float] = None,
                     quantile: Optional[float] = None) -> ChargebackReport:
    """Collect + stitch + charge across a fleet (``mvt.chargeback``):
    tenant-tagged spans from every trace store, counter columns from
    every stats endpoint plus the local dashboard."""
    from multiverso_tpu_torch.obs.collector import collect_traces
    spans = collect_traces(endpoints, timeout=timeout)
    counters = _tenant_counters(endpoints, timeout=timeout)
    return charge(spans, counters=counters, quantile=quantile)
