"""Critical-path attribution over stitched traces (port of
``multiverso_tpu/obs/critpath.py``).

A :class:`~multiverso_tpu_torch.obs.collector.StitchedTrace` is a causally
ordered list of ``(process, stage, t_corrected_ns)`` hops.  The time a
request actually spent is the sum of the gaps between consecutive hops,
so attribution is a segment decomposition:

* ``"stage_a->stage_b"`` — both hops in the same process: time spent
  inside that process between the two stages (dispatch queueing, apply,
  WAL append, ...).
* ``"wire:stage_a->stage_b"`` — the hops straddle a process boundary:
  wire transit plus any remote ingress queueing before the first hop on
  the far side.

:func:`segments` decomposes one span, :func:`dominant` names its single
largest segment, and :func:`attribute` aggregates a whole trace-store
pull into an :class:`AttributionReport` — the "p99 Get: 61% replica
apply-lag wait, 22% wire" table the self-tuning controller (ROADMAP)
needs.  ``mvt.attribution(fleet)`` is the front door.

Clock-offset correction happens upstream in the collector; this module
only trusts the corrected timestamps (negative gaps from residual skew
clamp to zero rather than producing negative attributions).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch.obs.collector import StitchedTrace


def segments(trace: StitchedTrace) -> List[Tuple[str, float]]:
    """Decompose one span into named ``(segment, seconds)`` gaps between
    consecutive hops; residual-skew negative gaps clamp to zero."""
    out: List[Tuple[str, float]] = []
    hops = trace.hops
    for (p0, s0, t0), (p1, s1, t1) in zip(hops, hops[1:]):
        name = ("%s->%s" % (s0, s1) if p0 == p1
                else "wire:%s->%s" % (s0, s1))
        out.append((name, max(0, t1 - t0) / 1e9))
    return out


def dominant(trace: StitchedTrace) -> Optional[Tuple[str, float, float]]:
    """The span's largest segment as ``(name, seconds, share)`` —
    ``share`` is its fraction of the span's total; None for spans with
    fewer than two hops."""
    segs = segments(trace)
    if not segs:
        return None
    total = sum(sec for _, sec in segs)
    name, sec = max(segs, key=lambda kv: kv[1])
    return name, sec, (sec / total if total > 0 else 0.0)


class AttributionReport:
    """Aggregated latency attribution across many stitched spans.

    ``rows`` is sorted by total attributed time, each row a dict with
    ``segment``, ``total_ms``, ``share`` (fraction of all attributed
    time), ``count`` (spans containing the segment), ``mean_ms`` and
    ``max_ms``.  ``profiles`` optionally carries per-process sampling
    profiles pulled over ``Control_Profile``.
    """

    def __init__(self, rows: List[Dict], traces: int,
                 quantile: Optional[float] = None,
                 profiles: Optional[Dict[str, Dict]] = None) -> None:
        self.rows = rows
        self.traces = traces
        self.quantile = quantile
        self.profiles = profiles or {}

    @property
    def dominant(self) -> Optional[Dict]:
        return self.rows[0] if self.rows else None

    def to_dict(self) -> Dict:
        out = {"traces": self.traces, "rows": self.rows}
        if self.quantile is not None:
            out["quantile"] = self.quantile
        if self.profiles:
            out["profiles"] = self.profiles
        return out

    def render(self) -> str:
        head = "attribution over %d trace(s)" % self.traces
        if self.quantile is not None:
            head += " (slowest p%g subset)" % (100.0 * self.quantile)
        if not self.rows:
            return head + ": <no multi-hop traces>"
        lines = [head]
        for row in self.rows:
            lines.append("  %5.1f%%  %9.3f ms  (n=%d, mean %.3f ms)  %s"
                         % (100.0 * row["share"], row["total_ms"],
                            row["count"], row["mean_ms"], row["segment"]))
        for proc in sorted(self.profiles):
            waits = self.profiles[proc].get("wait_seconds") or {}
            if waits:
                top = sorted(waits.items(), key=lambda kv: -kv[1])[:3]
                lines.append("  profile %-24s %s" % (proc, ", ".join(
                    "%s=%.3fs" % (site, sec) for site, sec in top)))
        return "\n".join(lines)


def attribute(traces: Sequence[StitchedTrace],
              quantile: Optional[float] = None,
              profiles: Optional[Dict[str, Dict]] = None
              ) -> AttributionReport:
    """Aggregate segment attributions across ``traces``.

    With ``quantile`` (e.g. ``0.99``) only the slowest ``1 - quantile``
    fraction of spans is aggregated — tail attribution, the Dean et al.
    framing — instead of the whole population.
    """
    spans = [t for t in traces if len(t.hops) >= 2]
    if quantile is not None and spans:
        q = min(max(float(quantile), 0.0), 1.0)
        spans = sorted(spans, key=lambda s: s.duration_ns)
        cut = min(len(spans) - 1, int(math.floor(q * len(spans))))
        spans = spans[cut:]
    agg: Dict[str, Dict] = {}
    for span in spans:
        for name, sec in segments(span):
            row = agg.setdefault(name, {"segment": name, "total_ms": 0.0,
                                        "count": 0, "max_ms": 0.0})
            row["total_ms"] += sec * 1e3
            row["count"] += 1
            row["max_ms"] = max(row["max_ms"], sec * 1e3)
    total_ms = sum(row["total_ms"] for row in agg.values())
    rows = sorted(agg.values(), key=lambda r: (-r["total_ms"],
                                               r["segment"]))
    for row in rows:
        row["share"] = (row["total_ms"] / total_ms) if total_ms > 0 else 0.0
        row["mean_ms"] = row["total_ms"] / row["count"]
    return AttributionReport(rows, traces=len(spans), quantile=quantile,
                             profiles=profiles)


def collect_profiles(endpoints: Sequence[str],
                     timeout: Optional[float] = None) -> Dict[str, Dict]:
    """Pull sampling profiles from a fleet over ``Control_Profile``;
    unreachable endpoints are skipped (diagnostics degrade, never
    fail)."""
    from multiverso_tpu_torch import config
    from multiverso_tpu_torch.runtime.remote import fetch_profile
    t = float(timeout if timeout is not None
              else config.get_flag("stats_timeout_seconds"))
    out: Dict[str, Dict] = {}
    for ep in endpoints:
        try:
            payload = fetch_profile(ep, timeout=t)
        except (OSError, RuntimeError):
            continue
        role = str(payload.get("role", "unknown"))
        out["%s@%s" % (role, ep)] = payload.get("profile") or {}
    return out


def fleet_attribution(endpoints: Sequence[str],
                      timeout: Optional[float] = None,
                      quantile: Optional[float] = None,
                      include_profiles: bool = True) -> AttributionReport:
    """Collect + stitch + attribute across a fleet (``mvt.attribution``);
    optionally annotates the report with each process's profile."""
    from multiverso_tpu_torch.obs.collector import collect_traces
    spans = collect_traces(endpoints, timeout=timeout)
    profiles = (collect_profiles(endpoints, timeout=timeout)
                if include_profiles else None)
    return attribute(spans, quantile=quantile, profiles=profiles)
