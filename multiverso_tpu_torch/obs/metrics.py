"""Distribution metrics: log-bucketed histograms and point-in-time gauges.

The reference Multiverso's only observability units were section timers
(``Dashboard::Watch`` count/total/average, ``include/multiverso/
dashboard.h:16-75``) — averages. Li et al. (OSDI'14) and Ho et al.
(NIPS'13) both locate parameter-server performance in TAIL latency and
staleness distributions, which averages cannot see; this module supplies
the missing units. Both types join the :class:`~multiverso_tpu_torch.dashboard.
Dashboard` registry next to Monitor/Counter (``Dashboard.histogram(name)``
/ ``Dashboard.gauge(name)``).

This module is deliberately dependency-free (stdlib only): ``dashboard.py``
imports it lazily, and everything else imports ``dashboard`` — so no import
cycle can form.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional


def log_bounds(lowest: float = 1e-6, growth: float = 2.0,
               count: int = 28) -> List[float]:
    """Geometric bucket upper edges ``lowest * growth**i``. The defaults
    cover 1 µs .. ~134 s in factor-of-2 buckets — every latency this
    runtime produces, at a resolution where p99 is meaningful."""
    return [lowest * growth ** i for i in range(count)]


class Histogram:
    """Log-bucketed distribution with quantile estimates.

    Bucket ``i`` covers ``(bounds[i-1], bounds[i]]`` (bucket 0 starts at
    0); one overflow bucket catches values above the last bound. Quantiles
    interpolate linearly within the winning bucket, so on synthetic
    samples the expected value is exactly computable (tested). ``observe``
    is a bisect + two adds under a lock — cheap enough for every request.
    """

    __slots__ = ("name", "bounds", "_counts", "_overflow", "_count", "_sum",
                 "_max", "_lock")

    def __init__(self, name: str, bounds: Optional[List[float]] = None
                 ) -> None:
        self.name = name
        self.bounds = list(bounds) if bounds is not None else log_bounds()
        self._counts = [0] * len(self.bounds)
        self._overflow = 0
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        if value < 0.0 or math.isnan(value):
            value = 0.0
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            if idx < len(self.bounds):
                self._counts[idx] += 1
            else:
                self._overflow += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value

    # -- read side -----------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        return self._max

    def quantile(self, q: float) -> float:
        """Linear interpolation within the bucket holding rank ``q*count``;
        0.0 on an empty histogram; overflow ranks report the observed max
        (the honest upper bound — the bucket has no finite edge)."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            cum = 0.0
            for i, c in enumerate(self._counts):
                if c and cum + c >= rank:
                    lo = self.bounds[i - 1] if i else 0.0
                    hi = self.bounds[i]
                    frac = (rank - cum) / c
                    return lo + frac * (hi - lo)
                cum += c
            return self._max

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self.bounds)
            self._overflow = 0
            self._count = 0
            self._sum = 0.0
            self._max = 0.0

    # -- serialization (stats RPC / metrics JSONL) ---------------------------
    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {"bounds": list(self.bounds),
                    "buckets": list(self._counts),
                    "overflow": self._overflow,
                    "count": self._count,
                    "sum": self._sum,
                    "max": self._max}

    @classmethod
    def from_dict(cls, name: str, data: Dict[str, Any]) -> "Histogram":
        hist = cls(name, bounds=[float(b) for b in data["bounds"]])
        hist._counts = [int(c) for c in data["buckets"]]
        hist._overflow = int(data.get("overflow", 0))
        hist._count = int(data["count"])
        hist._sum = float(data["sum"])
        hist._max = float(data.get("max", 0.0))
        return hist

    def __repr__(self) -> str:
        return (f"Histogram({self.name}: count={self.count}, "
                f"p50={self.p50:.6f}, p95={self.p95:.6f}, "
                f"p99={self.p99:.6f}, max={self.max:.6f})")


class Gauge:
    """Point-in-time numeric value (queue depth, inflight requests, WAL
    backlog bytes, dedup-window occupancy, per-worker staleness): ``set``
    is last-writer-wins, ``add`` is an atomic delta — both under a lock so
    concurrent ``add`` calls never lose increments."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def __repr__(self) -> str:
        return f"Gauge({self.name}: {self.value:g})"


class StatsSnapshot:
    """A (possibly remote) dashboard snapshot — what ``mv.stats(endpoint)``
    returns. Wraps the serialized dict with typed accessors; histograms are
    rebuilt as real :class:`Histogram` objects so quantile math runs on the
    caller's side with the server's exact bucket counts."""

    def __init__(self, raw: Dict[str, Any]) -> None:
        self.raw = raw
        self.monitors: Dict[str, Dict[str, Any]] = dict(
            raw.get("monitors", {}))
        self.counters: Dict[str, int] = {
            k: int(v) for k, v in raw.get("counters", {}).items()}
        self.gauges: Dict[str, float] = {
            k: float(v) for k, v in raw.get("gauges", {}).items()}
        self._histograms = {
            name: Histogram.from_dict(name, data)
            for name, data in raw.get("histograms", {}).items()}
        # per-member sub-views when this snapshot is a merged shard-group
        # view (mv.stats_all / merge_stats); empty for a single server
        self.shards: List["StatsSnapshot"] = []
        # per-replica sub-views (endpoint -> StatsSnapshot) when the
        # group runs serving read replicas; the replica replay-lag gauges
        # (REPLICA_WATERMARK / REPLICA_LAG_RECORDS) live in these
        self.replicas: Dict[str, "StatsSnapshot"] = {}
        # endpoints that did not answer within the per-endpoint timeout
        # when this is a merged partial view (mv.stats_all): the merge is
        # over the REACHABLE members only, and this says which are not
        self.unreachable: List[str] = []

    def histogram(self, name: str) -> Optional[Histogram]:
        return self._histograms.get(name)

    @property
    def histograms(self) -> Dict[str, Histogram]:
        return dict(self._histograms)

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def gauge(self, name: str) -> float:
        return self.gauges.get(name, 0.0)

    def __repr__(self) -> str:
        return (f"StatsSnapshot({len(self.monitors)} monitors, "
                f"{len(self.counters)} counters, {len(self.gauges)} gauges, "
                f"{len(self._histograms)} histograms"
                + (f", merged over {len(self.shards)} shards"
                   if self.shards else "") + ")")


def merge_stats(snapshots) -> StatsSnapshot:
    """Fold several members' dashboards into ONE StatsSnapshot — the
    ``mv.stats_all`` merge: counters and gauges sum, monitors sum their
    counts/elapse (average recomputed), histograms merge by BUCKET
    ADDITION so quantiles of the merged view compute on the union of the
    members' exact counts (averaging per-member quantiles would be
    wrong). The members survive as ``.shards`` sub-views."""
    snapshots = list(snapshots)
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    monitors: Dict[str, Dict[str, Any]] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for snap in snapshots:
        for name, value in snap.counters.items():
            counters[name] = counters.get(name, 0) + int(value)
        for name, value in snap.gauges.items():
            gauges[name] = gauges.get(name, 0.0) + float(value)
        for name, mon in snap.monitors.items():
            agg = monitors.setdefault(name, {"count": 0, "elapse_ms": 0.0})
            agg["count"] += int(mon.get("count", 0))
            agg["elapse_ms"] += float(mon.get("elapse_ms", 0.0))
        for name, hist in snap._histograms.items():
            data = hist.to_dict()
            agg = hists.get(name)
            if agg is None:
                hists[name] = {"bounds": list(data["bounds"]),
                               "buckets": list(data["buckets"]),
                               "overflow": data["overflow"],
                               "count": data["count"],
                               "sum": data["sum"],
                               "max": data["max"]}
                continue
            if agg["bounds"] != list(data["bounds"]):
                # differently-bucketed members cannot add bucket-wise;
                # keep the first member's view (sub-views stay exact)
                continue
            agg["buckets"] = [a + b for a, b in zip(agg["buckets"],
                                                    data["buckets"])]
            agg["overflow"] += data["overflow"]
            agg["count"] += data["count"]
            agg["sum"] += data["sum"]
            agg["max"] = max(agg["max"], data["max"])
    for name, agg in monitors.items():
        agg["average_ms"] = (agg["elapse_ms"] / agg["count"]
                             if agg["count"] else 0.0)
    merged = StatsSnapshot({"monitors": monitors, "counters": counters,
                            "gauges": gauges, "histograms": hists})
    merged.shards = snapshots
    return merged
