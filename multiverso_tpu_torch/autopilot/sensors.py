"""Fleet sensors: one consistent telemetry snapshot per control tick
(port of ``multiverso_tpu/autopilot/sensors.py``).

The autopilot never acts on raw counters — every tick starts by freezing
the state of the telemetry plane into a :class:`FleetSense` value:
per-shard request rates out of the ``ROUTER_SHARD<k>_SECONDS`` ring
(the same series the hot-range detector reads), read-tier pressure
(hedges + replica refusals + primary fallbacks per second), replica
replay lag probed over the slot-free watermark RPC, tiered-store hit
rates and resident bytes, the client Get p99, and the queryable state
of the SLO burn engine and the fleet auditor. The policy then decides
over the snapshot, so a decision and its flight-recorder record always
describe the SAME instant.

Replica lag is probed, not scraped: ``REPLICA_LAG_RECORDS`` is set by
the replica CHILD process's gauge registry and is invisible to the
launcher's recorder, so the sensors fan one ``mvt.watermark`` probe per
replica endpoint and republish the worst lag per shard as the local
``FLEET_SHARD<k>_REPLICA_LAG`` gauge — which also gives operators (and
Prometheus, via the shard-labelled exposition) a per-shard pressure
series in the controlling process.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import config
from multiverso_tpu_torch.dashboard import gauge_set


@dataclass
class FleetSense:
    """The telemetry plane at one instant, as the policy consumes it."""

    now: float
    shard_rates: List[float] = field(default_factory=list)
    total_qps: float = 0.0
    read_pressure: float = 0.0      # hedges+refusals+fallbacks per sec
    shed_rate: float = 0.0          # SHED_ADDS+SHED_GETS per sec
    tenant_shed_rates: Dict[str, float] = field(default_factory=dict)
    replica_lag: Dict[int, int] = field(default_factory=dict)
    replica_counts: List[int] = field(default_factory=list)
    get_p99: float = 0.0
    tier_hit_rate: Optional[float] = None   # None: no tiered traffic
    tier_resident_bytes: float = 0.0
    slo_firing: List[str] = field(default_factory=list)
    audit_divergent: bool = False

    def as_dict(self) -> Dict[str, Any]:
        return {"now": self.now, "shard_rates": list(self.shard_rates),
                "total_qps": self.total_qps,
                "read_pressure": self.read_pressure,
                "shed_rate": self.shed_rate,
                "tenant_shed_rates": dict(self.tenant_shed_rates),
                "replica_lag": dict(self.replica_lag),
                "replica_counts": list(self.replica_counts),
                "get_p99": self.get_p99,
                "tier_hit_rate": self.tier_hit_rate,
                "tier_resident_bytes": self.tier_resident_bytes,
                "slo_firing": list(self.slo_firing),
                "audit_divergent": self.audit_divergent}


class FleetSensors:
    """Reads the recorder/engine/auditor into :class:`FleetSense` values.

    ``group`` is the ShardGroup under control (shard count and replica
    endpoints come from its live manifest), ``recorder`` a
    TimeSeriesRecorder (default: the global one), ``engine``/``auditor``
    the queryable SLO and audit planes (either may be None — the
    corresponding fields degrade to empty/False), ``probe`` the
    watermark RPC seam tests inject."""

    def __init__(self, group: Any, recorder: Any = None,
                 engine: Any = None, auditor: Any = None,
                 window: Optional[float] = None,
                 probe: Any = None,
                 probe_timeout: float = 2.0) -> None:
        if recorder is None:
            from multiverso_tpu_torch.obs.timeseries import TIMESERIES
            recorder = TIMESERIES
        self.group = group
        self.recorder = recorder
        self.engine = engine
        self.auditor = auditor
        self.window = float(window if window is not None else
                            config.get_flag("autopilot_window_seconds"))
        if probe is None:
            from multiverso_tpu_torch.runtime.remote import fetch_watermark
            probe = fetch_watermark
        self._probe = probe
        self._probe_timeout = float(probe_timeout)

    # -- pieces --------------------------------------------------------------
    def shard_rates(self) -> List[float]:
        rates: List[float] = []
        for k in range(int(self.group.num_shards)):
            hist = self.recorder.window_histogram(
                f"ROUTER_SHARD{k}_SECONDS", self.window)
            n = int(hist.count) if hist is not None else 0
            rates.append(n / self.window)
        return rates

    def read_pressure(self) -> float:
        return sum(self.recorder.rate(name, self.window)
                   for name in ("READ_HEDGES",
                                "READ_REPLICA_REFUSALS_SEEN",
                                "READ_PRIMARY_FALLBACKS"))

    def shed_rate(self) -> float:
        """Admission-control refusals per second (both lanes): a sustained
        non-zero rate means the fleet is in brownout — the overload gate
        (docs/fault_tolerance.md) is actively trading training writes for
        serving-read latency, and adding replicas or shards is the fix."""
        return sum(self.recorder.rate(name, self.window)
                   for name in ("SHED_ADDS", "SHED_GETS"))

    def tenant_shed_rates(self) -> Dict[str, float]:
        """Per-tenant shed rate (``TENANT_<t>_SHED`` per second): the
        disaggregation of :meth:`shed_rate` that stops one noisy tenant
        masquerading as fleet-wide capacity pressure — a policy can see
        that the shedding is confined to the tenant whose quota is doing
        its job. Degrades to {} on recorders without the tenant view
        (tests inject minimal fakes)."""
        rates = getattr(self.recorder, "tenant_rates", None)
        if rates is None:
            return {}
        return dict(rates("SHED", self.window))

    def replica_lag(self) -> Dict[int, int]:
        """Worst replay lag (records) per shard, probed concurrently
        over the slot-free watermark RPC; unreachable replicas are
        skipped (the auditor owns unreachability)."""
        fleets = list(getattr(self.group, "replica_endpoints", []) or [])
        lags: Dict[int, int] = {}
        lock = threading.Lock()

        def probe(shard: int, ep: str) -> None:
            try:
                wm = self._probe(ep, timeout=self._probe_timeout)
            except (OSError, RuntimeError):
                return
            lag = int(wm.get("lag", 0) or 0)
            with lock:
                lags[shard] = max(lags.get(shard, 0), lag)

        threads = [threading.Thread(target=probe, args=(k, ep),
                                    daemon=True, name="mv-autopilot-probe")
                   for k, fleet in enumerate(fleets) for ep in fleet]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self._probe_timeout + 1.0)
        for shard, lag in lags.items():
            # republish locally: the per-shard pressure series operators
            # scrape from the CONTROLLING process (docs/observability.md)
            gauge_set(f"FLEET_SHARD{shard}_REPLICA_LAG", lag)
        return lags

    def tier_hit_rate(self) -> Optional[float]:
        hot = self.recorder.rate("TIER_HOT_HITS", self.window)
        cold = self.recorder.rate("TIER_COLD_HITS", self.window)
        if hot + cold <= 0:
            return None
        return hot / (hot + cold)

    # -- the snapshot --------------------------------------------------------
    def read(self, now: Optional[float] = None) -> FleetSense:
        rates = self.shard_rates()
        fleets = list(getattr(self.group, "replica_endpoints", []) or [])
        counts = [len(fleets[k]) if k < len(fleets) else 0
                  for k in range(int(self.group.num_shards))]
        firing: List[str] = []
        if self.engine is not None:
            firing = list(self.engine.firing())
        divergent = bool(self.auditor is not None
                         and getattr(self.auditor, "divergent", False))
        return FleetSense(
            now=float(now if now is not None else time.time()),
            shard_rates=rates,
            total_qps=sum(rates),
            read_pressure=self.read_pressure(),
            shed_rate=self.shed_rate(),
            tenant_shed_rates=self.tenant_shed_rates(),
            replica_lag=self.replica_lag(),
            replica_counts=counts,
            get_p99=self.recorder.quantile("CLIENT_REQUEST_SECONDS",
                                           0.99, self.window),
            tier_hit_rate=self.tier_hit_rate(),
            tier_resident_bytes=self.recorder.gauge("TIER_RESIDENT_BYTES"),
            slo_firing=firing,
            audit_divergent=divergent)
