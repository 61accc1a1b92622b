"""Telemetry subsystem (port of ``multiverso_tpu/obs/``): distributions,
tracing, flight recorder, metrics.

* :mod:`~multiverso_tpu_torch.obs.metrics` — log-bucketed
  :class:`Histogram` (p50/p95/p99), :class:`Gauge`, and the stats-RPC
  :class:`StatsSnapshot` with :func:`merge_stats`; the first two live in
  the Dashboard registry (``dashboard.py``).
* :mod:`~multiverso_tpu_torch.obs.trace` — ``req_id``-keyed per-request
  hop traces and the :class:`FlightRecorder` (dump-on-anomaly JSONL).
* :mod:`~multiverso_tpu_torch.obs.logger` — :class:`MetricsLogger`
  periodic JSONL snapshots (``metrics_path`` /
  ``metrics_interval_seconds``).
* :mod:`~multiverso_tpu_torch.obs.collector` — :class:`TraceCollector`
  cross-process trace stitching over the ``Control_Traces`` RPC
  (clock-offset estimation + causally-ordered merged spans).
* :mod:`~multiverso_tpu_torch.obs.critpath` and
  :mod:`~multiverso_tpu_torch.obs.chargeback` — critical-path
  attribution of stitched spans, by segment and by tenant.
* :mod:`~multiverso_tpu_torch.obs.timeseries` — :class:`TimeSeriesRecorder`
  ring-buffer sampling of the registry (windowed rates / quantiles).
* :mod:`~multiverso_tpu_torch.obs.slo` — declarative SLOs with
  multi-window burn-rate alerting, and the ``mvt.top`` fleet view.
* :mod:`~multiverso_tpu_torch.obs.profiler` — the wait-site registry and
  the sampling profiler.
* :mod:`~multiverso_tpu_torch.obs.audit` — order-independent table
  digests and the :class:`FleetAuditor` (``mvt.audit``).
"""

from multiverso_tpu_torch.obs.metrics import (  # noqa: F401
    Gauge, Histogram, StatsSnapshot, log_bounds, merge_stats)
from multiverso_tpu_torch.obs.trace import (  # noqa: F401
    RECORDER, TRACES, FlightRecorder, TraceStore, flight_dump, hop)
from multiverso_tpu_torch.obs.collector import (  # noqa: F401
    StitchedTrace, TraceCollector, collect_traces, estimate_offset)

# Lazy re-exports (PEP 562): these modules import the dashboard, which
# imports obs.metrics, which runs this file first.
_LAZY = {
    "audit": ("FleetAuditor", "digest_payload", "table_digest"),
    "logger": ("MetricsLogger", "load_metrics"),
    "timeseries": ("TIMESERIES", "TimeSeriesRecorder"),
    "slo": ("Objective", "SLOEngine", "default_objectives", "fleet_top",
            "parse_slo_spec"),
}


def __getattr__(name):
    for module, names in _LAZY.items():
        if name in names:
            import importlib
            return getattr(importlib.import_module(
                f"multiverso_tpu_torch.obs.{module}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
