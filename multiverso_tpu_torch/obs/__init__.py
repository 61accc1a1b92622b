"""Telemetry subsystem (port of ``multiverso_tpu/obs/``, in part).

* :mod:`~multiverso_tpu_torch.obs.metrics` — log-bucketed
  :class:`Histogram` (p50/p95/p99), :class:`Gauge`, and the stats-RPC
  :class:`StatsSnapshot` with :func:`merge_stats`; the first two live in
  the Dashboard registry (``dashboard.py``).
* :mod:`~multiverso_tpu_torch.obs.trace` — ``req_id``-keyed per-request
  hop traces and the :class:`FlightRecorder` (dump-on-anomaly JSONL).
* :mod:`~multiverso_tpu_torch.obs.profiler` — the wait-site registry and
  the sampling profiler.

The audit, collector, critical-path, chargeback, SLO, time-series and
logger modules wait for their slice (``ROADMAP.md``).
"""

from multiverso_tpu_torch.obs.metrics import (  # noqa: F401
    Gauge, Histogram, StatsSnapshot, log_bounds, merge_stats)
from multiverso_tpu_torch.obs.trace import (  # noqa: F401
    RECORDER, TRACES, FlightRecorder, TraceStore, flight_dump, hop)
