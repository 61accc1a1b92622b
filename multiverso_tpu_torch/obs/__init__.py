"""Telemetry subsystem (port of ``multiverso_tpu/obs/``, in part).

* :mod:`~multiverso_tpu_torch.obs.metrics` — log-bucketed
  :class:`Histogram` (p50/p95/p99), :class:`Gauge`, and the stats-RPC
  :class:`StatsSnapshot` with :func:`merge_stats`; the first two live in
  the Dashboard registry (``dashboard.py``).
* :mod:`~multiverso_tpu_torch.obs.trace` — ``req_id``-keyed per-request
  hop traces and the :class:`FlightRecorder` (dump-on-anomaly JSONL).
* :mod:`~multiverso_tpu_torch.obs.profiler` — the wait-site registry and
  the sampling profiler.
* :mod:`~multiverso_tpu_torch.obs.audit` — order-independent table
  digests and the :class:`FleetAuditor` (``mv.audit``).

The collector, critical-path, chargeback, SLO, time-series and logger
modules wait for their slice (``ROADMAP.md``).
"""

from multiverso_tpu_torch.obs.metrics import (  # noqa: F401
    Gauge, Histogram, StatsSnapshot, log_bounds, merge_stats)
from multiverso_tpu_torch.obs.trace import (  # noqa: F401
    RECORDER, TRACES, FlightRecorder, TraceStore, flight_dump, hop)

_AUDIT_NAMES = ("FleetAuditor", "digest_payload", "table_digest")


def __getattr__(name):
    # Lazy re-exports (PEP 562): obs.audit imports the dashboard, which
    # imports obs.metrics, which runs this file first.
    if name in _AUDIT_NAMES:
        from multiverso_tpu_torch.obs import audit
        return getattr(audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
