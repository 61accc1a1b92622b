"""Telemetry subsystem (port of ``multiverso_tpu/obs/``, in part).

Ported so far: :mod:`~multiverso_tpu_torch.obs.profiler`, the wait-site
registry and the sampling profiler. The metrics, traces, flight recorder,
collector, time series and SLO modules wait for their slice
(``ROADMAP.md``); the Monitors, Counters, Histograms and Gauges live in
``dashboard.py``.
"""
