"""Time-series recorder over the dashboard registry (port of
``multiverso_tpu/obs/timeseries.py``; host only).

The dashboard (``multiverso_tpu_torch/dashboard.py``) is cumulative: counters
only grow, histograms only accumulate. That answers "how many, ever" but
not the operator questions — "what is the Get rate NOW", "what was p99
over the last 30 seconds", "is the error rate accelerating". This module
answers them by SAMPLING: a :class:`TimeSeriesRecorder` snapshots every
registered counter, gauge and histogram at a fixed interval into
fixed-size ring buffers, and derives windowed views by differencing:

* :meth:`~TimeSeriesRecorder.rate` — counter delta / elapsed over a
  window (events per second);
* :meth:`~TimeSeriesRecorder.delta` — raw counter delta over a window;
* :meth:`~TimeSeriesRecorder.quantile` — windowed p50/p95/p99 from the
  BUCKET DIFFERENCE of two histogram snapshots (exact on the window's
  own samples — cumulative quantiles would be dominated by history);
* :meth:`~TimeSeriesRecorder.series` — the raw (t, value) points for a
  gauge or counter, for the dashboard's sparklines.

Memory is constant: ``timeseries_samples`` samples deep regardless of
uptime (default 600 x 1 s = a 10-minute window). The sampler thread is
modeled on ``obs/logger.MetricsLogger`` — daemon, interval-driven,
joined on stop; ``sample_now()`` is the deterministic seam tests and the
SLO engine use instead of sleeping.

The SLO burn-rate engine (``obs/slo.py``) is this module's primary
consumer: burn rates are windowed error-budget spends, which are exactly
the windowed rates/quantiles recorded here.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.obs.metrics import Histogram


class _Sample:
    """One registry snapshot: wall time + flat value maps. Histograms
    keep their full bucket arrays so windows can difference them."""

    __slots__ = ("t", "counters", "gauges", "histograms")

    def __init__(self, t: float, counters: Dict[str, int],
                 gauges: Dict[str, float],
                 histograms: Dict[str, Dict[str, Any]]) -> None:
        self.t = t
        self.counters = counters
        self.gauges = gauges
        self.histograms = histograms


def _hist_diff(name: str, newer: Dict[str, Any],
               older: Optional[Dict[str, Any]]) -> Histogram:
    """The histogram of observations that happened BETWEEN two
    snapshots: bucket-wise subtraction (both snapshots of one cumulative
    histogram share bounds). A reset between samples (counts regressed)
    falls back to the newer snapshot alone."""
    if older is None or older.get("bounds") != newer.get("bounds") \
            or int(older.get("count", 0)) > int(newer.get("count", 0)):
        return Histogram.from_dict(name, newer)
    diff = {
        "bounds": list(newer["bounds"]),
        "buckets": [int(a) - int(b) for a, b in
                    zip(newer["buckets"], older["buckets"])],
        "overflow": int(newer.get("overflow", 0))
        - int(older.get("overflow", 0)),
        "count": int(newer["count"]) - int(older["count"]),
        "sum": float(newer["sum"]) - float(older["sum"]),
        # max is not differencable; the newer cumulative max bounds it
        "max": float(newer.get("max", 0.0)),
    }
    return Histogram.from_dict(name, diff)


class TimeSeriesRecorder:
    """Fixed-memory sampler + windowed query surface (module docstring
    for the model). All queries are lock-consistent reads of the ring;
    an empty or single-sample ring answers conservatively (rate 0,
    quantile from whatever is there)."""

    def __init__(self, interval: Optional[float] = None,
                 samples: Optional[int] = None) -> None:
        # None = flag-driven, re-read at every start (the process-global
        # instance is built at import time, before flags are parsed)
        self._fixed_interval = interval
        self._fixed_samples = samples
        self.interval = float(
            interval if interval is not None
            else config.get_flag("timeseries_interval_seconds"))
        depth = int(samples if samples is not None
                    else config.get_flag("timeseries_samples"))
        self._ring: Deque[_Sample] = deque(maxlen=max(2, depth))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        if self._fixed_interval is None:
            self.interval = float(
                config.get_flag("timeseries_interval_seconds"))
        if self._fixed_samples is None:
            depth = max(2, int(config.get_flag("timeseries_samples")))
            if depth != self._ring.maxlen:
                with self._lock:
                    self._ring = deque(self._ring, maxlen=depth)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-timeseries")
        self._thread.start()
        # debug, not info: server child processes hand their first stdout
        # line to harnesses as a readiness marker, and this fires in every
        # mv.init before that marker is printed
        log.debug("timeseries: sampling every %.3gs, %d samples deep",
                  self.interval, self._ring.maxlen)

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_now()
            except Exception as exc:  # noqa: BLE001 — telemetry must
                # never die quietly NOR take anything down
                log.error("timeseries: sample failed: %r", exc)

    # -- sampling ------------------------------------------------------------
    def sample_now(self, t: Optional[float] = None) -> _Sample:
        """Take one snapshot immediately (the deterministic seam: tests
        and the SLO engine drive windows without wall-clock sleeps)."""
        snap = Dashboard.snapshot()
        sample = _Sample(
            t=float(t if t is not None else time.time()),
            counters=dict(snap.get("counters", {})),
            gauges=dict(snap.get("gauges", {})),
            histograms=dict(snap.get("histograms", {})))
        with self._lock:
            self._ring.append(sample)
        return sample

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- window anchoring ----------------------------------------------------
    def _window(self, window_seconds: float
                ) -> Tuple[Optional[_Sample], Optional[_Sample]]:
        """(oldest sample inside the window, newest sample). The oldest
        in-window sample anchors the difference; when the ring does not
        reach back that far, the oldest available sample does (the
        window degrades to the recorded history, it never fails)."""
        with self._lock:
            if not self._ring:
                return None, None
            newest = self._ring[-1]
            cutoff = newest.t - float(window_seconds)
            anchor = self._ring[0]
            for sample in self._ring:
                if sample.t >= cutoff:
                    anchor = sample
                    break
        return anchor, newest

    # -- queries -------------------------------------------------------------
    def delta(self, counter: str, window_seconds: float) -> int:
        """Counter increment over the window (0 when unknown)."""
        anchor, newest = self._window(window_seconds)
        if newest is None:
            return 0
        new = int(newest.counters.get(counter, 0))
        old = int(anchor.counters.get(counter, 0)) if anchor else 0
        if anchor is newest:
            # single sample: the whole cumulative value is the best
            # guess for "recent" — better than claiming silence
            return new
        return max(0, new - old)  # reset between samples clamps to 0

    def rate(self, counter: str, window_seconds: float) -> float:
        """Counter events per second over the window."""
        anchor, newest = self._window(window_seconds)
        if newest is None or anchor is None or anchor is newest:
            return 0.0
        dt = newest.t - anchor.t
        if dt <= 0:
            return 0.0
        d = max(0, int(newest.counters.get(counter, 0))
                - int(anchor.counters.get(counter, 0)))
        return d / dt

    def tenant_rates(self, suffix: str,
                     window_seconds: float) -> Dict[str, float]:
        """Per-tenant events/second for one ``TENANT_<t>_<SUFFIX>``
        family (``suffix`` in ``ADMITTED`` / ``SHED`` / ``BYTES``) —
        the windowed view ``mv.top``'s tenant panel and the autopilot's
        per-tenant shed sensor read. Tenants are discovered from the
        newest sample, so a tenant that never emitted is absent (not
        0.0)."""
        from multiverso_tpu_torch.dashboard import split_tenant
        with self._lock:
            newest = self._ring[-1] if self._ring else None
        if newest is None:
            return {}
        out: Dict[str, float] = {}
        for name in newest.counters:
            tenant, suf = split_tenant(name)
            if tenant is not None and suf == suffix.upper():
                out[tenant] = self.rate(name, window_seconds)
        return out

    def gauge(self, name: str) -> float:
        """Latest sampled gauge value."""
        with self._lock:
            if not self._ring:
                return 0.0
            return float(self._ring[-1].gauges.get(name, 0.0))

    def window_histogram(self, name: str,
                         window_seconds: float) -> Optional[Histogram]:
        """The histogram of observations INSIDE the window (bucket
        difference), or None when the histogram was never sampled."""
        anchor, newest = self._window(window_seconds)
        if newest is None:
            return None
        new = newest.histograms.get(name)
        if new is None:
            return None
        old = anchor.histograms.get(name) if (
            anchor is not None and anchor is not newest) else None
        return _hist_diff(name, new, old)

    def quantile(self, name: str, q: float,
                 window_seconds: float) -> float:
        """Windowed quantile of a histogram (0.0 when no samples)."""
        hist = self.window_histogram(name, window_seconds)
        if hist is None or hist.count <= 0:
            return 0.0
        return float(hist.quantile(q))

    def series(self, kind: str, name: str,
               window_seconds: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Raw (t, value) points for sparklines. ``kind`` is
        ``counter`` or ``gauge``."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"series: unknown kind {kind!r}")
        with self._lock:
            samples = list(self._ring)
        if window_seconds is not None and samples:
            cutoff = samples[-1].t - float(window_seconds)
            samples = [s for s in samples if s.t >= cutoff]
        if kind == "counter":
            return [(s.t, float(s.counters.get(name, 0)))
                    for s in samples]
        return [(s.t, float(s.gauges.get(name, 0.0))) for s in samples]

    def span_seconds(self) -> float:
        """How far back the ring currently reaches."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1].t - self._ring[0].t


# Process-global recorder — started by ``mv.init`` (the
# ``timeseries_interval_seconds`` flag), driven manually by tests.
TIMESERIES = TimeSeriesRecorder()
