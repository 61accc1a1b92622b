"""Tuner sensors: one fused snapshot of "where is the time going" (port
of ``multiverso_tpu/tune/sensors.py``).

The autopilot's sensors answer fleet-shape questions (per-shard heat,
replica lag); the tuner's answer a different one — which COST dominates
the runtime right now — by fusing three sources the observability plane
already maintains:

* the sampling profiler's per-site wait seconds (``obs/profiler.py``),
  differenced per read so a site's share is windowed, not cumulative;
* the time-series recorder's windowed rates and histogram quantiles
  (``obs/timeseries.py``) — hedge/cache pressure and the objective's
  throughput + p99 both come from here;
* optionally, critical-path attribution (``obs/critpath.attribute``):
  an injected ``attribution`` callable returning the dominant segment
  name (e.g. ``"wire:client->server"``) lets a fleet-connected tuner
  see process-boundary cost the local profiler cannot.

The objective is throughput-weighted p99: ``completions/s divided by
p99 seconds`` over the window. Higher is better; a knob step that
tanks either factor regresses the objective and gets reverted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from multiverso_tpu_torch import config

# p99 floor for the objective ratio: below this the latency factor is
# noise (an idle loopback answers in microseconds) and the objective
# would swing on nothing but jitter
_P99_FLOOR = 1e-3


@dataclass
class TuneSense:
    """One tick's fused snapshot — everything a rule may condition on,
    and the record the flight recorder keeps per step/verify."""

    now: float = 0.0
    # windowed wait-site seconds (delta since the previous read)
    wait: Dict[str, float] = field(default_factory=dict)
    dominant_wait: str = ""
    dominant_wait_seconds: float = 0.0
    # dominant critical-path segment name ("" without attribution)
    dominant_segment: str = ""
    # read-tier pressure (events/s over the window)
    hedge_rate: float = 0.0
    hedge_win_rate: float = 0.0
    cache_hit_rate: float = 0.0
    cache_miss_rate: float = 0.0
    # effective hedge delay the router currently runs (seconds)
    hedge_delay_seconds: float = 0.0
    # the objective's two factors + the objective itself
    throughput: float = 0.0
    p99: float = 0.0
    objective: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"now": self.now,
                "wait": {k: round(v, 6) for k, v in self.wait.items()},
                "dominant_wait": self.dominant_wait,
                "dominant_wait_seconds": round(
                    self.dominant_wait_seconds, 6),
                "dominant_segment": self.dominant_segment,
                "hedge_rate": round(self.hedge_rate, 3),
                "hedge_win_rate": round(self.hedge_win_rate, 3),
                "cache_hit_rate": round(self.cache_hit_rate, 3),
                "cache_miss_rate": round(self.cache_miss_rate, 3),
                "hedge_delay_seconds": round(self.hedge_delay_seconds, 6),
                "throughput": round(self.throughput, 3),
                "p99": round(self.p99, 6),
                "objective": round(self.objective, 3)}


class TuneSensors:
    """Stateful sensor fusion (the wait-site differencing needs memory
    of the previous read). Components are injectable so controller unit
    tests drive synthetic tables through the rule engine; by default the
    global recorder/profiler are read."""

    def __init__(self, recorder: Any = None, profiler: Any = None,
                 attribution: Optional[Callable[[], str]] = None,
                 window: Optional[float] = None,
                 latency_histogram: str = "CLIENT_REQUEST_SECONDS") -> None:
        if recorder is None:
            from multiverso_tpu_torch.obs.timeseries import TIMESERIES
            recorder = TIMESERIES
        if profiler is None:
            from multiverso_tpu_torch.obs.profiler import PROFILER
            profiler = PROFILER
        self.recorder = recorder
        self.profiler = profiler
        self.attribution = attribution
        self.window = float(window if window is not None
                            else config.get_flag("autotune_window_seconds"))
        self.latency_histogram = latency_histogram
        self._last_wait: Dict[str, float] = {}

    def _wait_deltas(self) -> Dict[str, float]:
        current = self.profiler.wait_seconds()
        deltas = {site: max(0.0, float(sec) - self._last_wait.get(site, 0.0))
                  for site, sec in current.items()}
        self._last_wait = {site: float(sec)
                           for site, sec in current.items()}
        return {site: d for site, d in deltas.items() if d > 0.0}

    def read(self, now: Optional[float] = None) -> TuneSense:
        now = float(now if now is not None else time.time())
        sense = TuneSense(now=now)
        sense.wait = self._wait_deltas()
        if sense.wait:
            site = max(sense.wait, key=sense.wait.get)
            sense.dominant_wait = site
            sense.dominant_wait_seconds = sense.wait[site]
        if self.attribution is not None:
            try:
                sense.dominant_segment = str(self.attribution() or "")
            except Exception:  # noqa: BLE001 — a dead fleet probe must
                # not blind the local sensors
                sense.dominant_segment = ""
        rec, w = self.recorder, self.window
        sense.hedge_rate = rec.rate("READ_HEDGES", w)
        sense.hedge_win_rate = rec.rate("READ_HEDGE_WINS", w)
        sense.cache_hit_rate = rec.rate("READ_CACHE_HITS", w)
        sense.cache_miss_rate = rec.rate("READ_CACHE_MISSES", w)
        sense.hedge_delay_seconds = rec.gauge("READ_HEDGE_DELAY_SECONDS")
        hist = rec.window_histogram(self.latency_histogram, w)
        if hist is not None and hist.count > 0:
            sense.throughput = hist.count / max(w, 1e-9)
            sense.p99 = float(hist.quantile(0.99))
        sense.objective = (
            sense.throughput / max(sense.p99, _P99_FLOOR)
            if sense.throughput > 0 else 0.0)
        return sense
