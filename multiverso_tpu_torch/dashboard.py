"""Named section timers, counters, gauges and histograms (port of
``multiverso_tpu/dashboard.py``).

Reference capability (not copied): statically-registered named section timers
via ``MONITOR_BEGIN/END`` macros aggregating count/total/average, with a
global ``Dashboard::Watch/Display`` (``include/multiverso/dashboard.h:16-75``,
``src/dashboard.cpp:14-49``).

The registry also holds the telemetry units of
:mod:`multiverso_tpu_torch.obs.metrics`: monotonic ``Counter``\\ s,
log-bucketed ``Histogram``\\ s (every ``monitor`` section records its
duration distribution) and point-in-time ``Gauge``\\ s. ``snapshot()``
serializes the whole registry for the stats RPC and the flight recorder;
``render(format="prom")`` emits Prometheus text exposition. With
``profile_annotations`` on (the ``trace_dir`` flag turns it on) every
monitor section is also a ``torch.profiler.record_function`` scope, so
named sections show up in the run's profiler trace. Times are host-clock
seconds.

Series are created by name on first use. The durable path writes
``WAL_APPENDS``, ``WAL_APPEND_SECONDS``, ``WAL_FSYNC_SECONDS`` (under
``wal_sync=always``), ``WAL_BACKLOG_BYTES``, ``WAL_REPLAYED``,
``WAL_TRUNCATED_TAIL`` and ``SNAPSHOT_COMPACTIONS`` (``durable/wal.py``),
``FAILOVERS``, ``REPLICA_WATERMARK``, ``REPLICA_LAG_RECORDS`` and
``REPLICA_GAP_RESYNCS`` (``durable/standby.py``), the read tier's
``READ_*`` family (``runtime/read.py``) and ``AUDIT_RUNS``,
``AUDIT_DIVERGENCE``, ``AUDIT_SKEW_SKIPS`` and ``AUDIT_UNREACHABLE``
(``obs/audit.py``).

Not ported yet: the fleet views over many snapshots
(``obs/collector.py``, ``obs/slo.py``).
"""

from __future__ import annotations

import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from multiverso_tpu_torch.obs.metrics import (Gauge, Histogram,  # noqa: F401
                                              log_bounds)


class Monitor:
    """count / total-elapse / average for one named code section.

    The in-progress start time is THREAD-LOCAL: two threads timing the
    same named section concurrently each measure their own span (a single
    shared slot would let thread B's ``begin`` overwrite thread A's,
    corrupting both durations — the historical bug)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._count = 0
        self._elapse = 0.0  # seconds
        self._tls = threading.local()  # per-thread in-progress start time
        self._lock = threading.Lock()

    def begin(self) -> None:
        self._tls.begin = time.perf_counter()

    def end(self) -> None:
        begin = getattr(self._tls, "begin", None)
        if begin is None:
            return
        self._tls.begin = None
        self.observe(time.perf_counter() - begin)

    def observe(self, seconds: float) -> None:
        """Record one completed span (the begin/end pair fused — what the
        ``monitor`` context manager calls with its own local clock)."""
        with self._lock:
            self._count += 1
            self._elapse += seconds

    @property
    def count(self) -> int:
        return self._count

    @property
    def elapse_ms(self) -> float:
        return self._elapse * 1e3

    @property
    def average_ms(self) -> float:
        return self.elapse_ms / self._count if self._count else 0.0

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._elapse = 0.0
            self._tls = threading.local()

    def __repr__(self) -> str:
        return (f"Monitor({self.name}: count={self.count}, "
                f"elapse={self.elapse_ms:.3f}ms, average={self.average_ms:.3f}ms)")


class Counter:
    """Monotonic event counter — the fault subsystem's observability unit
    (retries, reconnects, evictions, injected faults, dedup hits). Section
    timers (Monitor) measure durations; Counters record discrete events
    that have none."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def __repr__(self) -> str:
        return f"Counter({self.name}: {self.value})"


def _prom_name(name: str, suffix: str = "") -> str:
    base = re.sub(r"[^a-zA-Z0-9_]", "_", name).lower().strip("_")
    return f"mvtpu_{base}{suffix}"


# per-shard series names (ROUTER_SHARD3_SECONDS, FLEET_SHARD0_REPLICA_LAG)
# collapse into one labeled Prometheus family: the shard index moves from
# the metric name into a shard="3" label, so operators aggregate and
# alert across shards without a regex in every query
_SHARD_SERIES = re.compile(
    r"^(?P<pre>.+?)_SHARD(?P<idx>\d+)(?P<post>(?:_[A-Za-z0-9_]+)?)$")


def _split_shard(name: str):
    """``NAME_SHARD<k>_X`` -> (``NAME_X``, "k"); others -> (name, None)."""
    m = _SHARD_SERIES.match(name)
    if m is None:
        return name, None
    return m.group("pre") + m.group("post"), m.group("idx")


# per-tenant counter families (admission + chargeback planes) collapse
# the same way: TENANT_ctr_SHED becomes mvtpu_tenant_shed_total with a
# tenant="ctr" label. The suffix alternation is anchored so tenant names
# containing underscores (including "_default") split unambiguously.
_TENANT_SERIES = re.compile(
    r"^TENANT_(?P<tenant>.+)_(?P<suffix>ADMITTED|SHED|BYTES)$")


def split_tenant(name: str):
    """``TENANT_<t>_<SUFFIX>`` -> (``t``, ``SUFFIX``); others ->
    (None, None)."""
    m = _TENANT_SERIES.match(name)
    if m is None:
        return None, None
    return m.group("tenant"), m.group("suffix")


def _prom_escape(value: str) -> str:
    """Label-value escaping per the Prometheus text exposition format:
    backslash, double-quote and newline."""
    return (value.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


class Dashboard:
    """Global registry of monitors (reference: ``Dashboard::Watch/Display``)
    plus the telemetry units: counters, histograms, gauges."""

    _monitors: Dict[str, Monitor] = {}
    _counters: Dict[str, Counter] = {}
    _histograms: Dict[str, Histogram] = {}
    _gauges: Dict[str, Gauge] = {}
    _lock = threading.Lock()
    profile_annotations: bool = False

    @classmethod
    def get(cls, name: str) -> Monitor:
        with cls._lock:
            mon = cls._monitors.get(name)
            if mon is None:
                mon = cls._monitors[name] = Monitor(name)
            return mon

    @classmethod
    def watch(cls, name: str) -> Optional[Monitor]:
        with cls._lock:
            return cls._monitors.get(name)

    @classmethod
    def counter(cls, name: str) -> Counter:
        with cls._lock:
            ctr = cls._counters.get(name)
            if ctr is None:
                ctr = cls._counters[name] = Counter(name)
            return ctr

    @classmethod
    def counter_value(cls, name: str) -> int:
        """Current count; 0 when the counter was never touched."""
        with cls._lock:
            ctr = cls._counters.get(name)
        return ctr.value if ctr is not None else 0

    @classmethod
    def histogram(cls, name: str, bounds=None):
        """Log-bucketed latency histogram (obs/metrics.py); created on
        first use like monitors/counters. ``bounds`` applies only at
        creation — count-valued histograms (rows per fused apply) pass
        unit-based geometric edges instead of the 1µs latency default,
        whose top edge (~134) they would overflow."""
        with cls._lock:
            hist = cls._histograms.get(name)
            if hist is None:
                hist = cls._histograms[name] = Histogram(name, bounds=bounds)
            return hist

    @classmethod
    def gauge(cls, name: str):
        with cls._lock:
            g = cls._gauges.get(name)
            if g is None:
                g = cls._gauges[name] = Gauge(name)
            return g

    @classmethod
    def gauge_value(cls, name: str) -> float:
        with cls._lock:
            g = cls._gauges.get(name)
        return g.value if g is not None else 0.0

    @classmethod
    def snapshot(cls) -> dict:
        """The whole registry as plain JSON-serializable data — the stats
        RPC payload, the metrics JSONL line, and the flight-recorder
        snapshot all share this one format."""
        with cls._lock:
            monitors = list(cls._monitors.values())
            counters = list(cls._counters.values())
            histograms = list(cls._histograms.values())
            gauges = list(cls._gauges.values())
        return {
            "monitors": {m.name: {"count": m.count,
                                  "elapse_ms": m.elapse_ms,
                                  "average_ms": m.average_ms}
                         for m in monitors},
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.to_dict() for h in histograms},
        }

    @classmethod
    def render(cls, format: str = "text") -> str:
        """Operator-facing dump (returned, never printed; ``display()``
        keeps the reference's print-and-return contract).

        ``format="text"``: aligned monitor/counter/gauge/histogram tables
        an operator can read off a log or a debug endpoint.
        ``format="prom"``: Prometheus text exposition (counters/gauges/
        histograms with cumulative ``_bucket{le=...}`` rows) for scrape
        endpoints and pushgateways."""
        if format == "prom":
            return cls._render_prom()
        if format != "text":
            raise ValueError(f"render: unknown format {format!r} "
                             "(want 'text' or 'prom')")
        with cls._lock:
            monitors = list(cls._monitors.values())
            counters = list(cls._counters.values())
            histograms = list(cls._histograms.values())
            gauges = list(cls._gauges.values())
        lines = ["== dashboard =="]
        if monitors:
            lines.append(f"{'section':<36} {'count':>10} {'total_ms':>12} "
                         f"{'avg_ms':>10}")
            for m in monitors:
                lines.append(f"{m.name:<36} {m.count:>10} "
                             f"{m.elapse_ms:>12.3f} {m.average_ms:>10.3f}")
        if counters:
            lines.append(f"{'counter':<36} {'value':>10}")
            for c in counters:
                lines.append(f"{c.name:<36} {c.value:>10}")
        if gauges:
            lines.append(f"{'gauge':<36} {'value':>10}")
            for g in gauges:
                lines.append(f"{g.name:<36} {g.value:>10g}")
        if histograms:
            lines.append(f"{'histogram':<36} {'count':>8} {'p50_ms':>10} "
                         f"{'p95_ms':>10} {'p99_ms':>10} {'max_ms':>10}")
            for h in histograms:
                lines.append(f"{h.name:<36} {h.count:>8} "
                             f"{h.p50 * 1e3:>10.3f} {h.p95 * 1e3:>10.3f} "
                             f"{h.p99 * 1e3:>10.3f} {h.max * 1e3:>10.3f}")
        if not (monitors or counters or gauges or histograms):
            lines.append("(no monitors or counters recorded)")
        return "\n".join(lines)

    @classmethod
    def identity(cls) -> Dict[str, str]:
        """This process's fleet identity as Prometheus labels, from the
        ``metrics_shard`` / ``metrics_role`` flags (set by ``mv.serve``,
        shard-group children and replicas at startup). Empty when
        neither is set — single-process dashboards stay label-free."""
        from multiverso_tpu_torch import config
        labels: Dict[str, str] = {}
        try:
            shard = int(config.get_flag("metrics_shard"))
            role = str(config.get_flag("metrics_role"))
        except Exception:  # noqa: BLE001 — render before flag definition
            return labels
        if shard >= 0:
            labels["shard"] = str(shard)
        if role:
            labels["role"] = role
        return labels

    @classmethod
    def set_identity(cls, shard: Optional[int] = None,
                     role: Optional[str] = None) -> None:
        """Stamp the process's fleet identity (flag-backed, so a
        dashboard reset does not lose it)."""
        from multiverso_tpu_torch import config
        if shard is not None:
            config.set_flag("metrics_shard", int(shard))
        if role is not None:
            config.set_flag("metrics_role", str(role))

    @classmethod
    def _render_prom(cls) -> str:
        with cls._lock:
            monitors = list(cls._monitors.values())
            counters = list(cls._counters.values())
            histograms = list(cls._histograms.values())
            gauges = list(cls._gauges.values())
        ident = cls.identity()

        def lab(shard: Optional[str], le: Optional[str] = None,
                tenant: Optional[str] = None) -> str:
            labels = dict(ident)
            if shard is not None:
                # a per-shard series names its OWN shard — it wins over
                # the process identity (a launcher holding the fleet's
                # ROUTER_SHARD<k> series has no shard identity anyway)
                labels["shard"] = shard
            if tenant is not None:
                labels["tenant"] = tenant
            parts = [f'{k}="{_prom_escape(v)}"'
                     for k, v in sorted(labels.items())]
            if le is not None:
                parts.append(f'le="{le}"')
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: list = []
        typed = set()

        def head(n: str, kind: str) -> None:
            # one # TYPE line per family — shard-labeled series of one
            # family share it
            if n not in typed:
                typed.add(n)
                lines.append(f"# TYPE {n} {kind}")

        for c in counters:
            tenant, suffix = split_tenant(c.name)
            if tenant is not None:
                n = _prom_name(f"TENANT_{suffix}")
                head(n, "counter")
                lines.append(
                    f"{n}_total{lab(None, tenant=tenant)} {c.value}")
                continue
            family, shard = _split_shard(c.name)
            n = _prom_name(family)
            head(n, "counter")
            lines.append(f"{n}_total{lab(shard)} {c.value}")
        for g in gauges:
            family, shard = _split_shard(g.name)
            n = _prom_name(family)
            head(n, "gauge")
            lines.append(f"{n}{lab(shard)} {g.value:g}")
        for m in monitors:
            family, shard = _split_shard(m.name)
            n = _prom_name(family)
            head(f"{n}_seconds", "summary")
            lines.append(f"{n}_seconds_sum{lab(shard)} "
                         f"{m.elapse_ms / 1e3:.9g}")
            lines.append(f"{n}_seconds_count{lab(shard)} {m.count}")
        for h in histograms:
            family, shard = _split_shard(h.name)
            n = _prom_name(family)
            data = h.to_dict()
            head(n, "histogram")
            cum = 0
            for bound, bucket in zip(data["bounds"], data["buckets"]):
                cum += bucket
                lines.append(
                    f'{n}_bucket{lab(shard, le=f"{bound:.9g}")} {cum}')
            lines.append(f'{n}_bucket{lab(shard, le="+Inf")} '
                         f'{data["count"]}')
            lines.append(f"{n}_sum{lab(shard)} {data['sum']:.9g}")
            lines.append(f"{n}_count{lab(shard)} {data['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    @classmethod
    def display(cls) -> str:
        with cls._lock:
            lines = ["--------------Dashboard--------------------"]
            lines.extend(repr(m) for m in cls._monitors.values())
            lines.extend(repr(c) for c in cls._counters.values())
            lines.extend(repr(g) for g in cls._gauges.values())
            lines.extend(repr(h) for h in cls._histograms.values())
        # the "why is it slow" panel rides along once the sampling
        # profiler has data (rendered OUTSIDE the registry lock)
        from multiverso_tpu_torch.obs.profiler import PROFILER
        if PROFILER.samples:
            lines.append(PROFILER.render())
        text = "\n".join(lines)
        print(text, flush=True)
        return text

    @classmethod
    def reset(cls) -> None:
        """Zero every registered object IN PLACE. Clearing the dicts
        instead would orphan cached references: a module that held on to
        ``Dashboard.counter("X")`` would keep bumping an object no longer
        in the registry while readers see a fresh zero forever."""
        with cls._lock:
            objs = (list(cls._monitors.values())
                    + list(cls._counters.values())
                    + list(cls._histograms.values())
                    + list(cls._gauges.values()))
        for obj in objs:
            obj.reset()


@contextmanager
def monitor(name: str) -> Iterator[Monitor]:
    """``MONITOR_BEGIN(name) ... MONITOR_END(name)`` as a context manager.
    The duration feeds BOTH the monitor (count/total/average) and the
    same-named histogram (p50/p95/p99) — every timed section gets a
    distribution for free. Timing is a local on the caller's stack, so
    overlapping scopes on any thread mix cannot corrupt each other."""
    mon = Dashboard.get(name)
    t0 = time.perf_counter()
    ann = None
    if Dashboard.profile_annotations:
        from torch.profiler import record_function
        ann = record_function(name)
        ann.__enter__()
    try:
        yield mon
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        dt = time.perf_counter() - t0
        mon.observe(dt)
        Dashboard.histogram(name).observe(dt)


def count(name: str, n: int = 1) -> None:
    """Bump a named event counter (``Dashboard.counter(name).add(n)``)."""
    Dashboard.counter(name).add(n)


def observe(name: str, seconds: float) -> None:
    """Record one sample into a named histogram."""
    Dashboard.histogram(name).observe(seconds)


def gauge_set(name: str, value: float) -> None:
    """Set a named gauge (last writer wins)."""
    Dashboard.gauge(name).set(value)


def gauge_add(name: str, delta: float = 1.0) -> None:
    """Atomically add to a named gauge."""
    Dashboard.gauge(name).add(delta)


class Timer:
    """Chrono stopwatch in ms (reference: ``util/timer.h``)."""

    def __init__(self) -> None:
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def elapse_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3
