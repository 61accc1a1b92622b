"""SLO burn-rate engine + the live fleet view (``mvt.top``; port of
``multiverso_tpu/obs/slo.py``).

An SLO here is a declarative objective over one dashboard metric:

* ``histogram`` — a windowed quantile must stay under a latency target
  (Get p99 < 50 ms);
* ``counter`` — a windowed rate must stay under an events-per-second
  target (retries < 1/s);
* ``gauge`` — the sampled value must stay under a level target
  (replica lag < 1000 records, WAL backlog < 64 MiB).

**Burn rate** is how fast the objective's error budget is being spent:
``burn = observed / target``. 1.0 means exactly on budget; 2.0 means
the budget burns twice as fast as it accrues. The engine evaluates each
objective over TWO windows (``windows=SHORT/LONG`` in the spec,
seconds) and fires only when BOTH exceed the burn threshold — the
multi-window rule from the SRE workbook: the short window proves the
problem is happening *now*, the long window proves it is not a blip, so
alerts are both fast and flap-free.

Firing is edge-triggered: on the False→True transition the engine bumps
``SLO_BURN_ALERTS`` and writes a flight-recorder dump tagged
``slo_burn`` (the last N traces + a dashboard snapshot land next to the
alert, so the on-call starts with evidence, not a blank terminal).
Recovery (True→False) is logged but never dumps.

Objectives come from the ``slo_spec`` flag —

    name:histogram=H,p=0.99,target=SEC[,windows=S/L][,burn=B]
    name:counter=C,target=PER_SEC[,...]  name:gauge=G,target=VALUE[,...]

';'-separated — or, when the flag is empty, :func:`default_objectives`
covers the paper system's four canonical SLIs (Get p99, retry rate,
replica lag, WAL backlog).

``mvt.top`` (:func:`fleet_top`) is the operator's live view: one
stats+watermark probe per endpoint, rendered as a terminal table (or
HTML with ``format="html"``) of per-process roles, rates, lag and the
local engine's burn status.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count
from multiverso_tpu_torch.obs.timeseries import TIMESERIES, TimeSeriesRecorder
from multiverso_tpu_torch.obs.trace import flight_dump

_KINDS = ("histogram", "counter", "gauge")


@dataclass
class Objective:
    """One declarative SLO (module docstring for the semantics)."""

    name: str
    kind: str           # histogram | counter | gauge
    metric: str
    target: float
    quantile: float = 0.99            # histogram kind only
    windows: Tuple[float, float] = (60.0, 300.0)  # (short, long) s
    burn_threshold: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"SLO {self.name!r}: unknown kind "
                             f"{self.kind!r} (want {'|'.join(_KINDS)})")
        if self.target <= 0:
            raise ValueError(f"SLO {self.name!r}: target must be > 0")


@dataclass
class Evaluation:
    """One objective's state at one evaluation instant."""

    objective: Objective
    value_short: float
    value_long: float
    firing: bool
    burn_short: float = field(init=False)
    burn_long: float = field(init=False)

    def __post_init__(self) -> None:
        self.burn_short = self.value_short / self.objective.target
        self.burn_long = self.value_long / self.objective.target


def parse_slo_spec(spec: str) -> List[Objective]:
    """Parse the ``slo_spec`` flag syntax; raises ValueError loudly on a
    malformed clause (a silently-dropped SLO is an unwatched fleet)."""
    objectives: List[Objective] = []
    for clause in str(spec).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        name, sep, body = clause.partition(":")
        if not sep or not name.strip():
            raise ValueError(f"slo_spec clause {clause!r}: want "
                             "'name:kind=METRIC,target=...'")
        kind = metric = None
        kwargs: Dict[str, Any] = {}
        for item in body.split(","):
            key, sep, value = item.strip().partition("=")
            if not sep:
                raise ValueError(f"slo_spec clause {clause!r}: "
                                 f"item {item!r} is not key=value")
            key = key.strip()
            value = value.strip()
            if key in _KINDS:
                kind, metric = key, value
            elif key == "p":
                kwargs["quantile"] = float(value)
            elif key == "target":
                kwargs["target"] = float(value)
            elif key == "burn":
                kwargs["burn_threshold"] = float(value)
            elif key == "windows":
                short, sep, long_ = value.partition("/")
                kwargs["windows"] = (float(short),
                                     float(long_) if sep else
                                     float(short) * 5.0)
            else:
                raise ValueError(f"slo_spec clause {clause!r}: "
                                 f"unknown key {key!r}")
        if kind is None or "target" not in kwargs:
            raise ValueError(f"slo_spec clause {clause!r}: needs a "
                             "kind=METRIC item and a target")
        objectives.append(Objective(name=name.strip(), kind=kind,
                                    metric=metric, **kwargs))
    return objectives


def default_objectives() -> List[Objective]:
    """The four canonical SLIs of this system, with lenient targets —
    operators tighten via ``slo_spec``; these exist so a bare fleet is
    never unwatched."""
    return [
        Objective(name="get_p99", kind="histogram",
                  metric="CLIENT_REQUEST_SECONDS", quantile=0.99,
                  target=0.250),
        Objective(name="retry_rate", kind="counter",
                  metric="CLIENT_RETRIES", target=5.0),
        Objective(name="replica_lag", kind="gauge",
                  metric="REPLICA_LAG_RECORDS", target=10_000.0),
        Objective(name="wal_backlog", kind="gauge",
                  metric="WAL_BACKLOG_BYTES", target=256 * 1024 * 1024),
    ]


class SLOEngine:
    """Evaluates objectives against a :class:`TimeSeriesRecorder` on a
    timer (``slo_check_interval_seconds``); ``evaluate_now()`` is the
    deterministic seam chaos tests drive directly."""

    def __init__(self, recorder: TimeSeriesRecorder = TIMESERIES,
                 objectives: Optional[Sequence[Objective]] = None) -> None:
        self.recorder = recorder
        if objectives is None:
            spec = str(config.get_flag("slo_spec"))
            objectives = (parse_slo_spec(spec) if spec.strip()
                          else default_objectives())
        self.objectives: List[Objective] = list(objectives)
        self._firing: Dict[str, bool] = {}
        self._firing_since: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last: List[Evaluation] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-slo")
        self._thread.start()
        # debug, not info: fires inside every mv.init, which must not write
        # to stdout before a server child's "serving ..." readiness marker
        log.debug("slo: watching %d objective(s): %s",
                  len(self.objectives),
                  ", ".join(o.name for o in self.objectives))

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    def _run(self) -> None:
        interval = float(config.get_flag("slo_check_interval_seconds"))
        while not self._stop.wait(max(0.05, interval)):
            try:
                self.evaluate_now()
            except Exception as exc:  # noqa: BLE001 — the watcher must
                # outlive any single bad evaluation
                log.error("slo: evaluation failed: %r", exc)

    # -- evaluation ----------------------------------------------------------
    def _value(self, obj: Objective, window: float) -> float:
        if obj.kind == "histogram":
            return self.recorder.quantile(obj.metric, obj.quantile,
                                          window)
        if obj.kind == "counter":
            return self.recorder.rate(obj.metric, window)
        return self.recorder.gauge(obj.metric)

    def evaluate_now(self) -> List[Evaluation]:
        """Evaluate every objective against the recorder's CURRENT
        rings (callers sample first — the engine never sleeps here)."""
        evals: List[Evaluation] = []
        for obj in self.objectives:
            short_w, long_w = obj.windows
            v_short = self._value(obj, short_w)
            v_long = self._value(obj, long_w)
            firing = (v_short > obj.target * obj.burn_threshold
                      and v_long > obj.target * obj.burn_threshold)
            ev = Evaluation(objective=obj, value_short=v_short,
                            value_long=v_long, firing=firing)
            was = self._firing.get(obj.name, False)
            self._firing[obj.name] = firing
            if firing and not was:
                self._firing_since[obj.name] = time.time()
                count("SLO_BURN_ALERTS")
                log.error("slo: %s BURNING — short=%.6g long=%.6g "
                          "target=%.6g (burn %.2fx/%.2fx)", obj.name,
                          v_short, v_long, obj.target, ev.burn_short,
                          ev.burn_long)
                # objective_kind, not kind= — the recorder's own "kind"
                # field discriminates event/snapshot/trace lines
                details = dict(slo=obj.name,
                               objective_kind=obj.kind,
                               metric=obj.metric, target=obj.target,
                               value_short=v_short, value_long=v_long,
                               burn_short=ev.burn_short,
                               burn_long=ev.burn_long)
                if bool(config.get_flag("profile_on_alert")):
                    # every slo_burn dump ships a "why": the continuous
                    # profiler's report, or a short burst on cold
                    # processes (capture failure must not eat the alert)
                    try:
                        from multiverso_tpu_torch.obs.profiler import \
                            capture_for_alert
                        details["profile"] = capture_for_alert()
                    except Exception:  # noqa: BLE001
                        pass
                flight_dump("slo_burn", **details)
            elif was and not firing:
                self._firing_since.pop(obj.name, None)
                log.info("slo: %s recovered (short=%.6g target=%.6g)",
                         obj.name, v_short, obj.target)
            evals.append(ev)
        self.last = evals
        return evals

    def firing(self) -> List[str]:
        return [name for name, on in self._firing.items() if on]

    def is_firing(self, name: str) -> bool:
        """Is objective ``name`` currently burning? (queryable state the
        autopilot's sensors read instead of parsing dumps)"""
        return bool(self._firing.get(name, False))

    def status(self) -> Dict[str, Any]:
        """The engine's queryable state: per-objective last evaluation
        plus firing/since — the machine-readable twin of render()."""
        objectives = []
        for ev in self.last:
            o = ev.objective
            objectives.append({
                "name": o.name, "kind": o.kind, "metric": o.metric,
                "target": o.target, "value_short": ev.value_short,
                "value_long": ev.value_long, "burn_short": ev.burn_short,
                "burn_long": ev.burn_long, "firing": ev.firing,
                "firing_since": self._firing_since.get(o.name)})
        return {"firing": self.firing(), "objectives": objectives}

    def render(self) -> str:
        """One line per objective — the ``mvt.top`` SLO panel."""
        if not self.last:
            return "(no SLO evaluations yet)"
        lines = [f"{'slo':<16} {'kind':<10} {'short':>12} {'long':>12} "
                 f"{'target':>12} {'burn':>7} {'state':<8}"]
        for ev in self.last:
            o = ev.objective
            state = "BURNING" if ev.firing else "ok"
            lines.append(f"{o.name:<16} {o.kind:<10} "
                         f"{ev.value_short:>12.6g} {ev.value_long:>12.6g} "
                         f"{o.target:>12.6g} {ev.burn_short:>6.2f}x "
                         f"{state:<8}")
        return "\n".join(lines)


# -- the live fleet view (mv.top) ---------------------------------------------

def _probe_fleet(endpoints: Sequence[str],
                 timeout: float) -> List[Dict[str, Any]]:
    """One stats + one watermark probe per endpoint, concurrently;
    unreachable endpoints report as such instead of failing the view."""
    from multiverso_tpu_torch.runtime.remote import fetch_stats, fetch_watermark
    rows: List[Optional[Dict[str, Any]]] = [None] * len(endpoints)

    def probe(i: int, ep: str) -> None:
        row: Dict[str, Any] = {"endpoint": ep}
        try:
            wm = fetch_watermark(ep, timeout=timeout)
            row.update(role=str(wm.get("role", "?")),
                       watermark=int(wm.get("watermark", -1)),
                       lag=int(wm.get("lag", 0) or 0))
        except (OSError, RuntimeError):
            row.update(role="unreachable", watermark=-1, lag=-1)
            rows[i] = row
            return
        try:
            stats = fetch_stats(ep, timeout=timeout)
            gets = (stats.counter("READS_SERVED_PRIMARY")
                    + stats.counter("READS_SERVED_REPLICA"))
            get_hist = stats.histogram("SERVER_PROCESS_GET_MSG")
            add_hist = stats.histogram("SERVER_PROCESS_ADD_MSG")
            row.update(
                gets=gets,
                adds=add_hist.count if add_hist is not None else 0,
                get_p99_ms=(get_hist.p99 * 1e3
                            if get_hist is not None else 0.0),
                dumps=stats.counter("FLIGHT_DUMPS"),
                alerts=stats.counter("SLO_BURN_ALERTS"))
        except (OSError, RuntimeError):
            pass  # watermark answered; render the partial row
        rows[i] = row

    threads = [threading.Thread(target=probe, args=(i, ep), daemon=True,
                                name="mv-top-probe")
               for i, ep in enumerate(endpoints)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 1.0)
    return [r if r is not None
            else {"endpoint": endpoints[i], "role": "unreachable",
                  "watermark": -1, "lag": -1}
            for i, r in enumerate(rows)]


def fleet_top(endpoints: Sequence[str],
              engine: Optional[SLOEngine] = None,
              timeout: Optional[float] = None,
              format: str = "text") -> str:
    """Render the live fleet view (``mvt.top``): one row per serving
    endpoint (role, watermark, lag, served Gets/Adds, server-side Get
    p99, flight dumps, burn alerts) plus the local SLO panel.
    ``format`` is ``text`` (terminal) or ``html`` (a self-contained
    page for a browser tab an operator leaves open)."""
    t = float(timeout if timeout is not None
              else config.get_flag("stats_timeout_seconds"))
    rows = _probe_fleet(list(endpoints), t)
    if format == "html":
        return _render_html(rows, engine)
    if format != "text":
        raise ValueError(f"fleet_top: unknown format {format!r} "
                         "(want 'text' or 'html')")
    cols = (f"{'endpoint':<24} {'role':<12} {'wmark':>8} {'lag':>6} "
            f"{'gets':>9} {'adds':>9} {'p99_ms':>9} {'dumps':>6} "
            f"{'alerts':>7}")
    lines = [f"== mv.top @ {time.strftime('%H:%M:%S')} "
             f"({len(rows)} endpoint(s)) ==", cols]
    for r in rows:
        lines.append(
            f"{r['endpoint']:<24} {r.get('role', '?'):<12} "
            f"{r.get('watermark', -1):>8} {r.get('lag', -1):>6} "
            f"{r.get('gets', 0):>9} {r.get('adds', 0):>9} "
            f"{r.get('get_p99_ms', 0.0):>9.3f} {r.get('dumps', 0):>6} "
            f"{r.get('alerts', 0):>7}")
    lines.append("")
    lines.append(engine.render() if engine is not None
                 else "(no SLO engine attached — pass engine=)")
    tenant_panel = _render_tenants()
    if tenant_panel:
        lines.append("")
        lines.append(tenant_panel)
    return "\n".join(lines)


def _render_tenants(window: float = 30.0) -> str:
    """The per-tenant rate panel (chargeback plane): windowed admit and
    shed rates out of the local ``TENANT_<t>_*`` series. Empty string
    when no tenant traffic was ever recorded — single-tenant fleets keep
    today's mv.top byte-for-byte."""
    from multiverso_tpu_torch.obs.timeseries import TIMESERIES
    admitted = TIMESERIES.tenant_rates("ADMITTED", window)
    shed = TIMESERIES.tenant_rates("SHED", window)
    tenants = sorted(set(admitted) | set(shed))
    if not tenants:
        return ""
    lines = [f"{'tenant':<16} {'admit/s':>9} {'shed/s':>9}"]
    for tenant in tenants:
        lines.append(f"{tenant:<16} {admitted.get(tenant, 0.0):>9.2f} "
                     f"{shed.get(tenant, 0.0):>9.2f}")
    return "\n".join(lines)


def _render_html(rows: List[Dict[str, Any]],
                 engine: Optional[SLOEngine]) -> str:
    def esc(s: Any) -> str:
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;"))

    body = ["<html><head><title>mv.top</title><style>",
            "body{font-family:monospace;background:#111;color:#ddd}",
            "table{border-collapse:collapse}",
            "td,th{border:1px solid #444;padding:4px 10px}",
            ".burn{color:#f55;font-weight:bold}.ok{color:#5f5}",
            "</style></head><body>",
            f"<h2>mv.top &mdash; {esc(time.strftime('%H:%M:%S'))}</h2>",
            "<table><tr><th>endpoint</th><th>role</th><th>watermark</th>"
            "<th>lag</th><th>gets</th><th>adds</th><th>get p99 (ms)</th>"
            "<th>dumps</th><th>alerts</th></tr>"]
    for r in rows:
        body.append(
            "<tr>" + "".join(
                f"<td>{esc(r.get(k, ''))}</td>"
                for k in ("endpoint", "role", "watermark", "lag", "gets",
                          "adds", "get_p99_ms", "dumps", "alerts"))
            + "</tr>")
    body.append("</table>")
    if engine is not None and engine.last:
        body.append("<h3>SLOs</h3><table><tr><th>slo</th><th>short</th>"
                    "<th>long</th><th>target</th><th>burn</th>"
                    "<th>state</th></tr>")
        for ev in engine.last:
            cls = "burn" if ev.firing else "ok"
            state = "BURNING" if ev.firing else "ok"
            body.append(
                f"<tr><td>{esc(ev.objective.name)}</td>"
                f"<td>{ev.value_short:.6g}</td>"
                f"<td>{ev.value_long:.6g}</td>"
                f"<td>{ev.objective.target:.6g}</td>"
                f"<td>{ev.burn_short:.2f}x</td>"
                f'<td class="{cls}">{state}</td></tr>')
        body.append("</table>")
    body.append("</body></html>")
    return "\n".join(body)
