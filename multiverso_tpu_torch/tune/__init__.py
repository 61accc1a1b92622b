"""Self-tuning runtime: a feedback controller over the perf knobs (port
of ``multiverso_tpu/tune/__init__.py``).

r06–r13 kept proving the fixed-posture problem: coalescing, shm
polling, hedging and batch fusion each lose on a 1-core host and win on
TPU hosts, so no static setting of the perf flags is right across a
heterogeneous fleet. This package closes the loop the observability
plane made possible — PR 12's wait-site profiler and critical-path
attribution name WHICH knob is the bottleneck; the
:class:`KnobController` acts on it:

    sense   -> one TuneSense fusion (wait-site deltas + windowed rates
               + latency quantiles + optional fleet attribution)
    propose -> the rule table's first matching, non-pinned knob step,
               gated by the autopilot's hysteresis/cooldown pattern
    step    -> set_flag through the config watch seam — the hot paths
               re-read live, no restart
    verify  -> after ``autotune_verify_ticks`` windows, compare the
               objective (throughput-weighted p99) against the
               pre-step baseline; REVERT on regression beyond
               ``autotune_regress_pct``, commit otherwise

Safety posture (docs/autotune.md):

* default OFF (``autotune`` flag): no thread, no TUNE_* metrics, the
  runtime is bit-identical to an untuned build;
* one step in flight at a time — the verify window measures exactly
  one change;
* the tuner PAUSES while the autopilot is frozen (AUDIT_DIVERGENCE
  latched) or mid-action (AUTOPILOT_ACTION_INFLIGHT): two controllers
  must not fight, and an objective window that spans a fleet reshape
  would judge the reshape, not the knob;
* every step, measurement, revert and commit lands in the flight
  recorder — the audit trail reconstructs the tuner's entire life.

``mvt.autotune()`` returns the flag-started controller; ``tick_now()``
is the deterministic seam tests and bench drills drive.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import Dashboard, count, gauge_set
from multiverso_tpu_torch.obs.trace import flight_dump
from multiverso_tpu_torch.tune.rules import KnobStep, Rule, default_rules
from multiverso_tpu_torch.tune.sensors import TuneSense, TuneSensors

__all__ = ["KnobController", "KnobStep", "Rule", "TuneSense",
           "TuneSensors", "default_rules"]


class _InflightStep:
    """One knob change awaiting verification."""

    __slots__ = ("rule", "flag", "old", "new", "baseline", "reason",
                 "ticks_waited")

    def __init__(self, rule: str, flag: str, old: Any, new: Any,
                 baseline: float, reason: str) -> None:
        self.rule = rule
        self.flag = flag
        self.old = old
        self.new = new
        self.baseline = baseline
        self.reason = reason
        self.ticks_waited = 0

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "flag": self.flag,
                "old": self.old, "new": self.new,
                "baseline": round(self.baseline, 3),
                "reason": self.reason,
                "ticks_waited": self.ticks_waited}


class KnobController:
    """The windowed sense→propose→step→verify loop (module docstring).

    Components are injectable for tests (synthetic sensors, custom rule
    tables, a fake clock via ``tick_now(now=...)``); defaults read the
    ``autotune_*`` flags and the global telemetry plane. ``interval``
    <= 0 builds the loop without a thread — ``tick_now()`` drives it."""

    def __init__(self, sensors: Optional[TuneSensors] = None,
                 rules: Optional[List[Rule]] = None,
                 interval: Optional[float] = None,
                 hysteresis: Optional[int] = None,
                 cooldown: Optional[float] = None,
                 verify_ticks: Optional[int] = None,
                 regress_pct: Optional[float] = None) -> None:
        self.sensors = sensors if sensors is not None else TuneSensors()
        self.rules = rules if rules is not None else default_rules()
        self.interval = float(
            interval if interval is not None
            else config.get_flag("autotune_interval_seconds"))
        self.hysteresis = int(
            hysteresis if hysteresis is not None
            else config.get_flag("autotune_hysteresis_ticks"))
        self.cooldown = float(
            cooldown if cooldown is not None
            else config.get_flag("autotune_cooldown_seconds"))
        self.verify_ticks = max(1, int(
            verify_ticks if verify_ticks is not None
            else config.get_flag("autotune_verify_ticks")))
        self.regress_pct = float(
            regress_pct if regress_pct is not None
            else config.get_flag("autotune_regress_pct"))
        self._streaks: Dict[str, int] = {r.name: 0 for r in self.rules}
        self._cooldown_until: Dict[str, float] = {}
        self._inflight: Optional[_InflightStep] = None
        self.ticks = 0
        self.steps = 0
        self.reverts = 0
        self.commits = 0
        self.history: Deque[Dict[str, Any]] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- pause signals -------------------------------------------------------
    @staticmethod
    def _paused_by() -> Optional[str]:
        """Why tuning must not run this tick (None = clear to tune)."""
        if Dashboard.gauge_value("AUTOPILOT_FROZEN") > 0:
            return "autopilot interlock frozen"
        if Dashboard.gauge_value("AUTOPILOT_ACTION_INFLIGHT") > 0:
            return "autopilot action in flight"
        return None

    # -- one tick ------------------------------------------------------------
    def tick_now(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full controller cycle — the deterministic seam. Returns
        the tick record (also appended to ``history``)."""
        self.ticks += 1
        count("TUNE_TICKS")
        now = float(now if now is not None else time.time())
        record: Dict[str, Any] = {"tick": self.ticks, "now": now}
        paused = self._paused_by()
        if paused is not None:
            # the in-flight step (if any) keeps waiting: its verify
            # window must not span another controller's action
            count("TUNE_PAUSED_TICKS")
            record.update(action="paused", reason=paused)
            self.history.append(record)
            return record
        sense = self.sensors.read(now=now)
        gauge_set("TUNE_OBJECTIVE", sense.objective)
        record["sense"] = sense.as_dict()
        if self._inflight is not None:
            self._verify(sense, now, record)
        else:
            self._propose(sense, now, record)
        self.history.append(record)
        return record

    # -- propose + step ------------------------------------------------------
    def _gate(self, rule: Rule, reason: Optional[str], now: float,
              rejected: List[Dict[str, str]]) -> bool:
        """The autopilot's streak/cooldown gate, per rule: True when the
        rule may step this tick; barred matches are recorded."""
        if reason is None:
            self._streaks[rule.name] = 0
            return False
        self._streaks[rule.name] += 1
        if self._streaks[rule.name] < self.hysteresis:
            rejected.append(
                {"rule": rule.name,
                 "reason": f"{reason}; hysteresis "
                           f"{self._streaks[rule.name]}/{self.hysteresis}"})
            return False
        return True

    def _propose(self, sense: TuneSense, now: float,
                 record: Dict[str, Any]) -> None:
        rejected: List[Dict[str, str]] = []
        for rule in self.rules:
            reason = rule.predicate(sense)
            if not self._gate(rule, reason, now, rejected):
                continue
            stepped = False
            for knob in rule.steps:
                until = self._cooldown_until.get(knob.flag, 0.0)
                if until > now:
                    rejected.append(
                        {"rule": rule.name,
                         "reason": f"{reason}; {knob.flag} cooling "
                                   f"down {until - now:.1f}s"})
                    continue
                old = config.get_flag(knob.flag)
                new = knob.propose(old, sense)
                if new is None:
                    rejected.append(
                        {"rule": rule.name,
                         "reason": f"{reason}; {knob.flag}={old} "
                                   "pinned at its bound"})
                    continue
                self._step(rule, knob, old, new, sense, reason, record)
                stepped = True
                break
            if stepped:
                return
        record.setdefault("action", "none")
        record["rejected"] = rejected

    def _step(self, rule: Rule, knob: KnobStep, old: Any, new: Any,
              sense: TuneSense, reason: str,
              record: Dict[str, Any]) -> None:
        config.set_flag(knob.flag, new)
        applied = config.get_flag(knob.flag)  # post-coercion value
        self.steps += 1
        count("TUNE_STEPS")
        gauge_set(f"TUNE_{knob.flag.upper()}", float(applied))
        self._streaks[rule.name] = 0
        self._inflight = _InflightStep(rule.name, knob.flag, old,
                                       applied, sense.objective, reason)
        record.update(action="step", step=self._inflight.as_dict())
        flight_dump("tune_step", rule=rule.name, flag=knob.flag,
                    old=old, new=applied, why=reason,
                    baseline=sense.objective, sense=sense.as_dict())
        log.info("autotune: %s -> %s (was %s): %s",
                 knob.flag, applied, old, reason)

    # -- verify --------------------------------------------------------------
    def _verify(self, sense: TuneSense, now: float,
                record: Dict[str, Any]) -> None:
        step = self._inflight
        step.ticks_waited += 1
        if step.ticks_waited < self.verify_ticks:
            record.update(action="verify_wait", step=step.as_dict())
            return
        objective = sense.objective
        bar = step.baseline * (1.0 - self.regress_pct / 100.0)
        regressed = step.baseline > 0 and objective < bar
        self._cooldown_until[step.flag] = now + self.cooldown
        self._inflight = None
        verdict = {"rule": step.rule, "flag": step.flag,
                   "old": step.old, "new": step.new,
                   "baseline": round(step.baseline, 3),
                   "objective": round(objective, 3),
                   "regress_bar": round(bar, 3)}
        if regressed:
            config.set_flag(step.flag, step.old)
            self.reverts += 1
            count("TUNE_REVERTS")
            gauge_set(f"TUNE_{step.flag.upper()}", float(step.old))
            record.update(action="revert", verdict=verdict)
            flight_dump("tune_revert", **verdict, sense=sense.as_dict())
            log.info("autotune: REVERT %s -> %s (objective %.1f < "
                     "baseline %.1f - %.0f%%)", step.flag, step.old,
                     objective, step.baseline, self.regress_pct)
        else:
            self.commits += 1
            count("TUNE_COMMITS")
            record.update(action="commit", verdict=verdict)
            flight_dump("tune_commit", **verdict, sense=sense.as_dict())
            log.info("autotune: commit %s=%s (objective %.1f vs "
                     "baseline %.1f)", step.flag, step.new, objective,
                     step.baseline)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "KnobController":
        if self.interval <= 0:
            log.fatal("KnobController.start needs "
                      "autotune_interval_seconds > 0 (or interval=); "
                      "use tick_now() for drills")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-autotune")
        self._thread.start()
        log.debug("autotune: controller started (every %.1fs, %d-tick "
                  "verify)", self.interval, self.verify_ticks)
        return self

    def _run(self) -> None:
        while not self._stop.wait(max(0.05, self.interval)):
            try:
                self.tick_now()
            except Exception as exc:  # noqa: BLE001 — the controller
                # must outlive any single bad tick
                log.error("autotune: tick failed: %r", exc)

    def abort_inflight(self, why: str = "controller stopped") -> bool:
        """Revert an unverified in-flight step, if any. A step that was
        never judged must not outlive the controller as silent live
        state — the audit trail would end mid-experiment. Returns True
        when a step was aborted."""
        step, self._inflight = self._inflight, None
        if step is None:
            return False
        config.set_flag(step.flag, step.old)
        self.reverts += 1
        count("TUNE_REVERTS")
        gauge_set(f"TUNE_{step.flag.upper()}", float(step.old))
        flight_dump("tune_revert", rule=step.rule, flag=step.flag,
                    old=step.old, new=step.new,
                    baseline=round(step.baseline, 3), aborted=True,
                    why=why)
        log.info("autotune: ABORT unverified %s -> %s (%s)",
                 step.flag, step.old, why)
        return True

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
        self.abort_inflight()

    # -- operator surface ----------------------------------------------------
    def status(self) -> Dict[str, Any]:
        now = time.time()
        return {"running": (self._thread is not None
                            and self._thread.is_alive()),
                "ticks": self.ticks, "steps": self.steps,
                "reverts": self.reverts, "commits": self.commits,
                "inflight": (self._inflight.as_dict()
                             if self._inflight is not None else None),
                "streaks": dict(self._streaks),
                "cooldowns": {f: round(t - now, 3)
                              for f, t in self._cooldown_until.items()
                              if t > now},
                "recent": list(self.history)[-8:]}
