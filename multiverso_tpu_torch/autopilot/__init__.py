"""Fleet autopilot: the control plane that acts on its own telemetry
(port of ``multiverso_tpu/autopilot/__init__.py``).

Everything this loop touches existed before it — the hot-range detector
proposes splits, the MigrationCoordinator migrates, ShardGroup grows
and shrinks replica fleets, the tiered store obeys a byte budget, the
SLO engine and the fleet auditor watch — but nothing connected sensing
to acting. The :class:`Autopilot` closes that loop on a fixed cadence:

    sense  -> one FleetSense snapshot of the telemetry plane
    decide -> the policy's single gated Decision (or "none")
    check  -> the safety interlock (any AUDIT_DIVERGENCE = frozen)
    act    -> the actuators (crash-safe machinery underneath)
    record -> decision + rejected alternatives + hysteresis/cooldown
              state + outcome, into the flight recorder

Control theory for distributed storage, sized for this codebase: Li et
al.'s dynamic server membership (OSDI'14) driven by a diurnal load
curve instead of an operator, with Dean & Barroso's hedging telemetry
as the replica-scaling signal.

Safety invariants (docs/autopilot.md):

* the interlock is consulted EVERY tick before the policy runs; frozen
  means no action, and only an operator ``ack()`` unfreezes;
* every action dispatches to machinery that already guarantees zero
  acked-Add loss on its own (migration fencing, atomic manifest
  republish) — the autopilot adds judgement, never a new write path;
* a controller death mid-action (``MV_AUTOPILOT_KILL``) latches the
  loop frozen; the fleet it leaves behind is consistent because the
  layer below was.

``mvt.autopilot(group)`` is the operator entrypoint; ``tick_now()`` is
the deterministic seam the drills and tests drive.
"""

from __future__ import annotations

import sys
import threading
import time
import types
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.autopilot.actuators import Actuators, AutopilotKilled
from multiverso_tpu_torch.autopilot.interlock import SafetyInterlock
from multiverso_tpu_torch.autopilot.policy import AutopilotPolicy, Decision
from multiverso_tpu_torch.autopilot.sensors import FleetSense, FleetSensors
from multiverso_tpu_torch.dashboard import count, gauge_set
from multiverso_tpu_torch.obs.trace import flight_dump

__all__ = ["Autopilot", "AutopilotKilled", "Actuators", "AutopilotPolicy",
           "Decision", "FleetSense", "FleetSensors", "SafetyInterlock"]


class Autopilot:
    """The periodic control loop over one live ShardGroup.

    Components are injectable (tests swap fakes in); by default the
    loop builds a HotRangeDetector over the group's shard count, a
    FleetSensors over the global recorder, and a policy/actuator pair
    from the ``autopilot_*`` flags. ``interval`` <= 0 builds the loop
    without a thread — ``tick_now()`` drives it deterministically."""

    def __init__(self, group: Any,
                 interval: Optional[float] = None,
                 recorder: Any = None,
                 engine: Any = None,
                 auditor: Any = None,
                 detector: Any = None,
                 sensors: Optional[FleetSensors] = None,
                 policy: Optional[AutopilotPolicy] = None,
                 actuators: Optional[Actuators] = None,
                 interlock: Optional[SafetyInterlock] = None) -> None:
        self.group = group
        self.interval = float(
            interval if interval is not None
            else config.get_flag("autopilot_interval_seconds"))
        if detector is None:
            from multiverso_tpu_torch.shard.reshard import HotRangeDetector
            detector = HotRangeDetector(
                group.num_shards, recorder=recorder,
                window_seconds=float(
                    config.get_flag("autopilot_window_seconds")))
        self.detector = detector
        self.sensors = sensors if sensors is not None else FleetSensors(
            group, recorder=recorder, engine=engine, auditor=auditor)
        self.policy = (policy if policy is not None
                       else AutopilotPolicy(detector))
        self.actuators = (actuators if actuators is not None
                          else Actuators(group))
        self.interlock = (interlock if interlock is not None
                          else SafetyInterlock(auditor))
        self.ticks = 0
        self.last_decision: Optional[Dict[str, Any]] = None
        # every tick's verdict stays queryable even though only real
        # decisions dump — at a 5s cadence the recorder must not fill
        # with "none" records
        self.history: Deque[Dict[str, Any]] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one tick ------------------------------------------------------------
    def tick_now(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full control cycle — the deterministic seam. Returns the
        tick record (decision + outcome + interlock state)."""
        self.ticks += 1
        count("AUTOPILOT_TICKS")
        now = float(now if now is not None else time.time())
        record: Dict[str, Any] = {"tick": self.ticks, "now": now}
        if not self.interlock.check():
            count("AUTOPILOT_FROZEN_SKIPS")
            record.update(action="frozen",
                          interlock=self.interlock.status())
            self.history.append(record)
            self.last_decision = record
            return record
        # a split/merge changed the topology since the last tick: the
        # detector and sensors must judge the CURRENT shard set
        self.detector.num_shards = int(self.group.num_shards)
        sense = self.sensors.read(now=now)
        decision = self.policy.decide(sense)
        record["decision"] = decision.as_dict()
        record["action"] = decision.action
        outcome: Optional[Dict[str, Any]] = None
        if decision.action != "none":
            # action-in-flight signal: other controllers (the autotuner)
            # must not step knobs while the fleet is being reshaped —
            # their objective window would measure the reshape, not the
            # knob. Cleared in the finally even when the action dies.
            gauge_set("AUTOPILOT_ACTION_INFLIGHT", 1)
            try:
                outcome = self.actuators.execute(decision)
            except AutopilotKilled as exc:
                # the chaos hook: controller death mid-action. Latch
                # frozen — a human decides whether the half-observed
                # action completed — and stop the loop.
                self.interlock.freeze(str(exc))
                flight_dump("autopilot_killed", decision=record["decision"],
                            error=str(exc),
                            policy=self.policy.state_snapshot(now))
                self._stop.set()
                outcome = {"ok": False, "action": decision.action,
                           "error": str(exc), "killed": True}
            finally:
                gauge_set("AUTOPILOT_ACTION_INFLIGHT", 0)
            self.policy.record_action(decision.action, now=now)
            record["outcome"] = outcome
            flight_dump("autopilot_decision",
                        decision=record["decision"], outcome=outcome,
                        policy=self.policy.state_snapshot(now),
                        sense=sense.as_dict())
            log.info("autopilot: %s shard=%s -> %s (%s)",
                     decision.action, decision.shard,
                     "ok" if outcome and outcome.get("ok") else "FAILED",
                     decision.reason)
        self.history.append(record)
        self.last_decision = record
        return record

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Autopilot":
        if self.interval <= 0:
            log.fatal("Autopilot.start needs autopilot_interval_seconds "
                      "> 0 (or interval=); use tick_now() for drills")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-autopilot")
        self._thread.start()
        log.info("autopilot: control loop started (%d shard(s), every "
                 "%.1fs)", self.group.num_shards, self.interval)
        return self

    def _run(self) -> None:
        while not self._stop.wait(max(0.05, self.interval)):
            try:
                self.tick_now()
            except Exception as exc:  # noqa: BLE001 — the controller
                # must outlive any single bad tick
                log.error("autopilot: tick failed: %r", exc)

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    # -- operator surface ----------------------------------------------------
    def ack(self, operator: str = "operator") -> None:
        """Operator acknowledgement: the only way out of a freeze."""
        self.interlock.ack(operator)

    def status(self) -> Dict[str, Any]:
        return {"running": (self._thread is not None
                            and self._thread.is_alive()),
                "ticks": self.ticks,
                "interval": self.interval,
                "interlock": self.interlock.status(),
                "policy": self.policy.state_snapshot(),
                "last": self.last_decision,
                "recent": list(self.history)[-8:]}


class _AutopilotModule(types.ModuleType):
    """``mvt.autopilot(group, ...)`` — the operator entrypoint — and this
    package share one name: importing the package rebinds the attribute
    on ``multiverso_tpu_torch`` from the function to this module, so the
    module itself is callable with the same semantics."""

    def __call__(self, group: Any, interval: Optional[float] = None,
                 auditor: Any = None, **kwargs: Any) -> Autopilot:
        import multiverso_tpu_torch as _mv
        kwargs.setdefault("engine", getattr(_mv, "_slo_engine", None))
        pilot = Autopilot(group, interval=interval, auditor=auditor,
                          **kwargs)
        if pilot.interval > 0:
            pilot.start()
        return pilot


sys.modules[__name__].__class__ = _AutopilotModule
