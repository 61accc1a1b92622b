"""Autopilot policy: sensor snapshot in, at most ONE decision out (port
of ``multiverso_tpu/autopilot/policy.py``).

The policy is deliberately boring — a priority list of guarded rules
over the :class:`~multiverso_tpu_torch.autopilot.sensors.FleetSense` snapshot
— because a fleet controller earns trust through predictability, not
cleverness:

* **Hysteresis**: a rule's condition must hold for
  ``autopilot_hysteresis_ticks`` CONSECUTIVE ticks before it may act;
  one noisy sample never resizes the fleet. Streaks are tracked per
  action kind and reset the tick the condition breaks.
* **Cooldown**: after the autopilot executes (or fails) an action of a
  kind, that kind is barred for ``autopilot_cooldown_seconds`` — the
  fleet must be given time to show the action's effect before the
  controller reacts to its own wake.
* **Rejected alternatives ride along**: every rule that matched but was
  barred (hysteresis still building, cooldown live, ceiling/floor hit)
  is recorded on the decision, so the flight recorder answers "why did
  it NOT act" as precisely as "why did it act".

Priority order (first match wins): hot-shard split > cold-range merge >
add replica (read-tier pressure or admission shedding) >
remove replica (idle fleet) >
tier budget up (hot-tier misses) > tier budget down (over-provisioned).
Splits and merges are topology changes and therefore marked ``risky``
— the actuator rehearses them on a blue/green clone first when
``autopilot_blue_green`` is on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import config
from multiverso_tpu_torch.autopilot.sensors import FleetSense

ACTIONS = ("split", "merge", "add_replica", "remove_replica",
           "tier_up", "tier_down")


@dataclass
class Decision:
    """One tick's verdict: the action (or ``none``) plus the audit trail
    the flight recorder keeps — reason, rejected alternatives, and the
    hysteresis/cooldown state that produced it."""

    action: str = "none"
    shard: Optional[int] = None
    reason: str = ""
    risky: bool = False
    params: Dict[str, Any] = field(default_factory=dict)
    alternatives: List[Dict[str, str]] = field(default_factory=list)

    def as_dict(self) -> Dict[str, Any]:
        return {"action": self.action, "shard": self.shard,
                "reason": self.reason, "risky": self.risky,
                "params": dict(self.params),
                "alternatives": list(self.alternatives)}


class AutopilotPolicy:
    """Stateful rule evaluation: streaks + cooldowns across ticks."""

    def __init__(self, detector: Any) -> None:
        self.detector = detector  # HotRangeDetector (split/merge rules)
        self._streaks: Dict[str, int] = {a: 0 for a in ACTIONS}
        self._cooldown_until: Dict[str, float] = {}
        self.hysteresis = int(
            config.get_flag("autopilot_hysteresis_ticks"))
        self.cooldown = float(
            config.get_flag("autopilot_cooldown_seconds"))
        self.max_replicas = int(config.get_flag("autopilot_max_replicas"))
        self.min_replicas = int(config.get_flag("autopilot_min_replicas"))
        self.hedge_rate = float(config.get_flag("autopilot_hedge_rate"))
        self.scaledown_qps = float(
            config.get_flag("autopilot_scaledown_qps"))
        self.tier_target = float(
            config.get_flag("autopilot_tier_target_hit_rate"))
        self.tier_step = int(config.get_flag("autopilot_tier_step_bytes"))
        self.tier_max = int(config.get_flag("autopilot_tier_max_bytes"))

    # -- cross-tick state ----------------------------------------------------
    def record_action(self, action: str,
                      now: Optional[float] = None) -> None:
        """Stamp ``action``'s cooldown and clear its streak — called for
        SUCCESSES AND FAILURES both (a failed migration must not be
        retried every tick)."""
        now = float(now if now is not None else time.time())
        self._cooldown_until[action] = now + self.cooldown
        self._streaks[action] = 0

    def state_snapshot(self, now: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Streaks + live cooldowns — rides every flight-recorder dump."""
        now = float(now if now is not None else time.time())
        return {"streaks": dict(self._streaks),
                "cooldowns": {a: round(t - now, 3)
                              for a, t in self._cooldown_until.items()
                              if t > now}}

    # -- rule plumbing -------------------------------------------------------
    def _gate(self, action: str, matched: bool, now: float,
              decision: Decision, why: str) -> bool:
        """Streak/cooldown gate: returns True when ``action`` may fire
        this tick; otherwise records the rejection on ``decision``."""
        if not matched:
            self._streaks[action] = 0
            return False
        self._streaks[action] += 1
        until = self._cooldown_until.get(action, 0.0)
        if until > now:
            decision.alternatives.append(
                {"action": action,
                 "reason": f"{why}; barred by cooldown for "
                           f"{until - now:.1f}s"})
            return False
        if self._streaks[action] < self.hysteresis:
            decision.alternatives.append(
                {"action": action,
                 "reason": f"{why}; hysteresis "
                           f"{self._streaks[action]}/{self.hysteresis}"})
            return False
        return True

    # -- the decision --------------------------------------------------------
    def decide(self, sense: FleetSense) -> Decision:
        decision = Decision()
        now = sense.now

        # 1. hot-shard split (the detector owns thresholds + proposal
        # counting; its proposal is the rule's match)
        split = self.detector.propose()
        if self._gate("split", split is not None, now, decision,
                      "hot shard" if split is None else
                      f"shard {split['shard']} at {split['rate']:.1f} "
                      f"req/s vs median {split['median']:.1f}"):
            decision.action = "split"
            decision.shard = int(split["shard"])
            decision.risky = True
            decision.params = {k: v for k, v in split.items()
                               if k != "op"}
            decision.reason = (f"shard {split['shard']} runs "
                               f"{split['rate']:.1f} req/s against a "
                               f"median of {split['median']:.1f}")
            return decision

        # 2. cold-range merge
        merge = None if split is not None else self.detector.propose_merge()
        if self._gate("merge", merge is not None, now, decision,
                      "cold adjacent shards" if merge is None else
                      f"shards {merge['shard']}+{merge['shard'] + 1} at "
                      f"{merge['rate']:.1f}/{merge['neighbor_rate']:.1f} "
                      "req/s"):
            decision.action = "merge"
            decision.shard = int(merge["shard"])
            decision.risky = True
            decision.params = {k: v for k, v in merge.items()
                               if k != "op"}
            decision.reason = (f"shards {merge['shard']} and "
                               f"{merge['shard'] + 1} both idle below "
                               f"{self.detector.cold_qps:.1f} req/s")
            return decision

        # 3. add replica: sustained read-tier pressure. High replica LAG
        # deliberately does not match — another replica tails the same
        # WAL and cures nothing; it lands as a rejected alternative so
        # the recorder shows the controller saw it and declined.
        counts = sense.replica_counts or [0]
        # Sustained admission-control shedding is the strongest overload
        # signal there is: the gate is already sacrificing training
        # writes to keep serving reads inside SLO, so capacity — not
        # tuning — is the cure. Hysteresis still applies, so one stray
        # shed event never resizes the fleet.
        shedding = sense.shed_rate > 0.0
        pressured = sense.read_pressure > self.hedge_rate or shedding
        target = (min(range(len(counts)), key=lambda k: counts[k])
                  if counts else 0)
        room = counts and counts[target] < self.max_replicas
        if pressured and not room:
            decision.alternatives.append(
                {"action": "add_replica",
                 "reason": f"read pressure {sense.read_pressure:.1f}/s "
                           f"but every shard at the "
                           f"{self.max_replicas}-replica ceiling"})
        if max(sense.replica_lag.values(), default=0) > 0 and pressured:
            decision.alternatives.append(
                {"action": "add_replica",
                 "reason": "replica lag is replay backlog, not serving "
                           "capacity — a new replica tails the same WAL"})
        why = (f"admission gate shedding {sense.shed_rate:.1f} req/s"
               if shedding else
               f"read pressure {sense.read_pressure:.1f}/s over "
               f"the {self.hedge_rate:.1f}/s threshold")
        if self._gate("add_replica", pressured and bool(room), now,
                      decision, why):
            decision.action = "add_replica"
            decision.shard = target
            decision.reason = (f"{why} sustained; shard {target} has "
                               f"the thinnest fleet ({counts[target]})")
            return decision

        # 4. remove replica: idle fleet above the floor
        removable = [k for k, c in enumerate(counts)
                     if c > self.min_replicas]
        idle = sense.total_qps < self.scaledown_qps
        if self._gate("remove_replica", idle and bool(removable), now,
                      decision,
                      f"fleet idle at {sense.total_qps:.1f} req/s"):
            fat = max(removable, key=lambda k: counts[k])
            decision.action = "remove_replica"
            decision.shard = fat
            decision.reason = (f"fleet idle at {sense.total_qps:.2f} "
                               f"req/s < {self.scaledown_qps:.2f}; "
                               f"shard {fat} keeps {counts[fat] - 1}")
            return decision

        # 5/6. tier budget rebalance from hit-rate gauges
        budget = int(config.get_flag("tier_resident_bytes"))
        hit = sense.tier_hit_rate
        grow = (hit is not None and hit < self.tier_target
                and budget + self.tier_step <= self.tier_max)
        if hit is not None and hit < self.tier_target and not grow:
            decision.alternatives.append(
                {"action": "tier_up",
                 "reason": f"hot-tier hit rate {hit:.2f} below target "
                           f"{self.tier_target:.2f} but budget at the "
                           f"{self.tier_max}-byte ceiling"})
        if self._gate("tier_up", grow, now, decision,
                      "" if hit is None else
                      f"hot-tier hit rate {hit:.2f} below "
                      f"{self.tier_target:.2f}"):
            decision.action = "tier_up"
            decision.params = {"from": budget,
                               "to": budget + self.tier_step}
            decision.reason = (f"hot-tier hit rate {hit:.2f} below "
                               f"target {self.tier_target:.2f}; growing "
                               f"resident budget to "
                               f"{budget + self.tier_step}")
            return decision

        shrink = (hit is not None and hit >= self.tier_target
                  and sense.tier_resident_bytes > 0
                  and budget - self.tier_step
                  >= 2 * sense.tier_resident_bytes)
        if self._gate("tier_down", shrink, now, decision,
                      "" if hit is None else
                      f"hit rate {hit:.2f} at target with residency "
                      f"{sense.tier_resident_bytes:.0f} under half the "
                      "budget"):
            decision.action = "tier_down"
            decision.params = {"from": budget,
                               "to": budget - self.tier_step}
            decision.reason = (f"hit rate {hit:.2f} at target while "
                               f"resident bytes "
                               f"{sense.tier_resident_bytes:.0f} use "
                               f"under half the {budget}-byte budget")
            return decision

        decision.reason = "fleet within all envelopes"
        return decision
