"""Autopilot actuators: decisions become fleet operations (port of
``multiverso_tpu/autopilot/actuators.py``; the blue/green canary comes up
on the controlled group's device).

Each action kind dispatches to machinery that is ALREADY crash-safe on
its own — splits and merges run the MigrationCoordinator's fencing
protocol (zero acked-Add loss by construction), replica add/remove goes
through ShardGroup's live-membership methods (manifest republished
atomically), tier rebalance writes the ``tier_resident_bytes`` flag and
resizes registered in-process stores. The actuator layer adds three
things on top:

* **Outcome truth**: every execution returns an outcome dict (ok /
  error / seconds / detail) and bumps ``AUTOPILOT_ACTIONS`` or
  ``AUTOPILOT_ACTION_FAILURES``; the control loop attaches it to the
  decision's flight-recorder record.
* **Blue/green rehearsal**: with ``autopilot_blue_green`` on, a risky
  decision (split/merge) is first executed against an ``mvt.clone_fleet``
  canary bootstrapped from the live fleet; only a canary that survives
  the same migration earns the live run. The canary is always stopped.
* **`MV_AUTOPILOT_KILL` chaos**: ``before[:action]`` kills the autopilot
  before the operation starts (fleet untouched); ``mid[:action]`` kills
  it after the crash-safe operation but before any autopilot
  bookkeeping (fleet reshaped, controller dead mid-thought). Both must
  leave the fleet consistent with zero acked-Add loss — the drill in
  tests/test_torch_autopilot.py proves it.

Tier rebalance scope: the flag write governs every table constructed
AFTER it in this process; live in-process TieredStores are resized only
when registered via ``register_tiered_store`` (shard children own their
tables and budgets — reshaping those is a restart-time decision, which
the flag write also covers for clones/restores launched from here).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.autopilot.policy import Decision
from multiverso_tpu_torch.dashboard import count


class AutopilotKilled(RuntimeError):
    """Raised by the MV_AUTOPILOT_KILL chaos hook: the control loop
    treats it as the controller dying mid-action."""


def _maybe_kill(stage: str, action: str) -> None:
    spec = os.environ.get("MV_AUTOPILOT_KILL", "")
    if not spec:
        return
    want_stage, _, want_action = spec.partition(":")
    if want_stage != stage:
        return
    if want_action and want_action != action:
        return
    raise AutopilotKilled(f"MV_AUTOPILOT_KILL={spec} fired at stage "
                          f"{stage!r} of action {action!r}")


class Actuators:
    """Executes :class:`Decision` values against a live ShardGroup."""

    def __init__(self, group: Any, coordinator: Any = None) -> None:
        self.group = group
        self._coordinator = coordinator
        self._tiered_stores: List[Any] = []

    @property
    def coordinator(self):
        if self._coordinator is None:
            from multiverso_tpu_torch.shard.reshard import MigrationCoordinator
            self._coordinator = MigrationCoordinator(self.group)
        return self._coordinator

    def register_tiered_store(self, store: Any) -> None:
        """Opt an in-process TieredStore into live budget rebalance."""
        self._tiered_stores.append(store)

    # -- execution -----------------------------------------------------------
    def execute(self, decision: Decision) -> Dict[str, Any]:
        """Run ``decision``; returns the outcome record. Raises
        :class:`AutopilotKilled` only for the chaos hook — real
        execution failures come back as ``ok=False`` outcomes."""
        action = decision.action
        t0 = time.monotonic()
        _maybe_kill("before", action)
        try:
            if decision.risky and \
                    bool(config.get_flag("autopilot_blue_green")):
                self._rehearse(decision)
            detail = self._dispatch(decision)
        except AutopilotKilled:
            raise
        except Exception as exc:  # noqa: BLE001 — one failed action
            # must not kill the control loop; the outcome records it
            count("AUTOPILOT_ACTION_FAILURES")
            log.error("autopilot: %s failed: %r", action, exc)
            return {"ok": False, "action": action,
                    "error": f"{type(exc).__name__}: {exc}",
                    "seconds": time.monotonic() - t0}
        # the underlying operation committed; a kill here is the
        # controller dying mid-thought AFTER the crash-safe part
        _maybe_kill("mid", action)
        count("AUTOPILOT_ACTIONS")
        return {"ok": True, "action": action, "detail": detail,
                "seconds": time.monotonic() - t0}

    def _dispatch(self, decision: Decision) -> Any:
        action = decision.action
        if action == "split":
            self.coordinator.split(int(decision.shard))
            return {"shard": decision.shard,
                    "num_shards": self.group.num_shards}
        if action == "merge":
            self.coordinator.merge(int(decision.shard))
            return {"shard": decision.shard,
                    "num_shards": self.group.num_shards}
        if action == "add_replica":
            endpoint = self.group.add_replica(int(decision.shard))
            return {"shard": decision.shard, "endpoint": endpoint}
        if action == "remove_replica":
            endpoint = self.group.remove_replica(int(decision.shard))
            return {"shard": decision.shard, "endpoint": endpoint}
        if action in ("tier_up", "tier_down"):
            return self._retier(int(decision.params["to"]))
        raise ValueError(f"autopilot: unknown action {action!r}")

    def _retier(self, new_budget: int) -> Dict[str, Any]:
        config.set_flag("tier_resident_bytes", int(new_budget))
        resized = 0
        for store in self._tiered_stores:
            store.budget = int(new_budget)
            store._promote_slack = max(store.row_bytes * 64,
                                       store.budget // 8)
            store.maintain()  # shrink demotes immediately, grow is a no-op
            resized += 1
        return {"budget": int(new_budget), "stores_resized": resized}

    def _rehearse(self, decision: Decision) -> None:
        """Blue/green: run the same migration on a clone_fleet canary
        bootstrapped from the live group; a canary that dies vetoes the
        live run (the raised error becomes the action's outcome)."""
        from multiverso_tpu_torch import clone_fleet
        from multiverso_tpu_torch.shard.reshard import MigrationCoordinator
        log.info("autopilot: rehearsing %s of shard %s on a blue/green "
                 "canary", decision.action, decision.shard)
        # the port's clone takes its device from the caller (the ``device``
        # flag by default): the canary comes up where the live group runs
        canary = clone_fleet(self.group,
                             device=getattr(self.group, "device", None))
        try:
            coord = MigrationCoordinator(canary)
            if decision.action == "split":
                coord.split(int(decision.shard))
            else:
                coord.merge(int(decision.shard))
        finally:
            canary.stop()
