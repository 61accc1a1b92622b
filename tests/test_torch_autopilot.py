"""Twins of ``tests/test_autopilot.py`` on the port's fleet autopilot
(``multiverso_tpu_torch/autopilot/``): policy hysteresis, cooldowns and
rejected alternatives, the latching safety interlock, the detector's
tick outcomes, actuator outcome truth, the sensor snapshot, and the live
drills on the port's ``ShardGroup`` with ``device="cpu"``.

The reference's zipf-shift drill fails in the JAX package's own test
runs: it writes for a fixed 1.5 s and then needs 4 Adds on shard 0 in
its 4 s window (``reshard_min_qps`` 1.0), while the JAX shard children
compile their first Add in that time. The twin ticks only once at least
8 acknowledged Adds of the window reached shard 0, and is also held to
the writers' mirror (bitwise) and to the JAX package's own split plan of
the same spans.

Parity: one seeded synthetic telemetry sequence goes through both
packages' sensors, detectors, policies, interlocks and actuators (fakes
built from numpy, as the reference tests build them); the decisions,
outcomes (clock readings aside) and flight records (timestamps aside)
are equal, exactly. For the slice as a whole, both packages' autopilots
drive their own small live groups (32 x 4, 2 shards) from the same
scripted recorder samples and the same integer Adds: the same actions
in the same order, the same layout and the same table.

The chaos arm keeps the reference's env gate (``MV_AUTOPILOT_KILL``).
"""

import copy
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.autopilot import Actuators as JActuators
from multiverso_tpu.autopilot import Autopilot as JAutopilot
from multiverso_tpu.autopilot import AutopilotKilled as JAutopilotKilled
from multiverso_tpu.autopilot import AutopilotPolicy as JAutopilotPolicy
from multiverso_tpu.autopilot import Decision as JDecision
from multiverso_tpu.autopilot import FleetSense as JFleetSense
from multiverso_tpu.autopilot import FleetSensors as JFleetSensors
from multiverso_tpu.autopilot import SafetyInterlock as JSafetyInterlock
from multiverso_tpu.config import FLAGS as JFLAGS
from multiverso_tpu.dashboard import Dashboard as JDashboard
from multiverso_tpu.dashboard import count as jcount
from multiverso_tpu.shard import reshard as jreshard
from multiverso_tpu.shard.group import ShardGroup as JShardGroup

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.autopilot import (Actuators, Autopilot,
                                            AutopilotKilled, AutopilotPolicy,
                                            Decision, FleetSense,
                                            FleetSensors, SafetyInterlock)
from multiverso_tpu_torch.config import FLAGS
from multiverso_tpu_torch.dashboard import Dashboard, count, gauge_set, observe
from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
from multiverso_tpu_torch.runtime.remote import fetch_digest
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.shard.group import ShardGroup
from multiverso_tpu_torch.shard.reshard import (HotRangeDetector,
                                                MigrationError)

GROUP_FLAGS = {"remote_workers": 4, "heartbeat_seconds": 0.2,
               "lease_seconds": 1.5, "request_retry_seconds": 1.0,
               "reconnect_deadline_seconds": 30.0}
START_S = 180


@pytest.fixture(autouse=True)
def port_runtime(request, monkeypatch):
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread; whatever a test starts is stopped (tests/conftest.py
    resets the JAX side). Only the chaos arm sees ``MV_AUTOPILOT_KILL``:
    every other case executes real actions."""
    if "killed_mid_action" not in request.node.name:
        monkeypatch.delenv("MV_AUTOPILOT_KILL", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    FLAGS.reset()
    FLAGS.set("device", "cpu")
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        FLAGS.reset()
        torch.set_num_threads(threads)


# -- fakes --------------------------------------------------------------------

class _Hist:
    def __init__(self, count):
        self.count = count


class _Recorder:
    """TimeSeriesRecorder stand-in driven by plain dicts."""

    def __init__(self, shard_counts=None, rates=None, gauges=None,
                 window=30.0):
        self.shard_counts = dict(shard_counts or {})
        self.rates = dict(rates or {})
        self.gauges = dict(gauges or {})
        self.window = window

    def window_histogram(self, name, window):
        if name.startswith("ROUTER_SHARD"):
            k = int(name[len("ROUTER_SHARD"):].split("_")[0])
            n = self.shard_counts.get(k, 0)
            return _Hist(n) if n else None
        return None

    def rate(self, name, window):
        return float(self.rates.get(name, 0.0))

    def gauge(self, name):
        return float(self.gauges.get(name, 0.0))

    def quantile(self, name, q, window):
        return 0.0


class _Group:
    """ShardGroup stand-in: membership calls recorded, never spawned."""

    def __init__(self, num_shards=2):
        self.num_shards = num_shards
        self.replica_endpoints = [[] for _ in range(num_shards)]
        self.calls = []

    def add_replica(self, shard, timeout=120.0):
        self.calls.append(("add", shard))
        return f"h:{shard}"

    def remove_replica(self, shard, index=None):
        self.calls.append(("remove", shard))
        return f"h:{shard}"


class _Detector:
    """Detector stand-in returning canned proposals (no counters)."""

    def __init__(self, split=None, merge=None):
        self.split_p, self.merge_p = split, merge
        self.cold_qps = 5.0
        self.num_shards = 2

    def propose(self):
        return dict(self.split_p) if self.split_p else None

    def propose_merge(self):
        return dict(self.merge_p) if self.merge_p else None


class _ForcedPolicy:
    """Policy stand-in that always decides one canned action."""

    def __init__(self, decision):
        self.decision = decision
        self.recorded = []

    def decide(self, sense):
        return self.decision

    def record_action(self, action, now=None):
        self.recorded.append(action)

    def state_snapshot(self, now=None):
        return {"streaks": {}, "cooldowns": {}}


def _sense(**kw):
    base = dict(now=1000.0, shard_rates=[0.0, 0.0], total_qps=0.0,
                read_pressure=0.0, replica_lag={}, replica_counts=[0, 0],
                get_p99=0.0, tier_hit_rate=None, tier_resident_bytes=0.0,
                slo_firing=[], audit_divergent=False)
    base.update(kw)
    return FleetSense(**base)


_SPLIT = {"op": "split", "shard": 1, "rate": 90.0, "median": 3.0}
_MERGE = {"op": "merge", "shard": 0, "rate": 0.2, "neighbor_rate": 0.1}


# -- policy: hysteresis, cooldown, rejected alternatives ----------------------

def test_policy_split_waits_for_hysteresis_then_fires():
    mvt.set_flag("autopilot_hysteresis_ticks", 2)
    pol = AutopilotPolicy(_Detector(split=_SPLIT))
    d1 = pol.decide(_sense())
    assert d1.action == "none"
    assert any(a["action"] == "split" and "hysteresis 1/2" in a["reason"]
               for a in d1.alternatives)
    d2 = pol.decide(_sense())
    assert d2.action == "split" and d2.shard == 1 and d2.risky
    assert d2.params["rate"] == 90.0


def test_policy_streak_resets_when_condition_breaks():
    mvt.set_flag("autopilot_hysteresis_ticks", 2)
    det = _Detector(split=_SPLIT)
    pol = AutopilotPolicy(det)
    assert pol.decide(_sense()).action == "none"   # streak 1/2
    det.split_p = None                             # one calm tick
    assert pol.decide(_sense()).action == "none"   # streak reset
    det.split_p = _SPLIT
    assert pol.decide(_sense()).action == "none"   # back to 1/2
    assert pol.decide(_sense()).action == "split"


def test_policy_cooldown_bars_repeat_and_snapshot_shows_it():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    pol = AutopilotPolicy(_Detector(split=_SPLIT))
    now = 1000.0
    assert pol.decide(_sense(now=now)).action == "split"
    pol.record_action("split", now=now)
    d = pol.decide(_sense(now=now + 1.0))
    assert d.action == "none"
    assert any(a["action"] == "split" and "cooldown" in a["reason"]
               for a in d.alternatives)
    snap = pol.state_snapshot(now=now + 1.0)
    assert snap["cooldowns"]["split"] > 0
    # past the cooldown the rule fires again
    assert pol.decide(_sense(now=now + pol.cooldown + 1)).action == "split"


def test_policy_merge_fires_and_split_outranks_it():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    pol = AutopilotPolicy(_Detector(merge=_MERGE))
    d = pol.decide(_sense())
    assert d.action == "merge" and d.shard == 0 and d.risky
    both = AutopilotPolicy(_Detector(split=_SPLIT, merge=_MERGE))
    assert both.decide(_sense()).action == "split"


def test_policy_add_replica_on_read_pressure_picks_thinnest():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    pol = AutopilotPolicy(_Detector())
    d = pol.decide(_sense(read_pressure=20.0, replica_counts=[2, 0],
                          replica_lag={0: 7}, total_qps=50.0))
    assert d.action == "add_replica" and d.shard == 1
    # replica lag rides along as a rejected alternative, never a trigger
    assert any(a["action"] == "add_replica" and "WAL" in a["reason"]
               for a in d.alternatives)


def test_policy_add_replica_respects_ceiling():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    mvt.set_flag("autopilot_max_replicas", 1)
    pol = AutopilotPolicy(_Detector())
    d = pol.decide(_sense(read_pressure=20.0, replica_counts=[1, 1],
                          total_qps=50.0))
    assert d.action == "none"
    assert any(a["action"] == "add_replica" and "ceiling" in a["reason"]
               for a in d.alternatives)


def test_policy_remove_replica_when_idle_above_floor():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    pol = AutopilotPolicy(_Detector())
    d = pol.decide(_sense(total_qps=0.1, replica_counts=[2, 1]))
    assert d.action == "remove_replica" and d.shard == 0  # the fattest
    # at the floor nothing is removable
    mvt.set_flag("autopilot_min_replicas", 1)
    pol2 = AutopilotPolicy(_Detector())
    assert pol2.decide(_sense(total_qps=0.1,
                              replica_counts=[1, 1])).action == "none"


def test_policy_tier_rebalance_up_down_and_ceiling():
    mvt.set_flag("autopilot_hysteresis_ticks", 1)
    mvt.set_flag("tier_resident_bytes", 32 << 20)
    pol = AutopilotPolicy(_Detector())
    d = pol.decide(_sense(tier_hit_rate=0.5, total_qps=50.0))
    assert d.action == "tier_up"
    assert d.params == {"from": 32 << 20, "to": (32 << 20) + pol.tier_step}
    # shrink when the hit rate holds and residency uses under half
    d2 = pol.decide(_sense(tier_hit_rate=0.95, total_qps=50.0,
                           tier_resident_bytes=float(1 << 20)))
    assert d2.action == "tier_down"
    assert d2.params["to"] == (32 << 20) - pol.tier_step
    # at the byte ceiling the miss pressure lands as an alternative
    mvt.set_flag("autopilot_tier_max_bytes", 32 << 20)
    pol3 = AutopilotPolicy(_Detector())
    d3 = pol3.decide(_sense(tier_hit_rate=0.5, total_qps=50.0))
    assert d3.action == "none"
    assert any(a["action"] == "tier_up" and "ceiling" in a["reason"]
               for a in d3.alternatives)


# -- safety interlock ---------------------------------------------------------

def test_interlock_latches_on_divergence_until_operator_ack():
    class _Aud:
        divergent = True

        def status(self):
            return {"divergent": True}

    aud = _Aud()
    lock = SafetyInterlock(aud)
    assert not lock.check()
    assert lock.frozen
    assert Dashboard.counter_value("AUTOPILOT_FREEZES") == 1
    assert Dashboard.gauge_value("AUTOPILOT_FROZEN") == 1
    aud.divergent = False          # fleet "recovered" unsupervised
    assert not lock.check()        # the latch holds regardless
    assert Dashboard.counter_value("AUTOPILOT_FREEZES") == 1  # idempotent
    lock.ack("oncall")
    assert Dashboard.counter_value("AUTOPILOT_ACKS") == 1
    assert Dashboard.gauge_value("AUTOPILOT_FROZEN") == 0
    assert lock.check() and not lock.frozen


def test_interlock_counter_trigger_and_ack_rebaseline():
    count("AUDIT_DIVERGENCE")      # history predating the autopilot
    lock = SafetyInterlock()
    assert lock.check()            # old divergences never refuse a start
    count("AUDIT_DIVERGENCE")
    assert not lock.check() and lock.frozen
    assert "AUDIT_DIVERGENCE" in lock.freeze_reason
    lock.ack()
    assert lock.check()            # re-baselined
    count("AUDIT_DIVERGENCE")
    assert not lock.check()        # fresh divergence freezes again


# -- detector tick: execution outcomes recorded -------------------------------

class _Coord:
    def __init__(self, fail=False, error=MigrationError):
        self.calls = []
        self.fail = fail
        self.error = error

    def split(self, shard):
        self.calls.append(("split", shard))
        if self.fail:
            raise self.error("cutover failed (drill)")

    def merge(self, shard):
        self.calls.append(("merge", shard))
        if self.fail:
            raise self.error("cutover failed (drill)")


def test_detector_tick_executes_behind_flag_and_counts_success():
    det = HotRangeDetector(2, recorder=_Recorder({0: 9000, 1: 30}),
                           hot_ratio=3.0, min_qps=1.0)
    coord = _Coord()
    out = det.tick(coord)          # auto_reshard off: proposal only
    assert out["op"] == "split" and out["executed"] is False
    assert not coord.calls
    mvt.set_flag("auto_reshard", True)
    out = det.tick(coord)
    assert out["executed"] is True and coord.calls == [("split", 0)]
    assert Dashboard.counter_value("RESHARD_EXECUTED") == 1


def test_detector_tick_records_migration_failure():
    mvt.set_flag("auto_reshard", True)
    det = HotRangeDetector(2, recorder=_Recorder({0: 9000, 1: 30}),
                           hot_ratio=3.0, min_qps=1.0)
    out = det.tick(_Coord(fail=True))
    assert out["executed"] is False and "cutover" in out["error"]
    assert Dashboard.counter_value("RESHARD_EXEC_FAILURES") == 1
    assert Dashboard.counter_value("RESHARD_EXECUTED") == 0


def test_detector_proposes_cold_adjacent_merge():
    mvt.set_flag("reshard_cold_qps", 2.0)
    det = HotRangeDetector(3, recorder=_Recorder({0: 30, 1: 6, 2: 3}),
                           hot_ratio=3.0, min_qps=50.0)
    out = det.tick()               # no split (under the qps floor)
    assert out == {"op": "merge", "shard": 1, "rate": 0.2,
                   "neighbor_rate": 0.1, "executed": False}
    assert Dashboard.counter_value("RESHARD_PROPOSALS") == 1
    # a warm neighbor blocks the merge
    mvt.set_flag("reshard_cold_qps", 0.15)
    warm = HotRangeDetector(3, recorder=_Recorder({0: 30, 1: 6, 2: 3}),
                            hot_ratio=3.0, min_qps=50.0)
    assert warm.propose_merge() is None


# -- sensors ------------------------------------------------------------------

def test_sensors_snapshot_reads_recorder_and_probes_lag():
    group = _Group(num_shards=2)
    group.replica_endpoints = [["h:1", "h:2"], []]
    probed = []

    def probe(ep, timeout=2.0):
        probed.append(ep)
        if ep == "h:2":
            raise OSError("unreachable (the auditor's business)")
        return {"lag": 5}

    rec = _Recorder(shard_counts={0: 60, 1: 30},
                    rates={"READ_HEDGES": 2.0,
                           "READ_PRIMARY_FALLBACKS": 1.5,
                           "TIER_HOT_HITS": 9.0, "TIER_COLD_HITS": 1.0},
                    gauges={"TIER_RESIDENT_BYTES": 4096.0})
    sens = FleetSensors(group, recorder=rec, window=30.0, probe=probe)
    s = sens.read(now=10.0)
    assert s.shard_rates == [2.0, 1.0] and s.total_qps == 3.0
    assert s.read_pressure == 3.5
    assert s.replica_lag == {0: 5}          # worst lag; h:2 skipped
    assert s.replica_counts == [2, 0]
    assert s.tier_hit_rate == 0.9
    assert s.tier_resident_bytes == 4096.0
    assert sorted(probed) == ["h:1", "h:2"]
    # the worst per-shard lag republishes as a local gauge operators
    # (and Prometheus) scrape from the controlling process
    assert Dashboard.gauge_value("FLEET_SHARD0_REPLICA_LAG") == 5


def test_prom_exposition_splits_shard_series_into_labels():
    gauge_set("FLEET_SHARD3_REPLICA_LAG", 7)
    observe("ROUTER_SHARD1_SECONDS", 0.01)
    count("RESHARD_EXECUTED")
    text = Dashboard.render(format="prom")
    assert 'mvtpu_fleet_replica_lag{shard="3"} 7' in text
    assert 'mvtpu_router_seconds_bucket{shard="1",le="+Inf"} 1' in text
    assert "mvtpu_reshard_executed_total 1" in text
    # one # TYPE line per family even with per-shard series
    assert text.count("# TYPE mvtpu_router_seconds histogram") == 1


# -- actuators ----------------------------------------------------------------

def test_actuators_dispatch_membership_and_count_outcomes():
    group = _Group()
    act = Actuators(group)
    out = act.execute(Decision(action="add_replica", shard=1))
    assert out["ok"] and out["detail"]["endpoint"] == "h:1"
    out = act.execute(Decision(action="remove_replica", shard=0))
    assert out["ok"] and group.calls == [("add", 1), ("remove", 0)]
    assert Dashboard.counter_value("AUTOPILOT_ACTIONS") == 2


def test_actuators_failure_is_an_outcome_not_a_crash():
    class _Bad(_Group):
        def add_replica(self, shard, timeout=120.0):
            raise RuntimeError("spawn failed (drill)")

    out = Actuators(_Bad()).execute(Decision(action="add_replica", shard=0))
    assert out["ok"] is False and "spawn failed" in out["error"]
    assert Dashboard.counter_value("AUTOPILOT_ACTION_FAILURES") == 1
    assert Dashboard.counter_value("AUTOPILOT_ACTIONS") == 0


def test_actuators_retier_updates_flag_and_registered_store():
    class _Store:
        row_bytes = 64
        budget = 0
        _promote_slack = 0
        maintained = 0

        def maintain(self):
            self.maintained += 1

    act = Actuators(_Group())
    store = _Store()
    act.register_tiered_store(store)
    out = act.execute(Decision(action="tier_up",
                               params={"from": 1 << 20, "to": 123456}))
    assert out["ok"] and out["detail"] == {"budget": 123456,
                                           "stores_resized": 1}
    assert int(mvt.get_flag("tier_resident_bytes")) == 123456
    assert store.budget == 123456 and store.maintained == 1


def test_actuators_blue_green_canary_takes_the_groups_device(monkeypatch):
    """The port's ``clone_fleet`` takes its device from the caller, so the
    rehearsal passes the live group's: a CPU group's canary must not
    come up on the ``device`` flag's card."""
    seen = []

    class _Canary:
        stopped = False

        def stop(self):
            self.stopped = True

    canary = _Canary()

    def clone(source, device=None, **kw):
        seen.append((source, device))
        return canary

    class _CanaryCoord:
        def __init__(self, group):
            assert group is canary

        def split(self, shard):
            seen.append(("canary split", shard))

    import multiverso_tpu_torch.shard.reshard as reshard_mod
    monkeypatch.setattr(mvt, "clone_fleet", clone)
    monkeypatch.setattr(reshard_mod, "MigrationCoordinator", _CanaryCoord)
    mvt.set_flag("autopilot_blue_green", True)
    mvt.set_flag("device", "cuda")
    group = _Group()
    group.device = "cpu"
    coord = _Coord()
    out = Actuators(group, coordinator=coord).execute(
        Decision(action="split", shard=0, risky=True))
    assert out["ok"], out
    assert seen == [(group, "cpu"), ("canary split", 0)]
    assert canary.stopped and coord.calls == [("split", 0)]


# -- the control loop over fakes ----------------------------------------------

def _fake_pilot(decision=None, auditor=None, group=None, actuators=None):
    group = group if group is not None else _Group()
    rec = _Recorder()
    return Autopilot(
        group, interval=0, detector=_Detector(),
        sensors=FleetSensors(group, recorder=rec, auditor=auditor,
                             probe=lambda ep, timeout=2.0: {"lag": 0}),
        policy=_ForcedPolicy(decision) if decision is not None else None,
        actuators=actuators if actuators is not None else Actuators(group),
        interlock=SafetyInterlock(auditor))


def test_autopilot_tick_records_history_and_frozen_skips():
    pilot = _fake_pilot()
    rec = pilot.tick_now(now=1.0)
    assert rec["action"] == "none" and pilot.ticks == 1
    assert rec["decision"]["reason"] == "fleet within all envelopes"
    assert Dashboard.counter_value("AUTOPILOT_TICKS") == 1
    pilot.interlock.freeze("drill")
    rec = pilot.tick_now(now=2.0)
    assert rec["action"] == "frozen"
    assert Dashboard.counter_value("AUTOPILOT_FROZEN_SKIPS") == 1
    assert len(pilot.history) == 2
    assert pilot.status()["interlock"]["frozen"]


def test_autopilot_executes_decision_and_dumps_flight_record(tmp_path):
    flight = str(tmp_path / "flight.jsonl")
    mvt.set_flag("flight_recorder_path", flight)
    group = _Group()
    pilot = _fake_pilot(decision=Decision(action="add_replica", shard=0,
                                          reason="drill"), group=group)
    rec = pilot.tick_now(now=1.0)
    assert rec["outcome"]["ok"] and group.calls == [("add", 0)]
    assert pilot.policy.recorded == ["add_replica"]  # cooldown stamped
    with open(flight, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    dumps = [e for e in events if e.get("reason") == "autopilot_decision"]
    assert dumps and dumps[0]["decision"]["action"] == "add_replica"
    assert dumps[0]["outcome"]["ok"] is True
    assert "sense" in dumps[0] and "policy" in dumps[0]


def test_autopilot_failed_action_still_cools_down():
    class _Bad(_Group):
        def add_replica(self, shard, timeout=120.0):
            raise RuntimeError("spawn failed (drill)")

    group = _Bad()
    pilot = _fake_pilot(decision=Decision(action="add_replica", shard=0),
                        group=group)
    rec = pilot.tick_now(now=1.0)
    assert rec["outcome"]["ok"] is False
    # a failed migration must not be retried every tick
    assert pilot.policy.recorded == ["add_replica"]


def test_autopilot_kill_hook_freezes_loop(monkeypatch):
    monkeypatch.setenv("MV_AUTOPILOT_KILL", "before")
    group = _Group()
    pilot = _fake_pilot(decision=Decision(action="add_replica", shard=0),
                        group=group)
    rec = pilot.tick_now(now=1.0)
    assert rec["outcome"]["killed"] and rec["outcome"]["ok"] is False
    assert pilot.interlock.frozen and pilot._stop.is_set()
    assert group.calls == []       # killed BEFORE the dispatch
    # the latch outlives the chaos env: still frozen, still skipping
    monkeypatch.delenv("MV_AUTOPILOT_KILL")
    assert pilot.tick_now(now=2.0)["action"] == "frozen"


def test_autopilot_kill_spec_filters_by_action(monkeypatch):
    monkeypatch.setenv("MV_AUTOPILOT_KILL", "before:split")
    group = _Group()
    pilot = _fake_pilot(decision=Decision(action="add_replica", shard=0),
                        group=group)
    rec = pilot.tick_now(now=1.0)  # spec names split: add_replica runs
    assert rec["outcome"]["ok"] and group.calls == [("add", 0)]
    assert not pilot.interlock.frozen


def test_autopilot_module_is_the_callable_entrypoint():
    """``mvt.autopilot`` before and after the package import: both build
    the same loop (the module rebinds the attribute to itself)."""
    import importlib
    module = importlib.import_module("multiverso_tpu_torch.autopilot")
    assert callable(module)
    group = _Group()
    pilot = mvt.autopilot(group, interval=0, detector=_Detector(),
                          sensors=FleetSensors(
                              group, recorder=_Recorder(),
                              probe=lambda ep, timeout=2.0: {}))
    assert isinstance(pilot, Autopilot) and not pilot.status()["running"]
    assert pilot.tick_now(now=1.0)["action"] == "none"


# -- parity with the JAX package ----------------------------------------------

#: one flag posture in both registries (the policies read theirs at
#: construction, the detectors at construction, the tier rules live)
_PARITY_FLAGS = {"autopilot_hysteresis_ticks": 2,
                 "autopilot_cooldown_seconds": 3.0,
                 "autopilot_window_seconds": 4.0,
                 "autopilot_max_replicas": 2,
                 "autopilot_min_replicas": 0,
                 "autopilot_hedge_rate": 5.0,
                 "autopilot_scaledown_qps": 1.0,
                 "autopilot_tier_target_hit_rate": 0.9,
                 "autopilot_tier_step_bytes": 1 << 20,
                 "autopilot_tier_max_bytes": 6 << 20,
                 "tier_resident_bytes": 4 << 20,
                 "reshard_hot_ratio": 3.0,
                 "reshard_min_qps": 2.0,
                 "reshard_cold_qps": 0.5}

_RATE_NAMES = ("READ_HEDGES", "READ_REPLICA_REFUSALS_SEEN",
               "READ_PRIMARY_FALLBACKS", "SHED_ADDS", "SHED_GETS",
               "TIER_HOT_HITS", "TIER_COLD_HITS")


def _set_both(flags):
    for name, value in flags.items():
        JFLAGS.set(name, value)
        FLAGS.set(name, value)


def _telemetry(seed, ticks, shards=4):
    """One seeded sequence of recorder contents a tick: per-shard request
    counts in the window (one hot or cold stretch at a time, so streaks
    build and break), read-tier, shedding and tier rates, resident
    bytes, and the worst replica lag per probed endpoint."""
    rng = np.random.default_rng(seed)
    out = []
    mode = None
    for _ in range(ticks):
        if mode is None or rng.random() < 0.3:
            mode = ["hot", "cold", "pressure", "idle", "tier", "mixed"][
                int(rng.integers(0, 6))]
        counts = {k: int(rng.integers(20, 60)) for k in range(shards)}
        rates = {n: 0.0 for n in _RATE_NAMES}
        if mode == "hot":
            counts[int(rng.integers(0, shards))] = int(rng.integers(400, 900))
        elif mode == "cold":
            counts = {k: int(rng.integers(0, 2)) for k in range(shards)}
        elif mode == "pressure":
            rates["READ_HEDGES"] = float(rng.integers(3, 12))
            rates["SHED_GETS"] = float(rng.integers(0, 2))
        elif mode == "idle":
            counts = {k: 0 for k in range(shards)}
        elif mode == "tier":
            rates["TIER_HOT_HITS"] = float(rng.integers(1, 20))
            rates["TIER_COLD_HITS"] = float(rng.integers(0, 6))
        else:
            for n in _RATE_NAMES:
                rates[n] = float(rng.integers(0, 4))
        gauges = {"TIER_RESIDENT_BYTES": float(rng.integers(0, 4) << 20)}
        lags = {ep: int(rng.integers(0, 3)) for ep in ("r:0", "r:1")}
        out.append((1000.0 + 2.0 * len(out), counts, rates, gauges, lags))
    return out


class _SeqRecorder(_Recorder):
    def load(self, tick):
        _, self.shard_counts, self.rates, self.gauges, _ = tick


class _ParityGroup(_Group):
    """Fake group whose split/merge (through :class:`_ParityCoord`)
    reshape ``num_shards`` and the replica lists, so the loop judges the
    new topology on its next tick."""

    def add_replica(self, shard, timeout=120.0):
        self.calls.append(("add", shard))
        self.replica_endpoints[shard].append(f"r:{len(self.calls) % 2}")
        return self.replica_endpoints[shard][-1]

    def remove_replica(self, shard, index=None):
        self.calls.append(("remove", shard))
        return self.replica_endpoints[shard].pop()


class _ParityCoord:
    def __init__(self, group, error):
        self.group, self.error = group, error

    def split(self, shard):
        self.group.calls.append(("split", shard))
        if len(self.group.calls) % 5 == 4:
            raise self.error("cutover failed (drill)")
        self.group.num_shards += 1
        self.group.replica_endpoints.insert(shard + 1, [])

    def merge(self, shard):
        self.group.calls.append(("merge", shard))
        self.group.num_shards -= 1
        self.group.replica_endpoints[shard] += \
            self.group.replica_endpoints.pop(shard + 1)


def _drive_loop(pkg, seq, flight):
    """One package's full control loop (real sensors, detector, policy,
    interlock and actuators over the fakes) through ``seq``."""
    if pkg == "jax":
        classes = (JAutopilot, JFleetSensors, JActuators, JSafetyInterlock,
                   jreshard.HotRangeDetector, jreshard.MigrationError)
        flags, counter = JFLAGS, jcount
    else:
        classes = (Autopilot, FleetSensors, Actuators, SafetyInterlock,
                   HotRangeDetector, MigrationError)
        flags, counter = FLAGS, count
    pilot_cls, sensors_cls, act_cls, lock_cls, det_cls, err = classes
    flags.set("flight_recorder_path", str(flight))
    group = _ParityGroup(num_shards=2)
    rec = _SeqRecorder()
    lags = {}
    detector = det_cls(2, recorder=rec, window_seconds=4.0)
    pilot = pilot_cls(
        group, interval=0, detector=detector,
        sensors=sensors_cls(group, recorder=rec, window=4.0,
                            probe=lambda ep, timeout=2.0: {
                                "lag": lags.get(ep, 0)}),
        actuators=act_cls(group, coordinator=_ParityCoord(group, err)),
        interlock=lock_cls())
    records = []
    for i, tick in enumerate(seq):
        rec.load(tick)
        lags.clear()
        lags.update(tick[4])
        if i in (25, 26):
            counter("AUDIT_DIVERGENCE")      # a divergence, then a tick
        if i == 29:
            pilot.ack("parity")
        record = pilot.tick_now(now=tick[0])
        if record.get("outcome"):
            record["outcome"].pop("seconds", None)     # clock readings
        if record.get("interlock"):
            record["interlock"].pop("frozen_since", None)
        records.append(record)
    events = []
    for line in flight.read_text().splitlines():
        event = json.loads(line)
        if event.get("kind") == "event" and \
                event["reason"].startswith("autopilot_"):
            event.pop("t_ns")
            (event.get("outcome") or {}).pop("seconds", None)
            events.append(event)
    return records, group.calls, group.num_shards, events, \
        flags.get("tier_resident_bytes")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_loop_parity_with_jax_on_a_seeded_sequence(tmp_path, seed):
    _set_both(_PARITY_FLAGS)
    seq = _telemetry(seed, 48)
    want = _drive_loop("jax", copy.deepcopy(seq), tmp_path / "jax.jsonl")
    got = _drive_loop("torch", copy.deepcopy(seq), tmp_path / "torch.jsonl")
    assert got[0] == want[0]                 # every tick record
    assert got[1:3] == want[1:3]             # the fleet calls, the shards
    assert got[3] == want[3]                 # flight records, t_ns aside
    assert got[4] == want[4]                 # the tier budget it left
    acted = {r["action"] for r in got[0]}
    assert "frozen" in acted and len(acted - {"none", "frozen"}) >= 2, acted
    for name in ("AUTOPILOT_TICKS", "AUTOPILOT_ACTIONS",
                 "AUTOPILOT_ACTION_FAILURES", "AUTOPILOT_FREEZES",
                 "AUTOPILOT_ACKS", "AUTOPILOT_FROZEN_SKIPS",
                 "RESHARD_PROPOSALS"):
        assert Dashboard.counter_value(name) == \
            JDashboard.counter_value(name), name


def test_policy_parity_with_jax_on_a_seeded_fleet_sense_sequence():
    """Decisions straight from FleetSense values (each package's class,
    the same fields) and real detectors over one scripted recorder, with
    outcomes recorded as the loop records them."""
    _set_both(_PARITY_FLAGS)
    seq = _telemetry(7, 64, shards=3)
    recs = (_SeqRecorder(), _SeqRecorder())
    pols = (JAutopilotPolicy(jreshard.HotRangeDetector(
                3, recorder=recs[0], window_seconds=4.0)),
            AutopilotPolicy(HotRangeDetector(
                3, recorder=recs[1], window_seconds=4.0)))
    rng = np.random.default_rng(7)
    for tick in seq:
        for rec in recs:
            rec.load(tick)
        fields = dict(now=tick[0],
                      shard_rates=[tick[1][k] / 4.0 for k in range(3)],
                      total_qps=sum(tick[1].values()) / 4.0,
                      read_pressure=tick[2]["READ_HEDGES"],
                      shed_rate=tick[2]["SHED_GETS"],
                      replica_lag={0: int(rng.integers(0, 3))},
                      replica_counts=[int(c) for c in
                                      rng.integers(0, 3, 3)],
                      tier_hit_rate=(None if rng.random() < 0.4
                                     else float(rng.random())),
                      tier_resident_bytes=tick[3]["TIER_RESIDENT_BYTES"])
        want = pols[0].decide(JFleetSense(**fields))
        got = pols[1].decide(FleetSense(**fields))
        assert got.as_dict() == want.as_dict()
        if got.action != "none" and rng.random() < 0.7:
            for pol in pols:
                pol.record_action(got.action, now=tick[0])
        assert pols[1].state_snapshot(tick[0]) == \
            pols[0].state_snapshot(tick[0])


def test_interlock_parity_with_jax():
    class _Aud:
        def __init__(self):
            self.divergent = False

        def status(self):
            return {"divergent": self.divergent}

    auds = (_Aud(), _Aud())
    locks = (JSafetyInterlock(auds[0]), SafetyInterlock(auds[1]))
    counters = (jcount, count)
    rng = np.random.default_rng(3)
    for _ in range(200):
        op = int(rng.integers(0, 4))
        for side in (0, 1):
            if op == 0:
                counters[side]("AUDIT_DIVERGENCE")
            elif op == 1:
                auds[side].divergent = not auds[side].divergent
            elif op == 2:
                locks[side].ack("parity")
        got = locks[1].check()
        assert got == locks[0].check()
        want_s, got_s = locks[0].status(), locks[1].status()
        want_s.pop("frozen_since"), got_s.pop("frozen_since")
        assert got_s == want_s
    for name in ("AUTOPILOT_FREEZES", "AUTOPILOT_ACKS"):
        assert Dashboard.counter_value(name) == \
            JDashboard.counter_value(name) > 0
    assert Dashboard.gauge_value("AUTOPILOT_FROZEN") == \
        JDashboard.gauge_value("AUTOPILOT_FROZEN")


def test_actuators_parity_with_jax(monkeypatch):
    decisions = [dict(action="add_replica", shard=1),
                 dict(action="split", shard=0, risky=True),
                 dict(action="remove_replica", shard=1),
                 dict(action="merge", shard=1, risky=True),
                 dict(action="tier_up", params={"from": 1, "to": 4096}),
                 dict(action="tier_down", params={"from": 4096, "to": 512}),
                 dict(action="remove_replica", shard=0),
                 dict(action="teleport", shard=0)]
    outs = []
    for classes in ((JActuators, JDecision, jreshard.MigrationError),
                    (Actuators, Decision, MigrationError)):
        act_cls, dec_cls, err = classes
        group = _ParityGroup(num_shards=2)
        act = act_cls(group, coordinator=_ParityCoord(group, err))
        got = []
        for d in decisions:
            out = act.execute(dec_cls(**d))
            out.pop("seconds")
            got.append(out)
        outs.append((got, group.calls, group.replica_endpoints))
    assert outs[1] == outs[0]
    assert JFLAGS.get("tier_resident_bytes") == \
        FLAGS.get("tier_resident_bytes") == 512
    monkeypatch.setenv("MV_AUTOPILOT_KILL", "mid:add_replica")
    errors = []
    for act_cls, dec_cls, killed in ((JActuators, JDecision,
                                      JAutopilotKilled),
                                     (Actuators, Decision, AutopilotKilled)):
        group = _Group()
        with pytest.raises(killed) as info:
            act_cls(group).execute(dec_cls(action="add_replica", shard=0))
        errors.append((str(info.value), group.calls))
    assert errors[1] == errors[0]
    assert errors[0][1] == [("add", 0)]     # 'mid': the action committed


# -- live: replica membership through the manifest ----------------------------

def _wait_caught_up(replica, primary, timeout=60.0):
    primary_wm = fetch_digest(primary, timeout=30.0)["watermark"]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fetch_digest(replica, timeout=30.0)["watermark"] >= primary_wm:
            return True
        time.sleep(0.1)
    return False


def test_live_add_and_remove_replica_republishes_manifest(tmp_path):
    tables = [{"kind": "matrix", "num_row": 16, "num_col": 2}]
    with ShardGroup(tables, shards=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        mat.add(np.ones((16, 2), np.float32))

        ep = group.add_replica(0)
        assert group.replica_endpoints[0] == [ep]
        assert group.layout.manifest["replicas"][0] == [ep]
        # replica membership never bumps the layout version (no key
        # ownership moved; in-flight stamped requests stay valid)
        assert group.layout.manifest["layout_version"] == 1
        assert _wait_caught_up(ep, group.endpoints[0]), \
            "live-added replica never caught up"

        removed = group.remove_replica(0)
        assert removed == ep
        assert group.replica_endpoints[0] == []
        assert group.layout.manifest["replicas"][0] == []
        # the primary still serves
        np.testing.assert_array_equal(mat.get(),
                                      np.ones((16, 2), np.float32))
        client.close()


# -- live: the Zipf-shift acceptance drill ------------------------------------

def _zipf_flags(flags):
    for name, value in (("autopilot_hysteresis_ticks", 1),
                        ("autopilot_window_seconds", 4.0),
                        ("autopilot_hedge_rate", 1.0),
                        ("reshard_cold_qps", 0.0),   # no merges here
                        ("reshard_min_qps", 1.0),
                        ("reshard_hot_ratio", 2.0)):
        flags.set(name, value)


def test_autopilot_zipf_shift_splits_hot_shard_then_adds_replica(tmp_path):
    """The acceptance drill: traffic concentrates on shard 0, the
    autopilot reads its own telemetry and SPLITS the hot shard through
    the live migration machinery while writers stream; read-tier
    pressure then drives an add_replica — with zero acknowledged-Add
    loss (bitwise mirror equality). It ticks only once at least 8 Adds
    acknowledged inside the window reached shard 0."""
    _zipf_flags(FLAGS)
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4}]
    recorder = TimeSeriesRecorder(interval=3600.0, samples=16)
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        model = np.zeros((32, 4), np.float32)
        stop = threading.Event()
        lock = threading.Lock()
        acked = [0]
        errors = []

        def writer(seed):
            # the hotspot: every write lands in rows [0, 16) == shard 0
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    ids = rng.choice(16, 6, replace=False).astype(np.int32)
                    vals = rng.integers(0, 5, (6, 4)).astype(np.float32)
                    mat.add(vals, row_ids=ids)
                    with lock:
                        model[ids] += vals
                        acked[0] += 1
                    time.sleep(0.005)
            except BaseException as err:  # noqa: BLE001 — reported below
                errors.append(err)

        threads = [threading.Thread(target=writer, args=(s,), daemon=True)
                   for s in (1, 2)]
        pilot = mvt.autopilot(group, interval=0, recorder=recorder)
        before = copy.deepcopy(group.layout.manifest)
        recorder.sample_now(t=100.0)
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while acked[0] < 8:                # Adds, not seconds
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        recorder.sample_now(t=104.0)   # the window now shows the hotspot
        hist = recorder.window_histogram("ROUTER_SHARD0_SECONDS", 4.0)
        assert hist is not None and hist.count >= 8

        rec1 = pilot.tick_now(now=104.0)
        assert rec1["action"] == "split", rec1
        assert rec1["decision"]["shard"] == 0 and rec1["outcome"]["ok"]
        assert group.num_shards == 3
        # the new layout is the JAX package's split of the same spans
        plan = jreshard.plan_split(before, 0)
        after = group.layout.manifest
        assert after["num_shards"] == plan.new_manifest["num_shards"] == 3
        assert after["layout_version"] == plan.new_version == 2
        assert [t["partitioner"] for t in after["tables"]] == \
            [t["partitioner"] for t in plan.new_manifest["tables"]]

        mark = acked[0]
        deadline = time.monotonic() + 60
        while acked[0] < mark + 8:     # keep writing on the new layout
            assert time.monotonic() < deadline and not errors, errors
            time.sleep(0.02)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors

        # the read tier comes under pressure (hedge telemetry is the
        # replica-scaling signal; the counter bump stands in for the
        # hedged-read machinery the read tests exercise)
        recorder.sample_now(t=108.0)
        count("READ_HEDGES", 40)
        recorder.sample_now(t=112.0)
        rec2 = pilot.tick_now(now=112.0)
        assert rec2["action"] == "add_replica", rec2
        assert rec2["outcome"]["ok"], rec2
        added = rec2["outcome"]["detail"]["endpoint"]
        shard = rec2["decision"]["shard"]
        assert group.replica_endpoints[shard] == [added]
        assert Dashboard.counter_value("AUTOPILOT_ACTIONS") == 2

        # zero acknowledged-Add loss across the autopilot's actions
        np.testing.assert_array_equal(mat.get(), model)
        assert client.layout.layout_version == 2
        client.close()

        # a fresh client bootstraps onto the autopilot-reshaped fleet
        c2 = group.connect()
        assert c2.layout.num_shards == 3
        np.testing.assert_array_equal(c2.tables()[0].get(), model)
        c2.close()
        pilot.stop()


# -- live: the seeded-divergence interlock drill ------------------------------

def test_audit_divergence_freezes_running_autopilot_until_ack(tmp_path,
                                                              monkeypatch):
    """Seeded MV_AUDIT_CORRUPT divergence must freeze a RUNNING autopilot
    before its next action, and only an explicit operator ack unfreezes
    it (persisting divergence refreezes on the very next tick — an ack
    is consent to resume, not a mute)."""
    flight = str(tmp_path / "flight.jsonl")
    mvt.set_flag("flight_recorder_path", flight)
    monkeypatch.setenv("MV_AUDIT_CORRUPT", "0:7:2")  # table 0 row 7
    with ShardGroup([{"kind": "sparse", "key_space": 100, "width": 2}],
                    shards=1, replicas=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        monkeypatch.delenv("MV_AUDIT_CORRUPT")  # children already armed
        client = group.connect()
        (sp,) = client.tables()
        sp.add(np.array([7], np.int64), np.ones((1, 2), np.float32))
        sp.add(np.array([9], np.int64), np.ones((1, 2), np.float32))
        _wait_caught_up(group.replica_endpoints[0][0], group.endpoints[0])

        auditor = mvt.audit(group, interval=0.2)
        # a RUNNING autopilot with a queued action every tick; recording
        # actuators prove no action ever crosses a frozen interlock
        group_probe = _Group()
        pilot = mvt.autopilot(
            group, interval=0, auditor=auditor,
            actuators=Actuators(group_probe),
            policy=_ForcedPolicy(Decision(action="add_replica", shard=0,
                                          reason="drill pressure")))
        assert pilot.tick_now()["outcome"]["ok"]  # pre-divergence: acts
        assert group_probe.calls == [("add", 0)]

        try:
            deadline = time.monotonic() + 30.0
            while (Dashboard.counter_value("AUDIT_DIVERGENCE") == 0
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            assert Dashboard.counter_value("AUDIT_DIVERGENCE") > 0

            rec = pilot.tick_now()           # the next action is due...
            assert rec["action"] == "frozen"  # ...and never dispatches
            assert group_probe.calls == [("add", 0)]
            assert Dashboard.gauge_value("AUTOPILOT_FROZEN") == 1

            # no amount of further ticking unfreezes it
            assert pilot.tick_now()["action"] == "frozen"
            assert Dashboard.counter_value("AUTOPILOT_FROZEN_SKIPS") >= 2

            # the explicit operator ack is the ONLY unfreeze
            pilot.ack(operator="drill-oncall")
            assert not pilot.interlock.frozen
            assert Dashboard.counter_value("AUTOPILOT_ACKS") == 1
            # the corrupted replica still diverges: the next tick
            # refreezes instead of acting on a sick fleet
            assert pilot.tick_now()["action"] == "frozen"
            assert group_probe.calls == [("add", 0)]
        finally:
            auditor.stop()
        client.close()
    with open(flight, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    frozen = [e for e in events if e.get("kind") == "event"
              and e.get("reason") == "autopilot_frozen"]
    assert frozen and "AUDIT_DIVERGENCE" in frozen[0]["why"]


# -- live: MV_AUTOPILOT_KILL chaos arm ----------------------------------------

@pytest.mark.skipif(os.environ.get("MV_AUTOPILOT_KILL")
                    not in ("before", "mid"),
                    reason="chaos drill: set MV_AUTOPILOT_KILL="
                           "before|mid (ci chaos matrix)")
def test_autopilot_killed_mid_action_leaves_fleet_consistent(tmp_path):
    """The controller dies before ('before') or right after ('mid') the
    crash-safe operation: either way the fleet stays consistent with
    zero acked-Add loss, and the loop latches frozen."""
    stage = os.environ["MV_AUTOPILOT_KILL"]
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4}]
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        model = np.zeros((32, 4), np.float32)
        stop = threading.Event()
        lock = threading.Lock()

        def writer(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                ids = rng.choice(32, 6, replace=False).astype(np.int32)
                vals = rng.integers(0, 5, (6, 4)).astype(np.float32)
                mat.add(vals, row_ids=ids)
                with lock:
                    model[ids] += vals
                time.sleep(0.005)

        threads = [threading.Thread(target=writer, args=(s,), daemon=True)
                   for s in (1, 2)]
        for t in threads:
            t.start()
        time.sleep(1.0)

        pilot = mvt.autopilot(
            group, interval=0,
            policy=_ForcedPolicy(Decision(action="split", shard=0,
                                          risky=True, reason="chaos")))
        rec = pilot.tick_now()
        assert rec["outcome"]["killed"] and pilot.interlock.frozen
        expected_shards = {"before": 2, "mid": 3}[stage]
        assert group.num_shards == expected_shards
        assert pilot.tick_now()["action"] == "frozen"

        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)

        np.testing.assert_array_equal(mat.get(), model)
        client.close()
        c2 = group.connect()
        assert c2.layout.num_shards == expected_shards
        np.testing.assert_array_equal(c2.tables()[0].get(), model)
        c2.close()


# -- the slice as a whole: both packages' autopilots on live groups -----------

#: the scripted recorder samples both loops read: shard 0 hot (a split),
#: then read-tier pressure (a replica), then calm
_SCRIPT = ({0: 40}, {}, {"READ_HEDGES": 10.0}, {}, {})


def _whole_slice(pkg, tmp_path, batches):
    """Start a 2-shard group of ``pkg``, write ``batches`` in three
    stretches around two scripted ticks and a calm third one; returns
    the actions, the layout, the table and the replica count a shard."""
    if pkg == "jax":
        group_cls, autopilot, flags = JShardGroup, mv.autopilot, JFLAGS
        kw = {}
    else:
        group_cls, autopilot, flags = ShardGroup, mvt.autopilot, FLAGS
        kw = {"device": "cpu"}
    _zipf_flags(flags)
    flags.set("autopilot_scaledown_qps", 0.0)   # keep the new replica
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4}]
    rec = _Recorder(window=4.0)
    with group_cls(tables, shards=2, durable=True,
                   base_dir=str(tmp_path / pkg), flags=dict(GROUP_FLAGS),
                   **kw) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        pilot = autopilot(group, interval=0, recorder=rec)
        actions = []
        for step, (counts, rates) in enumerate(((_SCRIPT[0], _SCRIPT[1]),
                                                (_SCRIPT[3], _SCRIPT[2]),
                                                (_SCRIPT[4], {}))):
            for ids, vals in batches[step]:
                mat.add(vals, row_ids=ids)
            rec.shard_counts, rec.rates = counts, rates
            record = pilot.tick_now(now=100.0 + 10.0 * step)
            outcome = record.get("outcome") or {}
            actions.append((record["action"],
                            record.get("decision", {}).get("shard"),
                            outcome.get("ok")))
        table = np.asarray(mat.get(), np.float32)
        client.close()
        c2 = group.connect()
        fresh = np.asarray(c2.tables()[0].get(), np.float32)
        c2.close()
        manifest = group.layout.manifest
        layout = {"num_shards": manifest["num_shards"],
                  "layout_version": manifest["layout_version"],
                  "partitioners": [t["partitioner"]
                                   for t in manifest["tables"]],
                  "replicas": [len(r) for r in manifest["replicas"]]}
        pilot.stop()
    return actions, layout, table, fresh


def test_both_packages_autopilots_take_the_same_actions(tmp_path):
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(3):
        stretch = []
        for _ in range(6):
            ids = np.sort(rng.choice(16, 6, replace=False)).astype(np.int32)
            stretch.append((ids, rng.integers(0, 5, (6, 4)).astype(
                np.float32)))
        batches.append(stretch)
    mirror = np.zeros((32, 4), np.float32)
    for stretch in batches:
        for ids, vals in stretch:
            mirror[ids] += vals
    want = _whole_slice("jax", tmp_path, batches)
    got = _whole_slice("torch", tmp_path, batches)
    assert want[0] == [("split", 0, True), ("add_replica", 0, True),
                       ("none", None, None)]
    assert got[0] == want[0]                 # the same actions, in order
    assert got[1] == want[1]                 # the same layout
    assert got[1]["num_shards"] == 3 and got[1]["replicas"] == [1, 0, 0]
    for table in (want[2], want[3], got[2], got[3]):
        np.testing.assert_array_equal(table, mirror)
