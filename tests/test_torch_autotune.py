"""Twins of ``tests/test_autotune.py`` on the port: the config watch seam,
the live knobs the tuner steps, the sensors, the rule table, the
``KnobController`` (``multiverso_tpu_torch/tune/``) and the bit-identity
contract with ``autotune`` off.

Two live knobs were repaired for this slice: the port read
``wire_shm_spin`` once when a ring was mapped and ``wire_coalesce_*``
once when a net was built, so a tuner step on them did nothing. The
cases below hold both live, down to the wait ladder and the vectored
send.

Parity: one seeded synthetic profiler-and-recorder sequence (fakes built
from numpy, as the reference tests build them) goes through both
packages' sensors, rules and controllers; the proposals, steps,
verdicts, knob values and flight-record fields (timestamps aside) are
equal, exactly.
"""

import json
import time

import numpy as np
import pytest
import torch

from multiverso_tpu.config import FLAGS as JFLAGS
from multiverso_tpu.tune import KnobController as JKnobController
from multiverso_tpu.tune import rules as jrules
from multiverso_tpu.tune.sensors import TuneSensors as JTuneSensors

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import config
from multiverso_tpu_torch.config import FLAGS, FlagError
from multiverso_tpu_torch.dashboard import Dashboard, gauge_set
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tune import KnobController
from multiverso_tpu_torch.tune.rules import (ACTIONABLE_SITES, KnobStep,
                                             Rule, actionable_dominant,
                                             default_rules)
from multiverso_tpu_torch.tune.sensors import TuneSense, TuneSensors


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread; whatever a test starts is stopped (tests/conftest.py
    resets the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    FLAGS.reset()
    FLAGS.set("device", "cpu")
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
        mvt._stop_autotune()
    finally:
        Zoo._reset_instance()
        FLAGS.reset()
        torch.set_num_threads(threads)


# -- config watch seam --------------------------------------------------------

def test_on_change_fires_on_value_change_only():
    seen = []
    unsub = config.on_flag_change(
        "read_hedge_ms", lambda name, value: seen.append((name, value)))
    try:
        mvt.set_flag("read_hedge_ms", config.get_flag("read_hedge_ms"))
        assert seen == []                       # same value: no fire
        mvt.set_flag("read_hedge_ms", 123)
        assert seen == [("read_hedge_ms", 123.0)]   # coerced value
        mvt.set_flag("read_hedge_ms", 123)
        assert len(seen) == 1                   # redundant set: no fire
        FLAGS.reset()
        assert seen[-1] == ("read_hedge_ms", 0.0)   # reset fires too
    finally:
        unsub()


def test_on_change_unsubscribe_and_unknown_flag():
    seen = []
    unsub = config.on_flag_change("read_hedge_ms",
                                  lambda n, v: seen.append(v))
    mvt.set_flag("read_hedge_ms", 5)
    unsub()
    mvt.set_flag("read_hedge_ms", 9)
    assert seen == [5.0]
    with pytest.raises(FlagError):
        config.on_flag_change("no_such_flag", lambda n, v: None)


def test_on_change_exception_does_not_poison_set_flag():
    seen = []

    def broken(_name, _value):
        raise RuntimeError("watcher bug")

    unsubs = [config.on_flag_change("read_hedge_ms", broken),
              config.on_flag_change("read_hedge_ms",
                                    lambda n, v: seen.append(v))]
    try:
        mvt.set_flag("read_hedge_ms", 7)        # must not raise
        assert config.get_flag("read_hedge_ms") == 7.0
        assert seen == [7.0]                    # later watchers still fire
    finally:
        for unsub in unsubs:
            unsub()


def test_parse_cmd_flags_fires_watchers():
    seen = []
    unsub = config.on_flag_change("apply_batch_msgs",
                                  lambda n, v: seen.append(v))
    try:
        config.parse_cmd_flags(["-apply_batch_msgs=33"])
        assert seen == [33]
    finally:
        unsub()


# -- live knobs: hot paths re-read through the seam ---------------------------

def test_shm_spin_budget_is_live():
    from multiverso_tpu_torch.runtime import shm
    assert shm._spin_live[0] == int(config.get_flag("wire_shm_spin"))
    mvt.set_flag("wire_shm_spin", 0)
    assert shm._spin_live[0] == 0
    mvt.set_flag("wire_shm_spin", 64)
    assert shm._spin_live[0] == 64


def test_shm_spin_budget_moves_the_wait_ladder(monkeypatch):
    """The live budget reaches the ring's wait path: under a budget of
    64 the first idle polls spin (no sleep call at all); at 0 the very
    first idle poll yields; the yield band keeps its width either way."""
    from multiverso_tpu_torch.runtime import shm
    sleeps = []
    monkeypatch.setattr(shm.time, "sleep", sleeps.append)
    mvt.set_flag("wire_shm_spin", 64)
    shm._sleep_for(1)
    shm._sleep_for(63)
    assert sleeps == []                     # pure spin below the edge
    shm._sleep_for(64)
    assert sleeps == [0]                    # the yield band starts there
    mvt.set_flag("wire_shm_spin", 0)
    sleeps.clear()
    shm._sleep_for(1)
    assert sleeps == [0]                    # no spin left: yield at once
    band = shm._YIELD - shm._SPIN
    shm._sleep_for(band)
    assert sleeps[-1] > 0                   # past the band: a real sleep


def test_net_coalesce_caps_are_live_and_unsubscribe_on_finalize():
    from multiverso_tpu_torch.runtime.net import TcpNet
    net = TcpNet()
    try:
        assert net._coalesce_frames == int(
            config.get_flag("wire_coalesce_frames"))
        assert net._coalesce_bytes == int(
            config.get_flag("wire_coalesce_bytes"))
        mvt.set_flag("wire_coalesce_frames", 128)
        mvt.set_flag("wire_coalesce_bytes", 1 << 16)
        assert (net._coalesce_frames, net._coalesce_bytes) == (128, 1 << 16)
        assert net._coalesce                    # the mode stays as built
    finally:
        net.finalize()
    mvt.set_flag("wire_coalesce_frames", 7)   # finalized net: unsubscribed
    assert net._coalesce_frames == 128


def test_coalesce_cap_lowered_live_splits_the_next_burst():
    """A cap stepped down on a live connection reshapes the next
    vectored send: a held burst of 31 async Adds drains in batches of at
    most 4 frames each way (one batch of 31 under the default cap), and
    the table is bitwise the sum of the deltas."""
    mvt.init(remote_workers=1, heartbeat_seconds=0)
    table = mvt.create_table("matrix", num_row=32, num_col=4)
    client = mvt.remote_connect(mvt.serve("127.0.0.1:0"))
    try:
        rt = client.table(table.table_id)
        rng = np.random.default_rng(1)
        deltas = rng.integers(-3, 4, size=(32, 32, 4)).astype(np.float32)
        rt.add(deltas[0])                   # dials, settles registration
        cnet = client._net
        csock = cnet._conns[0]
        snet = Zoo.instance().remote_server._net
        deadline = time.monotonic() + 10
        while not snet._accepted:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ssock = snet._accepted[0]
        mvt.set_flag("wire_coalesce_frames", 4)   # live, both nets
        Dashboard.reset()
        cnet._hold_sends(csock)
        snet._hold_sends(ssock)
        handles = [rt.add_async(d) for d in deltas[1:]]
        for net, sock in ((cnet, csock), (snet, ssock)):
            state = net._state_for(sock)
            while len(state.frames) < len(handles):
                assert time.monotonic() < deadline, "frames never queued"
                time.sleep(0.01)
            net._release_sends(sock)
        for h in handles:
            rt.wait(h)
        frames = Dashboard.counter_value("SEND_COALESCED_FRAMES")
        syscalls = Dashboard.counter_value("SEND_SYSCALLS")
        assert frames >= 62
        assert syscalls >= 2 * ((31 + 3) // 4), (frames, syscalls)
        np.testing.assert_array_equal(np.asarray(rt.get(), np.float32),
                                      deltas.sum(axis=0))
    finally:
        client.close()


def test_server_apply_batch_cap_is_live():
    from multiverso_tpu_torch.runtime.server import Server
    srv = Server(num_workers=1)
    try:
        assert srv._apply_batch_cap == int(
            config.get_flag("apply_batch_msgs"))
        mvt.set_flag("apply_batch_msgs", 7)
        assert srv._apply_batch_cap == 7
        mvt.set_flag("apply_batch_msgs", 0)
        assert srv._apply_batch_cap == 0
    finally:
        srv.stop()
    mvt.set_flag("apply_batch_msgs", 99)    # stopped server: unsubscribed
    assert srv._apply_batch_cap == 0


def test_read_router_hedge_and_cache_are_live():
    from multiverso_tpu_torch.runtime.read import ReadCache, ReadRouter
    mvt.set_flag("client_cache_bytes", 0)
    router = ReadRouter([], "primary", primary_submit=lambda *a: None)
    try:
        assert router.cache is None
        mvt.set_flag("read_hedge_ms", 250)
        assert router._hedge_ms == 250.0
        mvt.set_flag("client_cache_bytes", 1 << 20)   # created live
        assert isinstance(router.cache, ReadCache)
        assert router.cache.capacity == 1 << 20
        mvt.set_flag("client_cache_bytes", 4096)      # shrunk live
        assert router.cache.capacity == 4096
        mvt.set_flag("client_cache_bytes", 0)         # dropped live
        assert router.cache is None
    finally:
        router.close()
    mvt.set_flag("read_hedge_ms", 999)      # closed router: unsubscribed
    assert router._hedge_ms == 250.0


def test_read_router_explicit_cache_cap_stays_pinned():
    from multiverso_tpu_torch.runtime.read import ReadRouter
    router = ReadRouter([], "primary", primary_submit=lambda *a: None,
                        cache_bytes=8192)
    try:
        mvt.set_flag("client_cache_bytes", 1 << 20)
        assert router.cache.capacity == 8192
    finally:
        router.close()


def test_tiered_admit_bar_is_live(tmp_path):
    from multiverso_tpu_torch.store.tiered import TieredStore
    store = TieredStore(width=4, dtype=np.float32,
                        resident_bytes=1 << 20, directory=str(tmp_path))
    try:
        assert store.admit == int(config.get_flag("tier_admit_touches"))
        mvt.set_flag("tier_admit_touches", 1)
        assert store.admit == 1
    finally:
        store.close()
    pinned = TieredStore(width=4, dtype=np.float32, resident_bytes=1 << 20,
                         directory=str(tmp_path / "b"), admit_touches=5)
    try:
        mvt.set_flag("tier_admit_touches", 2)
        assert pinned.admit == 5            # explicit value stays pinned
    finally:
        pinned.close()


def test_resolve_tenant_cache_invalidates_on_spec_change():
    from multiverso_tpu_torch.runtime.admission import resolve_tenant
    mvt.set_flag("tenant_quota_spec", "alpha:tables=0,qps=10")
    assert resolve_tenant(0) == "alpha"
    mvt.set_flag("tenant_quota_spec", "beta:tables=0,qps=10")
    assert resolve_tenant(0) == "beta"      # cache dropped, not stale


# -- sensors ------------------------------------------------------------------

class _Profiler:
    def __init__(self):
        self.cumulative = {}

    def wait_seconds(self):
        return dict(self.cumulative)


class _Hist:
    def __init__(self, count, p99):
        self.count = count
        self._p99 = p99

    def quantile(self, q):
        return self._p99


class _Recorder:
    """TimeSeriesRecorder stand-in driven by plain dicts."""

    def __init__(self):
        self.rates = {}
        self.gauges = {}
        self.hist = None

    def rate(self, name, window):
        return float(self.rates.get(name, 0.0))

    def gauge(self, name):
        return float(self.gauges.get(name, 0.0))

    def window_histogram(self, name, window):
        return self.hist


def _sensors(profiler=None, recorder=None, window=10.0):
    return TuneSensors(recorder=recorder or _Recorder(),
                       profiler=profiler or _Profiler(), window=window)


def test_sensors_difference_wait_sites_per_window():
    prof = _Profiler()
    sensors = _sensors(profiler=prof)
    prof.cumulative = {"wal_fsync": 2.0, "net_recv": 0.5}
    first = sensors.read(now=1.0)
    assert first.wait == {"wal_fsync": 2.0, "net_recv": 0.5}
    prof.cumulative = {"wal_fsync": 2.1, "net_recv": 3.5}
    second = sensors.read(now=2.0)
    assert second.wait == pytest.approx({"wal_fsync": 0.1,
                                         "net_recv": 3.0})
    assert second.dominant_wait == "net_recv"


def test_sensors_objective_is_throughput_weighted_p99():
    rec = _Recorder()
    rec.hist = _Hist(count=500, p99=0.025)
    sense = _sensors(recorder=rec).read(now=1.0)
    assert sense.throughput == pytest.approx(50.0)      # 500 / 10s window
    assert sense.objective == pytest.approx(50.0 / 0.025)
    rec.hist = None
    assert _sensors(recorder=rec).read(now=1.0).objective == 0.0


# -- rule table ---------------------------------------------------------------

def _sense(**kw):
    return TuneSense(**kw)


def test_dominance_is_judged_among_actionable_sites():
    # an idle park (dispatcher_drain) dwarfing every real cost must not
    # blind the tuner: wal_fsync still wins among ACTIONABLE_SITES
    s = _sense(wait={"dispatcher_drain": 9.0, "wal_fsync": 0.4,
                     "net_recv": 0.1},
               dominant_wait="dispatcher_drain", dominant_wait_seconds=9.0)
    assert actionable_dominant(s) == ("wal_fsync", 0.4)
    rule = next(r for r in default_rules() if r.name == "wal_fsync")
    assert rule.predicate(s) is not None
    assert "dispatcher_drain" not in ACTIONABLE_SITES
    quiet = _sense(wait={"wal_fsync": 0.001})
    assert actionable_dominant(quiet) == ("", 0.0)       # below the floor
    assert rule.predicate(quiet) is None


def test_knob_step_bounds_and_ladder():
    up = KnobStep("apply_batch_msgs", "up", hi=64, seed=8)
    assert up.propose(0, _sense()) == 8                  # seeds from 0
    assert up.propose(8, _sense()) == 16                 # doubles
    assert up.propose(48, _sense()) == 64                # clamps at hi
    assert up.propose(64, _sense()) is None              # pinned
    down = KnobStep("wire_shm_spin", "down", lo=1)
    assert down.propose(8, _sense()) == 4
    assert down.propose(1, _sense()) is None
    ladder = KnobStep("wire_quant_bits", "ladder", ladder=(0, 8, 4, 2, 1))
    assert ladder.propose(0, _sense()) == 8
    assert ladder.propose(4, _sense()) == 2
    assert ladder.propose(1, _sense()) is None           # bottom rung


def test_hedge_rule_seeds_from_effective_delay():
    rule = next(r for r in default_rules() if r.name == "hedge")
    s = _sense(hedge_rate=10.0, hedge_win_rate=1.0,
               hedge_delay_seconds=0.004)
    assert rule.predicate(s) is not None
    assert rule.steps[0].propose(0, s) == pytest.approx(8.0)  # 2x in ms
    healthy = _sense(hedge_rate=10.0, hedge_win_rate=9.0)
    assert rule.predicate(healthy) is None


# -- controller ---------------------------------------------------------------

class _ScriptedSensors:
    """Sensor stand-in: each read() pops the next scripted TuneSense."""

    def __init__(self, senses):
        self.senses = list(senses)
        self.reads = 0

    def read(self, now=None):
        self.reads += 1
        sense = self.senses.pop(0) if self.senses else _sense()
        sense.now = float(now or 0.0)
        return sense


def _pressure(objective):
    return _sense(wait={"x": 1.0}, objective=objective)


def _rule(hi=64):
    return Rule("drill", lambda s: ("pressure" if s.wait.get("x") else None),
                [KnobStep("apply_batch_msgs", "up", hi=hi, seed=8)])


def _controller(senses, **kw):
    mvt.set_flag("apply_batch_msgs", 0)     # the drill knob seeds from 0
    kw.setdefault("hysteresis", 1)
    kw.setdefault("verify_ticks", 1)
    kw.setdefault("cooldown", 100.0)
    kw.setdefault("regress_pct", 5.0)
    return KnobController(sensors=_ScriptedSensors(senses),
                          rules=[_rule()], interval=0, **kw)


def test_controller_steps_then_commits():
    ctl = _controller([_pressure(100.0), _pressure(100.0),
                       _pressure(100.0)])
    r1 = ctl.tick_now(now=1.0)
    assert r1["action"] == "step"
    assert config.get_flag("apply_batch_msgs") == 8
    r2 = ctl.tick_now(now=2.0)
    assert r2["action"] == "commit"
    assert config.get_flag("apply_batch_msgs") == 8      # change kept
    assert (ctl.steps, ctl.commits, ctl.reverts) == (1, 1, 0)
    # the knob is now cooling down: a fresh match cannot re-step it
    r3 = ctl.tick_now(now=3.0)
    assert r3["action"] == "none"
    assert any("cooling down" in rej["reason"] for rej in r3["rejected"])
    assert Dashboard.gauge_value("TUNE_APPLY_BATCH_MSGS") == 8.0
    assert Dashboard.counter_value("TUNE_STEPS") >= 1
    assert Dashboard.counter_value("TUNE_COMMITS") >= 1


def test_controller_reverts_on_objective_regression():
    ctl = _controller([_pressure(100.0), _pressure(50.0)])
    ctl.tick_now(now=1.0)
    assert config.get_flag("apply_batch_msgs") == 8
    r2 = ctl.tick_now(now=2.0)
    assert r2["action"] == "revert"
    assert config.get_flag("apply_batch_msgs") == 0      # rolled back
    assert r2["verdict"]["objective"] < r2["verdict"]["regress_bar"]
    assert ctl.reverts == 1 and ctl.commits == 0
    assert Dashboard.counter_value("TUNE_REVERTS") >= 1
    assert Dashboard.gauge_value("TUNE_APPLY_BATCH_MSGS") == 0.0


def test_stop_aborts_unverified_inflight_step():
    # a step the controller never judged must not outlive it as silent
    # live state — stop() rolls it back and flight-records the abort
    ctl = _controller([_pressure(100.0)])
    ctl.tick_now(now=1.0)
    assert config.get_flag("apply_batch_msgs") == 8      # step live
    ctl.stop()
    assert config.get_flag("apply_batch_msgs") == 0      # rolled back
    assert ctl.reverts == 1 and ctl._inflight is None
    assert ctl.abort_inflight() is False                 # idempotent


def test_controller_tolerates_regression_within_bar():
    # a dip smaller than autotune_regress_pct is noise, not a verdict
    ctl = _controller([_pressure(100.0), _pressure(97.0)])
    ctl.tick_now(now=1.0)
    assert ctl.tick_now(now=2.0)["action"] == "commit"


def test_controller_hysteresis_requires_a_streak():
    ctl = _controller([_pressure(100.0), _pressure(100.0)], hysteresis=2)
    r1 = ctl.tick_now(now=1.0)
    assert r1["action"] == "none"           # 1/2: matched but barred
    assert any("hysteresis" in rej["reason"] for rej in r1["rejected"])
    assert ctl.tick_now(now=2.0)["action"] == "step"


def test_controller_pauses_while_autopilot_is_busy():
    ctl = _controller([_pressure(100.0), _pressure(100.0)])
    for gauge in ("AUTOPILOT_FROZEN", "AUTOPILOT_ACTION_INFLIGHT"):
        gauge_set(gauge, 1)
        record = ctl.tick_now(now=1.0)
        assert record["action"] == "paused"
        assert ctl.sensors.reads == 0       # no sense, no knob motion
        gauge_set(gauge, 0)
    assert Dashboard.counter_value("TUNE_PAUSED_TICKS") == 2
    # a pause mid-verify freezes the verify window instead of judging a
    # window that spans another controller's action
    ctl.tick_now(now=2.0)                   # step goes in flight
    gauge_set("AUTOPILOT_FROZEN", 1)
    ctl.tick_now(now=3.0)
    assert ctl._inflight is not None
    assert ctl._inflight.ticks_waited == 0
    gauge_set("AUTOPILOT_FROZEN", 0)
    assert ctl.tick_now(now=4.0)["action"] == "commit"


def test_flight_recorder_reconstructs_every_adjustment(tmp_path):
    path = tmp_path / "flight.jsonl"
    mvt.set_flag("flight_recorder_path", str(path))
    mvt.set_flag("apply_batch_msgs", 0)
    senses = [_pressure(100.0), _pressure(10.0),    # step -> revert
              _pressure(100.0), _pressure(100.0)]   # step -> commit
    ctl = KnobController(sensors=_ScriptedSensors(senses), rules=[_rule()],
                         interval=0, hysteresis=1, verify_ticks=1,
                         cooldown=0.0, regress_pct=5.0)
    for t in (1.0, 2.0, 3.0, 4.0):
        ctl.tick_now(now=t)
    events = [json.loads(line) for line in path.read_text().splitlines()
              if '"kind": "event"' in line]
    tune = [e for e in events if e["reason"].startswith("tune_")]
    assert [e["reason"] for e in tune] == [
        "tune_step", "tune_revert", "tune_step", "tune_commit"]
    # replaying the trail reproduces the live flag value exactly
    value = 0
    for event in tune:
        value = event["old"] if event["reason"] == "tune_revert" \
            else event["new"]
    assert value == config.get_flag("apply_batch_msgs") == 8
    for event in tune:                       # every record self-describes
        assert event["flag"] == "apply_batch_msgs"
        assert "baseline" in event or "regress_bar" in event


# -- bit-identity with autotune off -------------------------------------------

def _apply_workload():
    mvt.init(heartbeat_seconds=0, device="cpu")
    table = mvt.create_table("matrix", num_row=128, num_col=16)
    rng = np.random.default_rng(7)
    for _ in range(20):
        ids = np.sort(rng.choice(128, 32, replace=False)).astype(np.int32)
        table.add(rng.standard_normal((32, 16)).astype(np.float32) * 0.01,
                  row_ids=ids)
    out = np.asarray(table.get(), np.float32).tobytes()
    mvt.shutdown()
    FLAGS.reset()
    return out


def test_autotune_off_is_bit_identical_and_silent():
    assert bool(config.get_flag("autotune")) is False    # default OFF
    Dashboard.reset()                        # TUNE_* registered by other
    first = _apply_workload()                # tests must read back as 0
    second = _apply_workload()
    assert first == second                   # byte-identical state
    assert mvt.autotune() is None            # nothing was built
    emitted = {n: Dashboard.counter_value(n) for n in Dashboard._counters
               if n.startswith("TUNE_")}
    emitted.update({n: Dashboard.gauge_value(n) for n in Dashboard._gauges
                    if n.startswith("TUNE_")})
    assert all(v == 0 for v in emitted.values()), emitted


def test_init_flag_builds_and_shutdown_tears_down():
    # interval 0: the controller is built but not threaded — drills and
    # tests own the cadence through tick_now()
    mvt.init(autotune=True, autotune_interval_seconds=0,
             heartbeat_seconds=0)
    ctl = mvt.autotune()
    assert ctl is not None and not ctl.status()["running"]
    record = ctl.tick_now(now=1.0)
    assert record["tick"] == 1
    assert Dashboard.counter_value("TUNE_TICKS") >= 1
    mvt.shutdown()
    assert mvt.autotune() is None


def test_init_flag_with_an_interval_runs_the_thread_until_shutdown():
    mvt.init(autotune=True, autotune_interval_seconds=0.05,
             heartbeat_seconds=0)
    ctl = mvt.autotune()
    assert ctl.status()["running"]
    deadline = time.monotonic() + 10
    while ctl.ticks < 2:
        assert time.monotonic() < deadline, "the tuner thread never ticked"
        time.sleep(0.02)
    mvt.shutdown()
    assert not ctl.status()["running"] and mvt.autotune() is None


# -- parity with the JAX package ----------------------------------------------

#: every knob the default rules step, at one starting posture in both
#: registries (the tuner reads the live value as the step's ``old``)
_KNOBS = {"apply_batch_msgs": 0, "wire_shm_spin": 20,
          "wire_coalesce_frames": 0, "wire_coalesce_bytes": 0,
          "wire_quant_bits": 0, "tier_admit_touches": 4,
          "read_hedge_ms": 0.0, "client_cache_bytes": 0}

_SITES = ACTIONABLE_SITES + ("dispatcher_drain", "lock_acquire")


def _synthetic_ticks(seed, ticks):
    """One seeded sequence of what a process's profiler and recorder
    hold at each tick: cumulative wait seconds per site (one pressured
    site per stretch of ticks, so streaks build and break), read-tier
    rates, the hedge delay gauge, and the latency histogram's count and
    p99 (so objectives rise and fall across verify windows)."""
    rng = np.random.default_rng(seed)
    cumulative = {s: 0.0 for s in _SITES}
    out = []
    hot = None
    for i in range(ticks):
        if hot is None or rng.random() < 0.25:
            hot = _SITES[int(rng.integers(0, len(_SITES)))]
        for s in _SITES:
            step = float(rng.random()) * 0.04
            if s == hot:
                step += 0.05 + float(rng.random()) * 2.0
            cumulative[s] += step
        pressure = rng.random() < 0.3
        rates = {"READ_HEDGES": float(rng.integers(0, 20)),
                 "READ_HEDGE_WINS": float(rng.integers(0, 20)),
                 "READ_CACHE_HITS": float(rng.integers(0, 10)),
                 "READ_CACHE_MISSES": float(rng.integers(0, 30))
                 if pressure else 0.0}
        gauges = {"READ_HEDGE_DELAY_SECONDS":
                  float(rng.integers(1, 9)) * 1e-3}
        hist = (int(rng.integers(50, 2000)),
                float(rng.integers(1, 60)) * 1e-3)
        out.append((float(i + 1), dict(cumulative), rates, gauges,
                    None if rng.random() < 0.1 else hist))
    return out


class _SeqProfiler:
    def __init__(self, seq):
        self.seq, self.i = seq, -1

    def wait_seconds(self):
        return dict(self.seq[self.i][1])


class _SeqRecorder:
    def __init__(self, seq, prof):
        self.seq, self.prof = seq, prof

    def rate(self, name, window):
        return self.seq[self.prof.i][2].get(name, 0.0)

    def gauge(self, name):
        return self.seq[self.prof.i][3].get(name, 0.0)

    def window_histogram(self, name, window):
        h = self.seq[self.prof.i][4]
        return None if h is None else _Hist(*h)


class _Stepper:
    """Advances both fakes to the next tick before the sensors read."""

    def __init__(self, sensors, prof):
        self.sensors, self.prof = sensors, prof

    def read(self, now=None):
        self.prof.i += 1
        return self.sensors.read(now=now)


def _drive(pkg, seq, flight, params):
    """Run one package's controller (default rule table, real sensors
    over the fakes) through ``seq``; returns the tick records, the knob
    values after each tick, the counters and the tune_* flight events
    without their timestamps."""
    if pkg == "jax":
        flags, ctl_cls, sensors_cls = JFLAGS, JKnobController, JTuneSensors
    else:
        flags, ctl_cls, sensors_cls = FLAGS, KnobController, TuneSensors
    for name, value in _KNOBS.items():
        flags.set(name, value)
    flags.set("flight_recorder_path", str(flight))
    prof = _SeqProfiler(seq)
    sensors = _Stepper(sensors_cls(recorder=_SeqRecorder(seq, prof),
                                   profiler=prof, window=5.0), prof)
    ctl = ctl_cls(sensors=sensors, interval=0, **params)
    records, knobs = [], []
    for now, *_ in seq:
        records.append(ctl.tick_now(now=now))
        knobs.append({k: flags.get(k) for k in _KNOBS})
    events = []
    for line in flight.read_text().splitlines():
        event = json.loads(line)
        if event.get("kind") == "event" and \
                event["reason"].startswith("tune_"):
            event.pop("t_ns")
            events.append(event)
    return (records, knobs, (ctl.ticks, ctl.steps, ctl.commits,
                             ctl.reverts), events)


@pytest.mark.parametrize("seed,params", [
    (0, dict(hysteresis=1, verify_ticks=1, cooldown=2.0, regress_pct=5.0)),
    (1, dict(hysteresis=2, verify_ticks=2, cooldown=3.0, regress_pct=5.0)),
    (2, dict(hysteresis=2, verify_ticks=3, cooldown=0.0, regress_pct=20.0)),
])
def test_controller_parity_with_jax_on_a_seeded_sequence(tmp_path, seed,
                                                         params):
    seq = _synthetic_ticks(seed, 60)
    want = _drive("jax", seq, tmp_path / "jax.jsonl", params)
    got = _drive("torch", seq, tmp_path / "torch.jsonl", params)
    assert got[0] == want[0]                 # every tick record
    assert got[1] == want[1]                 # knob values after each tick
    assert got[2] == want[2]                 # ticks, steps, commits, reverts
    assert got[3] == want[3]                 # flight records, t_ns aside
    actions = {r["action"] for r in got[0]}
    assert {"step", "commit", "revert"} <= actions, actions
    assert got[2][1] >= 3


def test_sensors_and_rules_parity_with_jax():
    seq = _synthetic_ticks(5, 40)
    fakes = []
    for cls in (JTuneSensors, TuneSensors):
        prof = _SeqProfiler(seq)
        fakes.append((_Stepper(cls(recorder=_SeqRecorder(seq, prof),
                                   profiler=prof, window=5.0), prof)))
    jrule_table, rule_table = jrules.default_rules(), default_rules()
    assert [r.name for r in rule_table] == [r.name for r in jrule_table]
    for now, *_ in seq:
        want = fakes[0].read(now=now)
        got = fakes[1].read(now=now)
        assert got.as_dict() == want.as_dict()
        assert actionable_dominant(got) == jrules.actionable_dominant(want)
        for rule, jrule in zip(rule_table, jrule_table):
            assert rule.predicate(got) == jrule.predicate(want)
            for step, jstep in zip(rule.steps, jrule.steps):
                for current in (0, 1, 4, 8, 64, 1 << 20):
                    assert step.propose(current, got) == \
                        jstep.propose(current, want)
