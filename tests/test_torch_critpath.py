"""Twins of ``tests/test_profiler.py``'s cases that
``tests/test_torch_obs.py`` does not twin yet, on the port: lockcheck's
checked lock parking off-CPU at ``lock_acquire``, the SLO burn dump that
ships a profile, critical-path attribution (``obs/critpath.py``), the
slot-free ``Control_Profile`` RPC and ``mvt.attribution`` under a
ChaosNet delay. The assertions are the reference's; the port's runtime
runs on the CPU.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.fault.lockcheck import _CheckedLock
from multiverso_tpu_torch.obs.collector import StitchedTrace
from multiverso_tpu_torch.obs.critpath import (attribute, dominant,
                                               fleet_attribution, segments)
from multiverso_tpu_torch.obs.profiler import (PROFILER, SamplingProfiler,
                                               current_wait)
from multiverso_tpu_torch.obs.slo import Objective, SLOEngine
from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
from multiverso_tpu_torch.obs.trace import TRACES

SEED = int(os.environ.get("CHAOS_SEED", "7"))


@pytest.fixture(autouse=True)
def port_runtime():
    TORCH_FLAGS.reset()
    Dashboard.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def test_checked_lock_contention_attributes_to_lock_acquire():
    """A thread stuck behind a held ``_CheckedLock`` samples off-CPU at
    ``lock_acquire`` — the lock-hold half of the §13 acceptance bar."""
    prof = SamplingProfiler(hz=100.0, max_frames=24)
    lock = _CheckedLock()
    waiting = threading.Event()
    assert lock.acquire()
    try:
        contender = threading.Thread(
            target=lambda: (waiting.set(), lock.acquire(), lock.release()),
            name="prof-contender", daemon=True)
        contender.start()
        assert waiting.wait(5.0)
        time.sleep(0.02)  # the contender is now inside inner.acquire()
        out = prof.sample_once(weight=0.01)
        assert out["sites"].get("lock_acquire") == 1
        rep = prof.report()
        assert rep["threads"]["prof-contender"]["waits"] == {
            "lock_acquire": pytest.approx(0.01)}
        assert rep["wait_seconds"]["lock_acquire"] == pytest.approx(0.01)
    finally:
        lock.release()
        contender.join(5.0)
    assert current_wait(contender.ident) is None  # tag cleaned up


def test_slo_burn_dump_ships_a_profile(tmp_path):
    path = str(tmp_path / "flight-profile.jsonl")
    mvt.set_flag("flight_recorder_path", path)
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    engine = SLOEngine(recorder=rec, objectives=[
        Objective(name="slow", kind="counter", metric="PROF_SLO_CTR",
                  target=1.0, windows=(20.0, 100.0))])
    rec.sample_now(t=0.0)
    Dashboard.counter("PROF_SLO_CTR").add(10_000)
    rec.sample_now(t=10.0)
    assert engine.evaluate_now()[0].firing
    with open(path, encoding="utf-8") as fh:
        event = next(json.loads(l) for l in fh
                     if json.loads(l)["kind"] == "event")
    assert event["reason"] == "slo_burn"
    profile = event["profile"]          # profile_on_alert defaults true
    assert profile["samples"] > 0 and "threads" in profile


# -- critical-path attribution -------------------------------------------------

def _span(req_id, hops):
    return StitchedTrace(req_id=req_id, hops=hops)


def test_segments_dominant_and_negative_clamp():
    t = _span(7, [("local", "client_send", 1_000_000),
                  ("srv", "server_recv", 3_000_000),
                  ("srv", "apply", 2_000_000),       # residual skew
                  ("srv", "reply_sent", 10_000_000)])
    segs = segments(t)
    assert segs == [("wire:client_send->server_recv", pytest.approx(0.002)),
                    ("server_recv->apply", 0.0),     # clamped, not negative
                    ("apply->reply_sent", pytest.approx(0.008))]
    name, sec, share = dominant(t)
    assert name == "apply->reply_sent"
    assert share == pytest.approx(0.8)
    assert dominant(_span(8, [("local", "only_hop", 0)])) is None


def test_attribute_aggregates_and_quantile_selects_tail():
    fast = [_span(i, [("local", "a", 0), ("local", "b", 1_000_000)])
            for i in range(9)]
    slow = _span(99, [("local", "a", 0), ("remote", "b", 91_000_000)])
    report = attribute(fast + [slow])
    assert report.traces == 10
    assert report.dominant["segment"] == "wire:a->b"
    assert report.dominant["total_ms"] == pytest.approx(91.0)
    assert report.dominant["count"] == 1
    ab = next(r for r in report.rows if r["segment"] == "a->b")
    assert ab["count"] == 9 and ab["mean_ms"] == pytest.approx(1.0)
    assert sum(r["share"] for r in report.rows) == pytest.approx(1.0)
    # p90 cut keeps only the single slowest span
    tail = attribute(fast + [slow], quantile=0.9)
    assert tail.traces == 1
    assert [r["segment"] for r in tail.rows] == ["wire:a->b"]
    assert "p90" in tail.render() and "wire:a->b" in tail.render()
    # profiles annotate the render
    annotated = attribute([slow], profiles={
        "primary@x": {"wait_seconds": {"wal_fsync": 1.25}}})
    assert "wal_fsync=1.250s" in annotated.render()
    assert annotated.to_dict()["profiles"]["primary@x"]
    empty = attribute([])
    assert empty.dominant is None and "no multi-hop" in empty.render()


# -- Control_Profile RPC + end-to-end attribution ------------------------------

def test_control_profile_rpc_and_chaos_delay_attribution(tmp_path):
    """ACCEPTANCE: with ChaosNet delaying every Request_Get by 60 ms,
    the fleet attribution table's dominant segment is the Get's wire
    hop — the injected latency lands where the analyzer says it does."""
    from multiverso_tpu_torch.runtime.remote import fetch_profile
    TRACES.reset()
    PROFILER.reset()
    mvt.init(remote_workers=1, device="cpu",
            fault_spec="delay:type=Request_Get,prob=1.0,seconds=0.06",
            fault_seed=SEED)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(8, np.float32))
    for _ in range(5):
        rt.get()                        # each Get eats the 60 ms delay
    # slot-free profile RPC answers while the data plane is under chaos
    payload = fetch_profile(endpoint)
    assert payload["role"] == "primary"
    assert payload["endpoint"] == endpoint
    assert "samples" in payload["profile"]
    report = mvt.attribution([endpoint])
    dom = report.dominant
    assert dom is not None, report.render()
    # the 60 ms injected delay dwarfs every real segment (<~1 ms each):
    # it must surface as THE dominant segment, on a Get wire hop
    assert dom["segment"].startswith("wire:"), report.render()
    assert dom["share"] > 0.5, report.render()
    assert dom["mean_ms"] > 50.0, report.render()
    client.close()
    mvt.shutdown()


def test_fleet_attribution_skips_unreachable_endpoints():
    TRACES.reset()  # drop earlier tests' local spans from the pull
    report = fleet_attribution(["127.0.0.1:1"], timeout=0.3)
    assert report.traces == 0 and report.profiles == {}
