"""The port's telemetry (``obs/metrics.py``, ``obs/trace.py``, the
dashboard registry): the cases of ``tests/test_obs.py`` on
``multiverso_tpu_torch`` — histogram buckets and quantiles, gauges and
monitors under threads, in-place resets, the text and Prometheus
renders, the bounded trace store, the stats RPC over a real socket, the
flight recorder dumped by a chaos-induced eviction, and the sync gate's
wait histogram. The metrics logger (``obs/logger.py``) is not ported
yet."""

import json
import os
import threading
import time

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.dashboard import (Dashboard, count, gauge_add, gauge_set,
                                      monitor, observe)
from multiverso_tpu_torch.obs.metrics import Gauge, Histogram, StatsSnapshot
from multiverso_tpu_torch.obs.trace import TRACES, TraceStore

SEED = int(os.environ.get("CHAOS_SEED", "7"))


# -- the port's runtime (tests/conftest.py resets only the JAX package's) ----

@pytest.fixture(autouse=True)
def port_runtime():
    """The port's default flags with the tables on the CPU, one intra-op
    thread (the dispatcher's torch calls hand off through the CPU build's
    thread pool, which can stall for minutes on a loaded machine), and
    whatever the test started stopped."""
    import torch
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard as TorchDashboard
    from multiverso_tpu_torch.runtime.zoo import Zoo as TorchZoo
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TorchDashboard.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    try:
        if TorchZoo.instance().started:
            mv.shutdown()
    finally:
        TorchZoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _artifact_path(tmp_path, name):
    """CI chaos runs upload flight/metrics files as artifacts; local runs
    keep them in tmp_path."""
    art = os.environ.get("MV_CHAOS_ARTIFACT_DIR")
    if art:
        os.makedirs(art, exist_ok=True)
        return os.path.join(art, name)
    return str(tmp_path / name)


# -- histogram math ----------------------------------------------------------

def test_histogram_bucket_boundaries():
    """Bucket i covers (bounds[i-1], bounds[i]] with bucket 0 starting at
    0; values above the last bound land in the overflow bucket."""
    h = Histogram("t", bounds=[1.0, 2.0, 4.0, 8.0])
    for v in (0.5, 1.0):   # both <= 1.0 -> bucket 0 (edge INCLUDED)
        h.observe(v)
    for v in (1.5, 2.0):   # (1, 2] -> bucket 1
        h.observe(v)
    h.observe(9.0)         # above the last bound -> overflow
    d = h.to_dict()
    assert d["buckets"] == [2, 2, 0, 0]
    assert d["overflow"] == 1
    assert d["count"] == 5
    assert d["max"] == 9.0
    assert d["sum"] == pytest.approx(0.5 + 1.0 + 1.5 + 2.0 + 9.0)
    # negatives/NaN clamp to 0 rather than corrupting the distribution
    h.observe(-1.0)
    assert h.to_dict()["buckets"][0] == 3


def test_histogram_quantile_interpolation_exact():
    """Linear interpolation inside the winning bucket: synthetic samples
    with hand-computed expected quantiles, exact to float rounding."""
    h = Histogram("t", bounds=[1.0, 2.0, 4.0])
    for v in (0.5, 0.9):   # 2 samples in bucket 0: (0, 1]
        h.observe(v)
    for v in (1.5, 1.9):   # 2 samples in bucket 1: (1, 2]
        h.observe(v)
    # rank = q*4; bucket 0 holds ranks (0, 2], bucket 1 ranks (2, 4]
    assert h.quantile(0.25) == pytest.approx(0.5)    # rank 1 -> 0 + 1/2*1
    assert h.p50 == pytest.approx(1.0)               # rank 2 -> top of b0
    assert h.quantile(0.75) == pytest.approx(1.5)    # rank 3 -> 1 + 1/2*1
    assert h.quantile(1.0) == pytest.approx(2.0)     # rank 4 -> top of b1
    # empty histogram reports 0 rather than raising
    assert Histogram("empty").p99 == 0.0


def test_histogram_overflow_quantile_reports_max():
    h = Histogram("t", bounds=[1.0])
    h.observe(0.5)
    for v in (10.0, 20.0, 30.0):
        h.observe(v)
    # p99 rank lands in the overflow bucket, which has no finite edge:
    # the observed max is the honest answer
    assert h.p99 == 30.0


def test_histogram_dict_round_trip_preserves_quantiles():
    rng = np.random.default_rng(SEED)
    h = Histogram("t")
    for v in rng.gamma(2.0, 0.001, size=500):
        h.observe(float(v))
    clone = Histogram.from_dict("t", h.to_dict())
    for q in (0.5, 0.9, 0.95, 0.99):
        assert clone.quantile(q) == h.quantile(q)
    assert clone.count == h.count and clone.sum == h.sum


# -- gauges ------------------------------------------------------------------

def test_gauge_set_add_semantics_under_threads():
    g = Gauge("t")
    g.set(5.0)
    g.add(1.0)
    assert g.value == 6.0
    g.set(0.0)
    threads = [threading.Thread(
        target=lambda: [g.add(1.0) for _ in range(1000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert g.value == 8000.0  # no lost increments
    # registry helpers hit the same object
    gauge_set("TEST_GAUGE", 3)
    gauge_add("TEST_GAUGE", 2)
    assert Dashboard.gauge_value("TEST_GAUGE") == 5.0
    assert Dashboard.gauge("TEST_GAUGE").value == 5.0


# -- Monitor thread-safety (satellite regression) ----------------------------

def test_monitor_overlapping_threads_measure_independently():
    """Two threads timing the same named section concurrently: the
    in-progress start time is thread-local, so the long section's span
    survives the short one's begin/end landing inside it (a single shared
    slot recorded count=1 / elapse~=short here)."""
    mon = Dashboard.get("OVERLAP_SECTION")
    started, release = threading.Event(), threading.Event()

    def long_section():
        mon.begin()
        started.set()
        release.wait(5)
        mon.end()

    t = threading.Thread(target=long_section)
    t.start()
    assert started.wait(5)
    time.sleep(0.12)        # the long span covers at least this
    mon.begin()             # overlapping short section, different thread
    time.sleep(0.01)
    mon.end()
    release.set()
    t.join(5)
    assert mon.count == 2
    assert mon.elapse_ms >= 120, (
        f"overlapping scope corrupted the long span: {mon.elapse_ms}ms")


def test_monitor_context_manager_feeds_histogram():
    with monitor("TIMED_SECTION"):
        time.sleep(0.01)
    hist = Dashboard.histogram("TIMED_SECTION")
    assert hist.count == 1
    assert hist.p50 >= 0.008


# -- reset-in-place (satellite regression) -----------------------------------

def test_reset_zeroes_registry_objects_in_place():
    """A module caching a Counter/Monitor/Histogram/Gauge reference must
    keep feeding the SAME object the registry serves after reset() —
    clearing the dicts instead would orphan the cached reference and its
    updates would vanish."""
    ctr = Dashboard.counter("CACHED_CTR")
    mon = Dashboard.get("CACHED_MON")
    hist = Dashboard.histogram("CACHED_HIST")
    gauge = Dashboard.gauge("CACHED_GAUGE")
    ctr.add(3)
    mon.observe(0.5)
    hist.observe(0.5)
    gauge.set(7)
    Dashboard.reset()
    assert Dashboard.counter_value("CACHED_CTR") == 0
    assert hist.count == 0 and gauge.value == 0 and mon.count == 0
    # the cached reference IS the registry entry, before and after
    ctr.add(2)
    assert Dashboard.counter("CACHED_CTR") is ctr
    assert Dashboard.counter_value("CACHED_CTR") == 2
    hist.observe(0.25)
    assert Dashboard.histogram("CACHED_HIST").count == 1


# -- render formats ----------------------------------------------------------

def test_render_text_and_prom_formats():
    count("RENDER_CTR", 3)
    gauge_set("RENDER_GAUGE", 2.5)
    observe("RENDER_HIST_SECONDS", 0.003)
    with monitor("RENDER_SECTION"):
        pass
    text = Dashboard.render()
    for token in ("RENDER_CTR", "RENDER_GAUGE", "RENDER_HIST_SECONDS",
                  "RENDER_SECTION", "p50_ms"):
        assert token in text, f"{token} missing from text render"
    prom = Dashboard.render(format="prom")
    assert "# TYPE mvtpu_render_ctr counter" in prom
    assert "mvtpu_render_ctr_total 3" in prom
    assert "# TYPE mvtpu_render_gauge gauge" in prom
    assert "mvtpu_render_gauge 2.5" in prom
    assert '# TYPE mvtpu_render_hist_seconds histogram' in prom
    assert 'mvtpu_render_hist_seconds_bucket{le="+Inf"} 1' in prom
    assert "mvtpu_render_hist_seconds_count 1" in prom
    assert "mvtpu_render_section_seconds_count 1" in prom
    with pytest.raises(ValueError):
        Dashboard.render(format="xml")


# -- trace store -------------------------------------------------------------

def test_trace_store_bounded_and_req_id_zero_ignored():
    ts = TraceStore(max_traces=3)
    ts.hop(0, "ignored")          # req_id 0 = untraced in-process traffic
    assert len(ts) == 0
    for rid in (1, 2, 3, 4):
        ts.hop(rid, "a")
        ts.hop(rid, "b")
    assert len(ts) == 3           # oldest evicted
    assert ts.get(1) == []
    assert [s for s, _ in ts.get(4)] == ["a", "b"]
    t_ns = ts.get(4)[0][1]
    assert isinstance(t_ns, int) and t_ns > 0
    recent = ts.recent(2)
    assert [rid for rid, _ in recent] == [3, 4]


# -- live stats RPC over a real socket ---------------------------------------

def test_stats_rpc_round_trip_with_known_distribution():
    """mv.stats(endpoint) over a real TCP socket: the remote-reconstructed
    request-latency histogram is non-empty, and a synthetic known
    distribution comes back with exact p50/p95/p99 (100 samples of 1.5e-6
    land in the (1e-6, 2e-6] bucket; quantile q interpolates to
    1e-6 + q*1e-6)."""
    mv.init(remote_workers=1)
    table = mv.create_table("array", 16, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    for _ in range(10):
        rt.add(np.ones(16, np.float32))
        rt.get()
    for _ in range(100):
        observe("SYNTH_KNOWN_SECONDS", 1.5e-6)
    snap = mv.stats(endpoint)
    assert isinstance(snap, StatsSnapshot)
    known = snap.histogram("SYNTH_KNOWN_SECONDS")
    assert known.count == 100
    assert known.p50 == pytest.approx(1.5e-6, abs=1e-15)
    assert known.p95 == pytest.approx(1.95e-6, abs=1e-15)
    assert known.p99 == pytest.approx(1.99e-6, abs=1e-15)
    # ...and they equal the server-side object's quantiles exactly
    local = Dashboard.histogram("SYNTH_KNOWN_SECONDS")
    assert (known.p50, known.p95, known.p99) == (
        local.p50, local.p95, local.p99)
    # the instrumented seams reported real traffic
    req = snap.histogram("CLIENT_REQUEST_SECONDS")
    assert req is not None and req.count >= 20 and req.p50 > 0
    assert snap.histogram("SERVER_PROCESS_ADD_MSG").count >= 10
    assert snap.histogram("FRAME_ENCODE_SECONDS").count > 0
    assert snap.histogram("FRAME_DECODE_SECONDS").count > 0
    assert "SERVER_QUEUE_DEPTH" in snap.gauges
    assert snap.gauge("SERVER_DEDUP_OCCUPANCY") > 0
    # a second probe works (the RPC takes no slot and leaves no state)
    assert mv.stats(endpoint).histogram("SYNTH_KNOWN_SECONDS").count == 100
    client.close()
    mv.shutdown()


def test_stats_rpc_timeout_on_dead_endpoint():
    mv.init(remote_workers=1)
    endpoint = mv.serve("127.0.0.1:0")
    mv.stop_serving()
    with pytest.raises((TimeoutError, ConnectionError, OSError)):
        mv.stats(endpoint, timeout=1.0)
    mv.shutdown()


# -- flight recorder: ChaosNet-induced eviction ------------------------------

def test_flight_recorder_dump_on_chaos_eviction(tmp_path):
    """A ChaosNet schedule silences worker 0 (heartbeats and Get
    retransmits dropped after the first round), its lease expires, the
    sync watchdog evicts it — and the flight recorder dumps an event
    line, a dashboard snapshot, and end-to-end per-hop traces for the
    evicted worker's deferred request."""
    path = _artifact_path(tmp_path, f"flight-evict-seed{SEED}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    TRACES.reset()
    mv.init(sync=True, ps_role="server", remote_workers=2,
            sync_stall_seconds=0.1, lease_seconds=0.6,
            heartbeat_seconds=0.1, request_retry_seconds=0.25,
            flight_recorder_path=path,
            fault_spec=("drop:type=Control_Heartbeat,after=2;"
                        "drop:type=Request_Get,after=1"),
            fault_seed=SEED)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    wid = client.worker_id
    rt = client.table(table.table_id)
    errors = []

    def blocked_round():
        try:
            rt.add(np.ones(4, np.float32))
            rt.get()  # defers: the second remote slot never registers
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    t = threading.Thread(target=blocked_round)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "chaos eviction never released the worker"
    assert errors and "evicted" in repr(errors[0])
    assert Dashboard.counter_value("WORKER_EVICTIONS") >= 1

    # the dump lands on the dispatcher thread moments after the client
    # sees the eviction error — poll briefly for it
    deadline = time.monotonic() + 10.0
    while (Dashboard.counter_value("FLIGHT_DUMPS") == 0
           and time.monotonic() < deadline):
        time.sleep(0.05)
    lines = [json.loads(line) for line in
             open(path, encoding="utf-8") if line.strip()]
    events = [l for l in lines if l["kind"] == "event"]
    assert any(e["reason"] == "worker_evicted" and e["worker"] == wid
               for e in events), events
    snapshots = [l for l in lines if l["kind"] == "snapshot"]
    assert snapshots and snapshots[0]["counters"]["WORKER_EVICTIONS"] >= 1
    traces = [l for l in lines if l["kind"] == "trace"]
    assert traces, "no traces in the dump"
    # the evicted worker's Get: end-to-end hops from the client's send
    # through the server's gate to the eviction failure
    stages_by_req = {tr["req_id"]: [s for s, _ in tr["hops"]]
                     for tr in traces}
    evicted = [st for st in stages_by_req.values()
               if "gate_failed_eviction" in st]
    assert evicted, f"no evicted-request trace in {stages_by_req}"
    for stage in ("client_send", "server_recv", "gate_deferred",
                  "gate_failed_eviction"):
        assert stage in evicted[0], (stage, evicted[0])
    client.close()
    mv.shutdown()


# -- metrics logger ----------------------------------------------------------


def test_sync_gate_wait_histogram_records_deferral():
    """A BSP-deferred request's queue time lands in SYNC_GATE_WAIT_SECONDS
    — wired through the in-process path too (req_id 0: no trace, but the
    histogram still observes)."""
    mv.init(sync=True)
    table = mv.create_table("array", 4, np.float32)
    # worker 0 adds+gets in one thread while the other local worker is
    # idle — with one local worker there is no deferral, so drive the
    # histogram directly through the server's gate helpers instead
    from multiverso_tpu_torch.runtime.message import Message, MsgType
    from multiverso_tpu_torch.runtime.server import SyncServer
    msg = Message(src=0, dst=-1, type=MsgType.Request_Get,
                  table_id=table.table_id, req_id=123)
    SyncServer._gate_defer(msg)
    time.sleep(0.02)
    SyncServer._gate_release(msg)
    hist = Dashboard.histogram("SYNC_GATE_WAIT_SECONDS")
    assert hist.count >= 1 and hist.p50 >= 0.01
    assert [s for s, _ in TRACES.get(123)] == ["gate_deferred",
                                               "gate_released"]
    mv.shutdown()
