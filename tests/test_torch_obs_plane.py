"""Twins of ``tests/test_obs_plane.py`` on the port: the fleet-wide
observability plane (cross-process trace stitching, time-series metrics,
the SLO burn-rate engine, the operator fleet view).

Every case of the reference file but its two ``bench --compare`` cases
(they test ``bench.py``, not the package) runs here against the port's
modules, with the port's runtime on the CPU and the shard groups'
children on the CPU. The assertions are the reference's.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.dashboard import (Dashboard, count, gauge_set, monitor,
                                      observe)
from multiverso_tpu_torch.obs.collector import (StitchedTrace, TraceCollector,
                                          estimate_offset)
from multiverso_tpu_torch.obs.slo import Objective, SLOEngine, parse_slo_spec
from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
from multiverso_tpu_torch.obs.trace import FlightRecorder, TRACES, TraceStore
from multiverso_tpu_torch.runtime.message import Message, MsgType

SEED = int(os.environ.get("CHAOS_SEED", "7"))


@pytest.fixture(autouse=True)
def port_runtime():
    """Fresh port flags and dashboard per case; the runtime stopped after
    it (``tests/conftest.py`` resets only the JAX package's)."""
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
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


def _artifact_path(tmp_path, name):
    """CI chaos runs upload flight/metrics files as artifacts; local runs
    keep them in tmp_path."""
    art = os.environ.get("MV_CHAOS_ARTIFACT_DIR")
    if art:
        os.makedirs(art, exist_ok=True)
        return os.path.join(art, name)
    return str(tmp_path / name)


# -- the trace flag on the wire ------------------------------------------------

def test_trace_flag_wire_roundtrip():
    """The v4 header carries the trace flag in the channel byte's high
    bit: set and cleared round-trip bit-exactly, and the decoded channel
    comes back unpolluted (raw-queue routing keys off channel == 1)."""
    from multiverso_tpu_torch.runtime.net import TcpNet
    net = TcpNet()
    for trace in (False, True):
        msg = Message(src=3, dst=0, type=MsgType.Request_Get, table_id=2,
                      msg_id=11, req_id=5, trace=trace,
                      data=[np.arange(4, dtype=np.float32)])
        frame = net._frame(msg, 0)
        view = memoryview(frame)
        pos = [0]

        def read(n):
            out = view[pos[0]:pos[0] + n]
            pos[0] += n
            return bytes(out)

        decoded = net._read_frame(read, set())
        assert decoded.trace is trace
        assert decoded.req_id == 5 and decoded.msg_id == 11
        np.testing.assert_array_equal(decoded.data[0],
                                      np.arange(4, dtype=np.float32))


# -- trace-store loss accounting ----------------------------------------------

def test_trace_store_loss_counters():
    """Eviction at the trace bound and hop-drop at the per-trace bound
    both COUNT — a collector reading a partial store can tell."""
    from multiverso_tpu_torch.obs.trace import MAX_HOPS_PER_TRACE
    base_evicted = Dashboard.counter_value("TRACE_EVICTED")
    base_dropped = Dashboard.counter_value("TRACE_DROPPED_HOPS")
    ts = TraceStore(max_traces=2)
    for rid in (1, 2, 3, 4):          # 2 evictions past the bound
        ts.hop(rid, "a")
    assert len(ts) == 2
    assert Dashboard.counter_value("TRACE_EVICTED") == base_evicted + 2
    for i in range(MAX_HOPS_PER_TRACE + 5):   # 5 dropped hops
        ts.hop(5, f"hop{i}")
    assert len(ts.get(5)) == MAX_HOPS_PER_TRACE
    assert (Dashboard.counter_value("TRACE_DROPPED_HOPS")
            == base_dropped + 5)


# -- clock-offset estimation + stitching on synthetic stores -------------------

def test_estimate_offset_recovers_synthetic_skew():
    """A remote store whose clock runs 1 ms ahead: the NTP-style
    request/reply pair estimate recovers the skew exactly when the two
    transit legs are symmetric."""
    skew = 1_000_000  # ns
    local = {7: [("client_send", 1_000), ("client_reply", 9_000)]}
    remote = {7: [("server_recv", 3_000 + skew),
                  ("server_reply", 7_000 + skew)]}
    assert estimate_offset(local, remote) == skew
    # no shared req_id -> no estimate
    assert estimate_offset(local, {8: [("x", 1)]}) is None


def test_stitch_orders_corrected_hops_across_processes():
    skew = 5_000_000
    collector = TraceCollector([], include_local=False)
    collector.stores = {
        "local": {7: [("client_send", 1_000), ("client_reply", 9_000)]},
        "primary@h:1": {7: [("server_recv", 3_000 + skew),
                            ("server_reply", 7_000 + skew)]},
    }
    collector.roles = {"local": "client", "primary@h:1": "primary"}
    collector._estimate_offsets()
    assert collector.offsets["primary@h:1"] == skew
    spans = collector.stitch()
    assert len(spans) == 1
    span = spans[0]
    assert isinstance(span, StitchedTrace) and span.req_id == 7
    assert span.stages() == ["client_send", "server_recv",
                             "server_reply", "client_reply"]
    assert span.processes == ["local", "primary@h:1"]
    assert span.monotonic() and span.duration_ns == 8_000
    assert "client_send" in span.render()


def test_collector_unreachable_endpoint_degrades():
    """A dead endpoint lands in ``unreachable``; collect() never raises
    and the local store still stitches."""
    TRACES.reset()
    TRACES.hop(42, "client_send")
    collector = TraceCollector(["127.0.0.1:1"], timeout=0.5)
    collector.collect()
    assert collector.unreachable == ["127.0.0.1:1"]
    spans = collector.stitch(42)
    assert len(spans) == 1 and spans[0].stages() == ["client_send"]


# -- Control_Traces RPC over a real socket ------------------------------------

def test_control_traces_rpc_round_trip():
    """``fetch_traces`` pulls a served process's store slot-free; the
    collector stitches it with the local half (one process here, so the
    stores mirror each other and the offset is ~0)."""
    from multiverso_tpu_torch.runtime.remote import fetch_traces
    TRACES.reset()
    mvt.init(remote_workers=1, device="cpu")
    table = mvt.create_table("array", 16, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(16, np.float32))
    rt.get()
    payload = fetch_traces(endpoint, timeout=5.0)
    assert payload["role"] == "primary"
    assert int(payload["t_reply_ns"]) > 0
    traced = payload["traces"]
    assert traced, "served process exported no traces"
    stages = {s for hops in traced.values() for s, _ in hops}
    assert "client_send" in stages and "server_recv" in stages
    spans = mvt.traces([endpoint])
    assert spans and all(s.monotonic() for s in spans)
    # the operator view renders for the same endpoint, text and html
    top = mvt.top([endpoint])
    assert endpoint in top and "role" in top
    html = mvt.top([endpoint], format="html")
    assert "<html>" in html and endpoint in html
    client.close()
    mvt.shutdown()


# -- time-series recorder ------------------------------------------------------

def test_timeseries_rate_delta_and_gauge():
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    count("TSP_CTR", 10)
    gauge_set("TSP_GAUGE", 3.5)
    rec.sample_now(t=100.0)
    count("TSP_CTR", 20)
    gauge_set("TSP_GAUGE", 7.5)
    rec.sample_now(t=110.0)
    assert rec.delta("TSP_CTR", 60.0) == 20
    assert rec.rate("TSP_CTR", 60.0) == pytest.approx(2.0)
    assert rec.gauge("TSP_GAUGE") == 7.5
    assert rec.span_seconds() == pytest.approx(10.0)
    # a window too short to span two samples answers conservatively:
    # rate 0, delta falls back to the cumulative value
    assert rec.rate("TSP_CTR", 1.0) == 0.0
    assert rec.delta("TSP_CTR", 1.0) == 30
    assert rec.series("counter", "TSP_CTR") == [(100.0, 10.0),
                                                (110.0, 30.0)]
    with pytest.raises(ValueError):
        rec.series("histogram", "TSP_CTR")


def test_timeseries_windowed_quantile_differences_history_out():
    """Windowed p50 reflects only the window's own observations — the
    cumulative histogram would be dominated by the 1000 fast samples."""
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    for _ in range(1000):
        observe("TSP_HIST_SECONDS", 0.001)
    rec.sample_now(t=100.0)
    for _ in range(100):
        observe("TSP_HIST_SECONDS", 0.5)
    rec.sample_now(t=110.0)
    window = rec.window_histogram("TSP_HIST_SECONDS", 60.0)
    assert window.count == 100
    assert rec.quantile("TSP_HIST_SECONDS", 0.5, 60.0) > 0.1
    cumulative = Dashboard.histogram("TSP_HIST_SECONDS")
    assert cumulative.p50 < 0.01  # history dominates the cumulative view
    # unknown histogram answers 0, not a crash
    assert rec.quantile("TSP_NO_SUCH", 0.99, 60.0) == 0.0


def test_timeseries_rate_delta_clamp_across_dashboard_reset():
    """``Dashboard.reset()`` mid-window drops cumulative counters below
    older ring samples; windowed rate/delta must clamp at zero — a
    registry reset is not a negative event rate."""
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    count("TSP_RESET_CTR", 100)
    rec.sample_now(t=100.0)
    count("TSP_RESET_CTR", 50)
    rec.sample_now(t=110.0)
    assert rec.delta("TSP_RESET_CTR", 60.0) == 50
    Dashboard.reset()                       # counter 150 -> 0 in place
    count("TSP_RESET_CTR", 5)
    rec.sample_now(t=120.0)
    # window spans the reset: 5 < 100, clamp — never negative
    assert rec.delta("TSP_RESET_CTR", 60.0) == 0
    assert rec.rate("TSP_RESET_CTR", 60.0) == 0.0
    # gauge view answers the post-reset truth, series stays monotonic in t
    assert rec.series("counter", "TSP_RESET_CTR") == [
        (100.0, 100.0), (110.0, 150.0), (120.0, 5.0)]
    # once the window no longer straddles the reset, rates recover
    count("TSP_RESET_CTR", 15)
    rec.sample_now(t=130.0)
    assert rec.delta("TSP_RESET_CTR", 15.0) == 15
    assert rec.rate("TSP_RESET_CTR", 15.0) == pytest.approx(1.5)


# -- slo_spec parsing ----------------------------------------------------------

def test_parse_slo_spec_clauses_and_errors():
    objectives = parse_slo_spec(
        "get_p99:histogram=CLIENT_REQUEST_SECONDS,p=0.99,target=0.05,"
        "windows=30/120,burn=2;"
        "retries:counter=CLIENT_RETRIES,target=1.5;"
        "lag:gauge=REPLICA_LAG_RECORDS,target=500,windows=10")
    assert [o.name for o in objectives] == ["get_p99", "retries", "lag"]
    get_p99 = objectives[0]
    assert get_p99.kind == "histogram"
    assert get_p99.metric == "CLIENT_REQUEST_SECONDS"
    assert get_p99.windows == (30.0, 120.0)
    assert get_p99.burn_threshold == 2.0
    assert objectives[1].windows == (60.0, 300.0)     # defaults
    assert objectives[2].windows == (10.0, 50.0)      # long = 5x short
    for bad in ("no-colon-clause",
                "x:histogram=H",                       # no target
                "x:histogram=H,target=1,bogus=2",      # unknown key
                "x:sparkline=H,target=1",              # unknown kind
                "x:histogram=H,target=-1"):            # target <= 0
        with pytest.raises(ValueError):
            parse_slo_spec(bad)


# -- SLO engine: edge-triggered burn alert + tagged dump -----------------------

def test_slo_burn_alert_fires_once_and_dumps(tmp_path):
    path = _artifact_path(tmp_path, f"flight-slo-seed{SEED}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    mvt.set_flag("flight_recorder_path", path)
    rec = TimeSeriesRecorder(interval=100.0, samples=32)
    engine = SLOEngine(recorder=rec, objectives=[
        Objective(name="get_p99", kind="histogram",
                  metric="SLO_TEST_SECONDS", quantile=0.99,
                  target=0.010, windows=(20.0, 100.0))])
    for _ in range(50):
        observe("SLO_TEST_SECONDS", 0.001)  # healthy
    rec.sample_now(t=0.0)
    rec.sample_now(t=5.0)
    assert not engine.evaluate_now()[0].firing
    for _ in range(50):
        observe("SLO_TEST_SECONDS", 0.2)    # 20x over budget
    rec.sample_now(t=10.0)
    ev = engine.evaluate_now()[0]
    assert ev.firing and ev.burn_short > 10.0
    assert engine.firing() == ["get_p99"]
    assert Dashboard.counter_value("SLO_BURN_ALERTS") == 1
    # edge-triggered: still burning does not re-alert or re-dump
    engine.evaluate_now()
    assert Dashboard.counter_value("SLO_BURN_ALERTS") == 1
    with open(path, encoding="utf-8") as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    events = [l for l in lines if l["kind"] == "event"]
    assert len(events) == 1
    assert events[0]["reason"] == "slo_burn"
    assert events[0]["slo"] == "get_p99"
    assert events[0]["metric"] == "SLO_TEST_SECONDS"
    assert events[0]["burn_short"] > 10.0
    assert any(l["kind"] == "snapshot" for l in lines)
    # recovery: two quiet samples empty the windows; logged, no new dump
    rec.sample_now(t=115.0)
    rec.sample_now(t=120.0)
    assert not engine.evaluate_now()[0].firing
    assert engine.firing() == []
    assert Dashboard.counter_value("SLO_BURN_ALERTS") == 1
    assert "get_p99" in engine.render()


# -- labeled Prometheus exposition --------------------------------------------

def test_prom_labels_and_escaping():
    from multiverso_tpu_torch.dashboard import _prom_escape
    assert _prom_escape('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    count("PLANE_CTR", 3)
    observe("PLANE_HIST_SECONDS", 0.001)
    prom = Dashboard.render(format="prom")
    assert "mvtpu_plane_ctr_total 3" in prom  # no identity -> unlabeled
    Dashboard.set_identity(shard=2, role="replica")
    assert Dashboard.identity() == {"shard": "2", "role": "replica"}
    prom = Dashboard.render(format="prom")
    assert 'mvtpu_plane_ctr_total{role="replica",shard="2"} 3' in prom
    assert ('mvtpu_plane_hist_seconds_bucket{role="replica",shard="2",'
            'le="+Inf"} 1' in prom)
    assert 'mvtpu_plane_hist_seconds_count{role="replica",shard="2"}' \
        in prom


# -- flight recorder: size cap + per-reason rate limit -------------------------

def test_flight_recorder_per_reason_rate_limit(tmp_path):
    path = str(tmp_path / "flight-rate.jsonl")
    mvt.set_flag("flight_recorder_path", path)
    mvt.set_flag("flight_recorder_min_interval_seconds", 3600.0)
    rec = FlightRecorder(store=TraceStore())
    before = Dashboard.counter_value("FLIGHT_DUMPS_SUPPRESSED")
    assert rec.dump("eviction", worker=1) == path
    # same reason inside the interval: suppressed + counted, file untouched
    size = os.path.getsize(path)
    assert rec.dump("eviction", worker=2) is None
    assert os.path.getsize(path) == size
    assert Dashboard.counter_value("FLIGHT_DUMPS_SUPPRESSED") == before + 1
    # a DIFFERENT reason is not rate-limited by the first one
    assert rec.dump("failover") == path
    with open(path, encoding="utf-8") as fh:
        events = [json.loads(l) for l in fh if l.strip()
                  and json.loads(l)["kind"] == "event"]
    assert [e["reason"] for e in events] == ["eviction", "failover"]
    mvt.set_flag("flight_recorder_min_interval_seconds", 0.0)
    # interval 0 (the default) disables the rate limit entirely
    assert rec.dump("eviction") == path


def test_flight_recorder_size_cap_suppresses(tmp_path):
    path = str(tmp_path / "flight-cap.jsonl")
    mvt.set_flag("flight_recorder_path", path)
    rec = FlightRecorder(store=TraceStore())
    assert rec.dump("crc_reject") == path          # first dump writes
    mvt.set_flag("flight_recorder_max_bytes", 64)   # file already bigger
    before = Dashboard.counter_value("FLIGHT_DUMPS_SUPPRESSED")
    size = os.path.getsize(path)
    assert rec.dump("crc_reject") is None
    assert rec.dump("some_other_reason") is None   # cap gates every reason
    assert os.path.getsize(path) == size
    assert Dashboard.counter_value("FLIGHT_DUMPS_SUPPRESSED") == before + 2
    mvt.set_flag("flight_recorder_max_bytes", 64 << 20)
    assert rec.dump("crc_reject") == path          # headroom back -> writes


# -- fleet acceptance: stitched trace + partial stats --------------------------

def _wait_replicas_caught_up(group, deadline_s=60):
    deadline = time.monotonic() + deadline_s
    for fleet in group.replica_endpoints:
        while time.monotonic() < deadline:
            probe = mvt.watermark(fleet[0])
            if probe["watermark"] >= 1 and probe["lag"] == 0:
                break
            time.sleep(0.1)


def test_stitched_trace_across_fleet_and_partial_stats(tmp_path):
    """ACCEPTANCE: a replica-preferring Get through a 2-shard x 1-replica
    group stitches into one span of >= 6 hops across >= 3 processes —
    the client, the router-chosen replica, and the primary's watermark
    path — with monotonic corrected timestamps. Then a SIGKILLed replica
    degrades ``mvt.stats_all`` to a partial merge with the dead endpoint
    in ``unreachable`` instead of failing."""
    rows, cols = 32, 4
    group = mvt.serve_sharded(
        [{"kind": "matrix", "num_row": rows, "num_col": cols,
          "dtype": "<f4"}],
        shards=2, replicas=1, base_dir=str(tmp_path), device="cpu",
        flags={"remote_workers": 4, "heartbeat_seconds": 0.2})
    try:
        mvt.set_flag("read_staleness_records", 1 << 30)
        mvt.set_flag("read_timeout_seconds", 1.0)
        client = group.connect(read_preference="replica")
        table = client.table(0)
        values = np.arange(rows * cols, dtype=np.float32).reshape(
            rows, cols)
        table.add(values, row_ids=np.arange(rows, dtype=np.int32))
        _wait_replicas_caught_up(group)

        TRACES.reset()  # isolate: the stitched span is THIS Get's
        ids = np.arange(rows, dtype=np.int32)
        np.testing.assert_array_equal(table.get(row_ids=ids), values)
        time.sleep(0.5)  # the fire-and-forget watermark confirm lands

        spans = mvt.traces(group)
        assert spans, "fleet exported no stitched traces"
        read_spans = [s for s in spans
                      if "client_read_submit" in s.stages()
                      and any(st.startswith("replica_serve_read")
                              for st in s.stages())]
        assert read_spans, (
            f"no replica-served read span in "
            f"{[(s.req_id, s.stages()) for s in spans]}")
        span = max(read_spans, key=lambda s: len(s.processes))
        assert len(span.hops) >= 6, span.render()
        assert len(span.processes) >= 3, span.render()
        roles = {p.split("@")[0] for p in span.processes}
        assert "local" in roles and "replica" in roles, span.render()
        assert "primary" in roles, (
            f"watermark-confirm leg missing: {span.render()}")
        assert span.monotonic(), span.render()

        # the operator fleet view covers every process, dead or alive
        top = mvt.top(group)
        assert top.count("replica") >= 2 and "primary" in top

        # -- satellite: stats_all partials with a killed replica
        merged_before = mvt.stats_all(group)
        assert merged_before.unreachable == []
        group.kill_replica(0, 0)
        time.sleep(0.3)
        merged = mvt.stats_all(group, timeout=2.0)
        dead = group.replica_endpoints[0][0]
        assert dead in merged.unreachable
        assert merged.counter("READS_SERVED_REPLICA") >= 1
        assert set(merged.replicas) == {group.replica_endpoints[1][0]}
        client.close()
    finally:
        group.stop()


def test_chaos_traces_stay_monotonic_under_drop_and_reorder(tmp_path):
    """A seeded ChaosNet schedule dropping replica reads and reordering
    primary Gets client-side: reads still surface zero errors (the
    fallback contract) and every stitched span stays causally ordered —
    chaos corrupts wires, never the trace plane."""
    rows, cols = 16, 4
    group = mvt.serve_sharded(
        [{"kind": "matrix", "num_row": rows, "num_col": cols,
          "dtype": "<f4"}],
        shards=2, replicas=1, base_dir=str(tmp_path), device="cpu",
        flags={"remote_workers": 4, "heartbeat_seconds": 0.2})
    try:
        mvt.set_flag("read_staleness_records", 1 << 30)
        mvt.set_flag("read_timeout_seconds", 0.5)
        mvt.set_flag("fault_spec", ("drop:type=Request_Read,every=3;"
                                   "reorder:type=Request_Get,every=4"))
        mvt.set_flag("fault_seed", SEED)
        client = group.connect(read_preference="replica")
        table = client.table(0)
        values = np.arange(rows * cols, dtype=np.float32).reshape(
            rows, cols)
        table.add(values, row_ids=np.arange(rows, dtype=np.int32))
        _wait_replicas_caught_up(group)
        TRACES.reset()
        ids = np.arange(rows, dtype=np.int32)
        for _ in range(12):
            np.testing.assert_array_equal(table.get(row_ids=ids), values)
        time.sleep(0.5)
        spans = mvt.traces(group)
        assert spans, "chaos fleet exported no stitched traces"
        assert all(s.monotonic() for s in spans), "\n".join(
            s.render() for s in spans if not s.monotonic())
        assert any(len(s.processes) >= 2 for s in spans)
        # dropped replica attempts left fallback break markers, traced
        stages = {st for s in spans for st in s.stages()}
        assert "client_read_submit" in stages
        client.close()
    finally:
        group.stop()


# -- chaos: SLO burn under injected latency ------------------------------------

def test_slo_burn_fires_under_chaos_injected_delay(tmp_path):
    """ACCEPTANCE: an SLO on Get p99 fires a burn-rate alert when
    ChaosNet delays every Get by 60 ms (seeded, deterministic: the delay
    rule fires at prob=1), and the alert's flight-recorder dump lands
    tagged ``slo_burn`` with the request traces beside it."""
    path = _artifact_path(tmp_path, f"flight-slo-chaos-seed{SEED}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    TRACES.reset()
    mvt.init(remote_workers=1, device="cpu", timeseries_interval_seconds=0,
            flight_recorder_path=path,
            fault_spec="delay:type=Request_Get,prob=1.0,seconds=0.06",
            fault_seed=SEED)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rec = TimeSeriesRecorder(interval=100.0, samples=64)
    engine = SLOEngine(recorder=rec, objectives=[
        Objective(name="get_p99", kind="histogram",
                  metric="CLIENT_REQUEST_SECONDS", quantile=0.99,
                  target=0.010, windows=(60.0, 300.0))])
    rec.sample_now()
    rt.add(np.ones(8, np.float32))
    for _ in range(5):
        rt.get()  # each Get eats the injected 60 ms delay
    rec.sample_now()
    ev = engine.evaluate_now()[0]
    assert ev.firing, (
        f"p99 {ev.value_short:.4f}s under 60ms injected delay did not "
        f"burn the 10ms objective")
    assert ev.value_short >= 0.05
    assert Dashboard.counter_value("SLO_BURN_ALERTS") == 1
    with open(path, encoding="utf-8") as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    events = [l for l in lines if l["kind"] == "event"]
    assert any(e["reason"] == "slo_burn" and e["slo"] == "get_p99"
               for e in events), events
    assert any(l["kind"] == "trace" for l in lines), (
        "no request traces beside the alert")
    client.close()
    mvt.shutdown()


# -- the metrics logger (twin of tests/test_obs.py's round trip) ---------------

def test_metrics_logger_jsonl_round_trip(tmp_path):
    from multiverso_tpu_torch.obs.logger import MetricsLogger, load_metrics
    from multiverso_tpu_torch.obs.metrics import Histogram
    path = _artifact_path(tmp_path, f"metrics-seed{SEED}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    observe("LOGGED_HIST_SECONDS", 0.002)
    count("LOGGED_CTR", 4)
    logger = MetricsLogger(path, interval=0.05)
    time.sleep(0.15)
    logger.close()
    logger.close()  # idempotent
    snaps = load_metrics(path)
    assert len(snaps) >= 2  # periodic lines + the final close() flush
    last = snaps[-1]
    assert set(last) >= {"t", "monitors", "counters", "gauges",
                         "histograms"}
    assert last["counters"]["LOGGED_CTR"] == 4
    hist = last["histograms"]["LOGGED_HIST_SECONDS"]
    assert hist["count"] == 1 and len(hist["buckets"]) == len(hist["bounds"])
    rebuilt = Histogram.from_dict("LOGGED_HIST_SECONDS", hist)
    assert rebuilt.p50 == Dashboard.histogram("LOGGED_HIST_SECONDS").p50


def test_metrics_path_flag_starts_and_stops_the_logger(tmp_path):
    """``init`` starts the logger under ``metrics_path`` and ``shutdown``
    flushes a last snapshot holding the run's Add counts."""
    from multiverso_tpu_torch.obs.logger import load_metrics
    path = str(tmp_path / "metrics.jsonl")
    mvt.init(device="cpu", metrics_path=path, metrics_interval_seconds=3600)
    table = mvt.create_table("matrix", 8, 4)
    table.add(np.ones((2, 4), np.float32), row_ids=[1, 5])
    mvt.shutdown()
    snaps = load_metrics(path)
    assert snaps and snaps[-1]["monitors"]["SERVER_PROCESS_ADD_MSG"]["count"] >= 1


def test_slo_spec_flag_starts_the_engine_and_profile_continuous_the_profiler():
    mvt.init(device="cpu", slo_spec="lag:gauge=REPLICA_LAG_RECORDS,target=500",
             slo_check_interval_seconds=0, profile_continuous=True,
             profile_hz=100)
    try:
        engine = mvt.slo_engine()
        assert engine is not None
        assert [o.name for o in engine.objectives] == ["lag"]
        assert mvt.profiler().running
    finally:
        mvt.shutdown()
    assert mvt.slo_engine() is None and not mvt.profiler().running


# -- names the reference's top level and obs package export, first call -------

FRESH_CALLS = {
    "Timer": "t = mvt.Timer(); t.start(); assert t.elapse_ms() >= 0",
    "register_program": ("mvt.init(device='cpu'); "
                         "mvt.register_program('p', lambda d, s: (d, s, 1)); "
                         "assert 'p' in mvt.registered_programs(); "
                         "mvt.shutdown()"),
    "registered_programs": "assert mvt.registered_programs() == []",
    "profiler": ("p = mvt.profiler(); assert not p.running; "
                 "p.sample_once(); assert p.samples == 1; "
                 "assert p is mvt.profiler()"),
    "TIMESERIES": ("from multiverso_tpu_torch.obs import TIMESERIES; "
                   "TIMESERIES.sample_now(t=1.0); "
                   "assert TIMESERIES.span_seconds() == 0.0"),
    "TimeSeriesRecorder": ("from multiverso_tpu_torch.obs import "
                           "TimeSeriesRecorder; r = TimeSeriesRecorder("
                           "interval=100.0); r.sample_now(t=1.0); "
                           "assert r.rate('X', 10.0) == 0.0"),
    "MetricsLogger": ("import tempfile, os; "
                      "from multiverso_tpu_torch.obs import MetricsLogger, "
                      "load_metrics; d = tempfile.mkdtemp(); "
                      "p = os.path.join(d, 'm.jsonl'); "
                      "MetricsLogger(p, interval=3600).close(); "
                      "assert len(load_metrics(p)) == 1"),
    "SLOEngine": ("from multiverso_tpu_torch.obs import SLOEngine, "
                  "default_objectives; "
                  "assert SLOEngine(objectives=default_objectives())"
                  ".evaluate_now() is not None"),
}


@pytest.mark.parametrize("name", sorted(FRESH_CALLS))
def test_top_level_and_obs_names_work_first_in_a_fresh_process(name):
    import subprocess
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    code = "import multiverso_tpu_torch as mvt\n" + FRESH_CALLS[name] + \
        "\nprint('FRESH_OK')\n"
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "FRESH_OK"
