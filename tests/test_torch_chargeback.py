"""Twins of ``tests/test_chargeback.py`` on the port: tenant resolution
and propagation, the ``mvt.chargeback`` cost table (``obs/chargeback.py``),
the ``mvtpu_tenant_*{tenant=...}`` Prometheus exposition, per-tenant rate
windows, the ``TenantQuotas.parse`` DSL edges, and SLO-burn-driven
deadline tightening (``runtime/remote.py`` ``DeadlineMinter`` and the
``deadline_tighten_ratio`` flag).

The two ``FleetSense`` cases hold the port's ``autopilot/sensors.py``. The
reference's two-tenant drill fails in the JAX package's own test runs,
so its twin is also held against an oracle: the charged shares must
equal the shares of the seconds each tenant's stitched spans took,
summed hop to hop.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.dashboard import Dashboard, count, split_tenant
from multiverso_tpu_torch.obs.chargeback import (ChargebackReport, _is_apply_wal,
                                           charge)
from multiverso_tpu_torch.obs.collector import (StitchedTrace, TraceCollector,
                                          _normalize_tenants)
from multiverso_tpu_torch.obs.timeseries import TimeSeriesRecorder
from multiverso_tpu_torch.obs.trace import DEFAULT_TENANT, TRACES
from multiverso_tpu_torch.runtime.admission import (AdmissionGate, TenantQuotas,
                                              resolve_tenant)
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.remote import DeadlineMinter

SEED = int(os.environ.get("MV_CHAOS_SEED", "0"))


@pytest.fixture(autouse=True)
def port_runtime():
    """Fresh port flags, dashboard and trace store per case; the runtime
    stopped after it (``tests/conftest.py`` resets only the JAX
    package's)."""
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
    TORCH_FLAGS.reset()
    Dashboard.reset()
    TRACES.reset()     # spans an earlier file left in this process
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _artifact_path(tmp_path, name):
    art = os.environ.get("MV_CHAOS_ARTIFACT_DIR")
    if art:
        os.makedirs(art, exist_ok=True)
        return os.path.join(art, name)
    return str(tmp_path / name)


# -- TenantQuotas.parse DSL edges (satellite) ---------------------------------

def test_parse_empty_and_whitespace_specs_mean_no_quotas():
    for spec in ("", "   ", ";", " ; ; ", "\t;\n"):
        quotas = TenantQuotas.parse(spec)
        assert quotas.names() == {}, spec
        assert quotas.refusal(0) is None  # nothing metered, all admitted


def test_parse_fatal_edges():
    for bad in (":tables=0,qps=1",        # empty tenant name
                "t:",                     # name without a body
                "t:tables=,qps=1",        # tables= with no ids
                "t:tables=0,qps=0",       # qps must be > 0
                "t:tables=0,qps=-1"):
        with pytest.raises(mvt.log.FatalError):
            TenantQuotas.parse(bad)


def test_parse_whitespace_tolerant_entries():
    quotas = TenantQuotas.parse(
        "  a : tables=0|2 , qps=5 ;  ; b : tables=1 , qps=7 , burst=9 ")
    assert quotas.names() == {0: "a", 2: "a", 1: "b"}


# -- resolve_tenant (tentpole part 1) -----------------------------------------

def test_resolve_tenant_follows_the_flag():
    assert resolve_tenant(0) == DEFAULT_TENANT
    mvt.set_flag("tenant_quota_spec", "ctr:tables=0|1,qps=5;rk:tables=2,qps=5")
    assert resolve_tenant(0) == "ctr"
    assert resolve_tenant(1) == "ctr"
    assert resolve_tenant(2) == "rk"
    assert resolve_tenant(99) == DEFAULT_TENANT
    # the cache follows a flag CHANGE (re-parse on new spec value)
    mvt.set_flag("tenant_quota_spec", "solo:tables=2,qps=5")
    assert resolve_tenant(2) == "solo"
    assert resolve_tenant(0) == DEFAULT_TENANT


def test_resolve_tenant_never_raises_on_a_bad_spec():
    """Labeling reads must not take down the request path: a spec that
    parse() would log.fatal on resolves everything to the default."""
    mvt.set_flag("tenant_quota_spec", "not a spec")
    assert resolve_tenant(0) == DEFAULT_TENANT


def test_resolve_tenant_spends_no_tokens():
    """resolve_tenant is labeling, not enforcement — resolving must not
    drain the quota bucket the admission gate spends from."""
    mvt.set_flag("tenant_quota_spec", "t:tables=0,qps=0.001,burst=1")
    for _ in range(10):
        assert resolve_tenant(0) == "t"
    quotas = TenantQuotas.parse(str(mvt.get_flag("tenant_quota_spec")))
    assert quotas.refusal(0) is None  # the burst token is still there


# -- trace tenant tags (tentpole part 1: propagation) -------------------------

def test_trace_store_tags_live_spans_only_and_prunes_on_eviction():
    from multiverso_tpu_torch.obs.trace import TraceStore
    store = TraceStore(max_traces=2)
    store.tag_tenant(1, "ghost")          # no trace 1 yet: dropped
    assert store.tenant_of(1) == DEFAULT_TENANT
    store.hop(1, "client_send")
    store.tag_tenant(1, "ctr")
    store.tag_tenant(1, DEFAULT_TENANT)   # default is never stored
    assert store.tenant_of(1) == "ctr"
    store.hop(2, "client_send")
    store.tag_tenant(2, "rk")
    store.hop(3, "client_send")           # evicts trace 1 (+ its tag)
    assert store.tenant_of(1) == DEFAULT_TENANT
    assert store.export_tenants(10) == {2: "rk"}
    store.reset()
    assert store.export_tenants(10) == {}


def test_collector_normalizes_and_prefers_first_nondefault_tag():
    assert _normalize_tenants(None) == {}
    assert _normalize_tenants("junk") == {}
    assert _normalize_tenants({"7": "ctr", "bad": "x"}) == {7: "ctr"}
    collector = TraceCollector([], include_local=False)
    collector.stores = {
        "local": {7: [("client_send", 100)]},
        "primary@a": {7: [("apply_add", 200)], 8: [("serve_get", 50)]},
    }
    collector.tenant_tags = {"local": {}, "primary@a": {7: "ctr"}}
    collector.offsets = {"local": 0, "primary@a": 0}
    spans = {s.req_id: s for s in collector.stitch()}
    assert spans[7].tenant == "ctr"       # tagged anywhere -> attributed
    assert spans[8].tenant == DEFAULT_TENANT


# -- the chargeback table (tentpole part 2) -----------------------------------

def _span(rid, tenant, hops):
    return StitchedTrace(req_id=rid, tenant=tenant, hops=hops)


def test_is_apply_wal_classification():
    assert _is_apply_wal("wal_append->apply_add")
    assert _is_apply_wal("dispatch_enqueue->wal_append")
    assert _is_apply_wal("wire:client_send->apply_add")
    assert not _is_apply_wal("client_send->reply_sent")
    assert not _is_apply_wal("serve_get->reply_sent")


def test_charge_partitions_time_and_shares_sum_to_one():
    ms = 1_000_000  # ns
    spans = [
        _span(1, "writer", [("c", "client_send", 0),
                            ("s", "wal_append", 2 * ms),
                            ("s", "apply_add", 5 * ms)]),
        _span(2, "reader", [("c", "client_read_submit", 0),
                            ("s", "serve_get", 1 * ms)]),
        _span(3, DEFAULT_TENANT, [("c", "client_send", 0),
                                  ("c", "reply_sent", 1 * ms)]),
        _span(4, "writer", [("c", "client_send", 0)]),  # <2 hops: ignored
    ]
    report = charge(spans, counters={"writer": {"BYTES": 64, "ADMITTED": 2},
                                     "idle": {"SHED": 3}})
    assert report.traces == 3
    assert abs(sum(r["share"] for r in report.rows) - 1.0) < 1e-9
    writer = report.row("writer")
    assert writer["total_ms"] == pytest.approx(5.0)
    assert writer["apply_wal_ms"] == pytest.approx(5.0)
    assert writer["bytes"] == 64 and writer["admitted"] == 2
    assert report.row("reader")["apply_wal_ms"] == 0.0
    assert report.row(DEFAULT_TENANT)["spans"] == 1
    # a tenant visible only in counters still gets a (zero-time) row
    idle = report.row("idle")
    assert idle["shed"] == 3 and idle["share"] == 0.0
    text = report.render()
    assert "chargeback over 3 trace(s)" in text
    assert "writer" in text and "idle" in text


def test_charge_quantile_keeps_the_slow_tail():
    ms = 1_000_000
    spans = [_span(i, "fast", [("c", "a", 0), ("c", "b", 1 * ms)])
             for i in range(9)]
    spans.append(_span(99, "slow", [("c", "a", 0), ("c", "b", 100 * ms)]))
    report = charge(spans, quantile=0.9)
    assert [r["tenant"] for r in report.rows] == ["slow"]
    assert report.row("slow")["share"] == pytest.approx(1.0)


def test_charge_empty_renders_without_rows():
    report = charge([])
    assert isinstance(report, ChargebackReport)
    assert report.rows == [] and "<no tenant" in report.render()


# -- labeled exposition (tentpole part 3) -------------------------------------

def test_split_tenant_names():
    assert split_tenant("TENANT_ctr_ADMITTED") == ("ctr", "ADMITTED")
    assert split_tenant("TENANT_ctr_SHED") == ("ctr", "SHED")
    assert split_tenant("TENANT__default_BYTES") == ("_default", "BYTES")
    assert split_tenant("TENANT_a_b_SHED") == ("a_b", "SHED")
    assert split_tenant("SHED_ADDS") == (None, None)
    assert split_tenant("TENANT_x_UNKNOWN") == (None, None)


def test_prom_exposition_splits_tenant_series_into_labels():
    count("TENANT_ctr_ADMITTED", 5)
    count("TENANT_ctr_SHED", 2)
    count("TENANT_rk_ADMITTED", 7)
    count("SHED_ADDS", 2)  # non-tenant counters keep their plain family
    prom = Dashboard.render("prom")
    assert 'mvtpu_tenant_admitted_total{tenant="ctr"} 5' in prom
    assert 'mvtpu_tenant_admitted_total{tenant="rk"} 7' in prom
    assert 'mvtpu_tenant_shed_total{tenant="ctr"} 2' in prom
    assert "mvtpu_shed_adds_total 2" in prom
    # one TYPE line per family even with two tenant series in it
    assert prom.count("# TYPE mvtpu_tenant_admitted counter") == 1


def test_timeseries_tenant_rates_window():
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    count("TENANT_ctr_SHED", 0)
    count("TENANT_rk_SHED", 0)
    rec.sample_now(t=0.0)
    count("TENANT_ctr_SHED", 30)
    count("TENANT_rk_SHED", 10)
    count("TENANT_ctr_ADMITTED", 50)
    rec.sample_now(t=10.0)
    shed = rec.tenant_rates("SHED", 30.0)
    assert shed["ctr"] == pytest.approx(3.0)
    assert shed["rk"] == pytest.approx(1.0)
    admitted = rec.tenant_rates("ADMITTED", 30.0)
    assert admitted["ctr"] == pytest.approx(5.0)
    # (counters from earlier tests linger as zero-rate entries — the
    # registry zeroes in place — so assert no BYTES were *moving*)
    assert all(v == 0.0 for v in rec.tenant_rates("BYTES", 30.0).values())
    assert TimeSeriesRecorder(interval=100.0).tenant_rates("SHED", 30.0) \
        == {}


def test_fleet_sense_carries_tenant_shed_rates():
    from multiverso_tpu_torch.autopilot.sensors import FleetSensors
    rec = TimeSeriesRecorder(interval=100.0, samples=16)
    count("TENANT_noisy_SHED", 0)
    rec.sample_now(t=0.0)
    count("TENANT_noisy_SHED", 20)
    rec.sample_now(t=10.0)
    group = type("G", (), {"num_shards": 1, "replica_endpoints": []})()
    sensors = FleetSensors(group, recorder=rec, window=30.0,
                           probe=lambda ep, timeout: {})
    sense = sensors.read(now=10.0)
    # (Dashboard.reset zeroes counters in place, so tenants from other
    # tests may linger as 0.0-rate entries — assert on ours)
    assert sense.tenant_shed_rates["noisy"] == pytest.approx(2.0)
    assert sense.as_dict()["tenant_shed_rates"]["noisy"] == \
        pytest.approx(2.0)


def test_fleet_sense_degrades_on_minimal_fake_recorders():
    """Injected fake recorders without tenant_rates (older tests, ad-hoc
    tools) must not crash the sensor sweep."""
    from multiverso_tpu_torch.autopilot.sensors import FleetSensors

    class FakeRec:
        def rate(self, name, window):
            return 0.0

        def quantile(self, name, q, window):
            return 0.0

        def gauge(self, name):
            return 0.0

        def window_histogram(self, name, window):
            return None

    group = type("G", (), {"num_shards": 1, "replica_endpoints": []})()
    sensors = FleetSensors(group, recorder=FakeRec(), window=30.0,
                           probe=lambda ep, timeout: {})
    assert sensors.read(now=1.0).tenant_shed_rates == {}


# -- gate attribution for non-quota sheds -------------------------------------

def _add_msg(table_id, req_id=1):
    return Message(src=5, dst=0, type=MsgType.Request_Add,
                   table_id=table_id, msg_id=req_id, req_id=req_id)


def test_backlog_shed_is_tenant_attributed():
    gate = AdmissionGate(queue_limit=1,
                         tenants=TenantQuotas.parse("ctr:tables=0,qps=100"))
    assert gate.refusal(_add_msg(0), depth=99) is not None
    assert gate.refusal(_add_msg(5), depth=99) is not None  # unmetered
    assert Dashboard.counter_value("TENANT_ctr_SHED") == 1
    assert Dashboard.counter_value(f"TENANT_{DEFAULT_TENANT}_SHED") == 1


def test_admitted_unmetered_add_folds_into_default_tenant():
    gate = AdmissionGate(queue_limit=0, tenants=TenantQuotas.parse(""))
    assert gate.refusal(_add_msg(3), depth=0) is None
    assert Dashboard.counter_value(
        f"TENANT_{DEFAULT_TENANT}_ADMITTED") == 1
    # in-process messages (req_id 0) are never tenant-counted
    assert gate.refusal(_add_msg(3, req_id=0), depth=0) is None
    assert Dashboard.counter_value(
        f"TENANT_{DEFAULT_TENANT}_ADMITTED") == 1


# -- deadline tightening (tentpole part 4) ------------------------------------

def test_minter_flag_off_is_bit_identical_legacy_minting():
    minter = DeadlineMinter(2.0, ratio=0.0, burn=lambda: True)
    before = time.monotonic()
    deadline = minter.mint()
    after = time.monotonic()
    assert before + 2.0 <= deadline <= after + 2.0
    assert minter.scale == 1.0
    assert Dashboard.counter_value("DEADLINE_TIGHTENED") == 0
    # budget 0 stays "no deadline" regardless of the ratio
    assert DeadlineMinter(0.0, ratio=0.5, burn=lambda: True).mint() == 0.0


def test_minter_tightens_to_floor_and_recovers(tmp_path):
    path = _artifact_path(tmp_path, f"flight-deadline-seed{SEED}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    mvt.set_flag("flight_recorder_path", path)
    mvt.set_flag("flight_recorder_min_interval_seconds", 0.0)
    burning = [True]
    minter = DeadlineMinter(10.0, ratio=0.25, burn=lambda: burning[0])
    scales = []
    for _ in range(12):
        deadline = minter.mint()
        scales.append(minter.scale)
        assert deadline - time.monotonic() <= 10.0 * scales[-1] + 0.01
    # geometric shrink, clamped at the configured floor
    assert scales[0] == pytest.approx(0.7)
    assert all(b <= a for a, b in zip(scales, scales[1:]))
    assert scales[-1] == pytest.approx(0.25)
    assert Dashboard.counter_value("DEADLINE_TIGHTENED") == 12
    assert Dashboard.gauge_value("DEADLINE_SCALE") == pytest.approx(0.25)
    burning[0] = False
    recovered = []
    for _ in range(12):
        minter.mint()
        recovered.append(minter.scale)
    assert recovered[-1] == 1.0
    assert all(b >= a for a, b in zip(recovered, recovered[1:]))
    with open(path, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    reasons = [e["reason"] for e in events if e.get("kind") == "event"]
    assert "deadline_tighten" in reasons      # the 1.0 -> <1.0 edge
    assert "deadline_recovered" in reasons    # the back-to-1.0 edge
    tighten = next(e for e in events if e.get("reason") ==
                   "deadline_tighten")
    assert tighten["floor"] == 0.25 and tighten["budget"] == 10.0


def test_minter_driven_by_a_seeded_slo_burn():
    """The default burn probe is the SLO engine: seed a p99 burn, watch
    minted deadlines shrink; clear it, watch them recover."""
    from multiverso_tpu_torch.dashboard import observe
    from multiverso_tpu_torch.obs.slo import Objective, SLOEngine
    rec = TimeSeriesRecorder(interval=100.0, samples=32)
    engine = SLOEngine(recorder=rec, objectives=[
        Objective(name="get_p99", kind="histogram",
                  metric="CB_SLO_SECONDS", quantile=0.99, target=0.010,
                  windows=(20.0, 100.0))])
    rec.sample_now(t=0.0)
    for _ in range(50):
        observe("CB_SLO_SECONDS", 0.2)        # 20x over budget
    rec.sample_now(t=10.0)
    engine.evaluate_now()
    assert engine.firing() == ["get_p99"]
    minter = DeadlineMinter(10.0, ratio=0.5,
                            burn=lambda: bool(engine.firing()))
    for _ in range(8):
        minter.mint()
    assert minter.scale == pytest.approx(0.5)
    for _ in range(50):
        observe("CB_SLO_SECONDS", 0.001)      # healthy again
    # push the burn samples out of both burn windows (20s / 100s)
    rec.sample_now(t=115.0)
    rec.sample_now(t=120.0)
    engine.evaluate_now()
    assert not engine.firing()
    for _ in range(8):
        minter.mint()
    assert minter.scale == 1.0


def test_remote_client_mints_through_the_flagged_minter():
    mvt.set_flag("request_deadline_seconds", 5.0)
    mvt.set_flag("deadline_tighten_ratio", 0.3)
    mvt.init(remote_workers=1, device="cpu")
    table = mvt.create_table("array", 4, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    try:
        assert client._minter.budget == 5.0
        assert client._minter.ratio == 0.3
        rt = client.table(table.table_id)
        rt.add(np.ones(4, np.float32))  # healthy: full-budget deadlines
        assert client._minter.scale == 1.0
        np.testing.assert_array_equal(np.asarray(rt.get()),
                                      np.ones(4, np.float32))
    finally:
        client.close()
        mvt.shutdown()


# -- the two-tenant drill (acceptance) ----------------------------------------

def test_two_tenant_drill_chargeback_and_exposition(tmp_path):
    """One write-heavy and one read-heavy tenant against a live 2-shard
    group: chargeback shares sum to 1.0 +- 0.01, the write-heavy tenant
    owns the majority of apply+wal time, and the tenant-labeled
    Prometheus series exist for both tenants."""
    from multiverso_tpu_torch.shard.group import ShardGroup

    spec = ("writer:tables=0,qps=1e6,burst=1e6;"
            "reader:tables=1,qps=1e6,burst=1e6")
    rows, cols = 16, 8
    group = ShardGroup(
        [{"kind": "matrix", "num_row": rows, "num_col": cols},
         {"kind": "matrix", "num_row": rows, "num_col": cols}],
        shards=2, device="cpu",
        flags={"remote_workers": 8,
               "tenant_quota_spec": spec,
               "heartbeat_seconds": 0.2}).start()
    try:
        # group flags reach only the CHILD servers; the client submit
        # sites resolve the local flag to tag spans
        mvt.set_flag("tenant_quota_spec", spec)
        client = group.connect()
        train, serve = client.table(0), client.table(1)
        vals = np.ones((2, cols), np.float32)
        ids = np.arange(2, dtype=np.int32)
        stop = threading.Event()
        read_errors = []

        def reader():
            rids = np.zeros(1, np.int32)
            while not stop.is_set():
                try:
                    serve.get(row_ids=rids)
                except Exception as exc:  # noqa: BLE001
                    read_errors.append(exc)
                    return
                time.sleep(0.002)

        flood = threading.Thread(target=reader, daemon=True)
        flood.start()
        for i in range(60):
            ids[0], ids[1] = i % rows, (i + 7) % rows
            train.add(vals, row_ids=ids)
        stop.set()
        flood.join(timeout=30)
        assert not read_errors, read_errors

        report = mvt.chargeback(group, timeout=30.0)
        shares = {r["tenant"]: r["share"] for r in report.rows}
        # the oracle: each tenant's share of the seconds its stitched
        # spans took, hop to hop (a gap below zero, left by residual
        # clock skew, counts as none); the stores are idle now
        seconds = {}
        for span in mvt.traces(group, timeout=30.0):
            times = [t for _, _, t in span.hops]
            if len(times) >= 2:
                spent = sum(max(0, b - a) for a, b in zip(times, times[1:]))
                seconds[span.tenant] = (seconds.get(span.tenant, 0.0)
                                        + spent / 1e9)
        total = sum(seconds.values())
        assert total > 0 and set(seconds) <= set(shares), (seconds, shares)
        for tenant, share in shares.items():
            assert abs(share - seconds.get(tenant, 0.0) / total) <= 1e-6, (
                tenant, share, seconds)
        assert "writer" in shares and "reader" in shares
        assert abs(sum(shares.values()) - 1.0) <= 0.01
        apply_wal = {r["tenant"]: r["apply_wal_ms"] for r in report.rows}
        total_apply_wal = sum(apply_wal.values())
        assert total_apply_wal > 0
        assert apply_wal["writer"] > 0.5 * total_apply_wal, apply_wal
        writer_row = report.row("writer")
        assert writer_row["admitted"] > 0 and writer_row["bytes"] > 0

        # both tenants appear as labeled series in the local exposition
        # (client-side BYTES families — the same split the children
        # apply to their ADMITTED/SHED families)
        prom = Dashboard.render("prom")
        assert 'mvtpu_tenant_bytes_total{tenant="writer"}' in prom
        assert 'mvtpu_tenant_bytes_total{tenant="reader"}' in prom
        # and the children counted the writer's Adds under its tenant
        admitted = sum(mvt.stats(ep, timeout=30.0)
                       .counter("TENANT_writer_ADMITTED")
                       for ep in group.endpoints)
        assert admitted > 0

        out = _artifact_path(tmp_path, f"chargeback-seed{SEED}.json")
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(report.to_dict(), fh, indent=2, sort_keys=True)
        client.close()
    finally:
        group.stop()
