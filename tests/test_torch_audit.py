"""The port's fleet integrity plane (``multiverso_tpu_torch/obs/audit.py``):
the cases of ``tests/test_audit.py`` on the port — order-independent digests of
every table kind, the tiered<->plain interchange folding cold rows without
promotion, the FleetAuditor's verdicts against an injected probe — plus
digest parity with the JAX package: the same state digests to the same 32
hex characters in both packages, for every table kind, and a live port
primary and its replica audit clean until a planted row diverges."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

import multiverso_tpu as jmv
from multiverso_tpu.obs import audit as jaudit
from multiverso_tpu.runtime.zoo import Zoo as JZoo
from multiverso_tpu.tables import ftrl_table as jftrl
from multiverso_tpu.tables import sparse_table as jsparse

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.io import MemoryStream
from multiverso_tpu_torch.obs.audit import (FleetAuditor, digest_payload,
                                            table_digest)
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables import ftrl_table as tftrl
from multiverso_tpu_torch.tables.kv_table import KVServer, TieredKVServer
from multiverso_tpu_torch.tables.sparse_table import (SparseFTRLServer,
                                                      SparseServer,
                                                      TieredSparseServer)

SEED = int(os.environ.get("MV_FAULT_SEED", "0"))


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread; whatever a test starts is stopped (tests/conftest.py
    resets the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mv.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


@pytest.fixture
def port_env():
    """World-of-1 port runtime: this process is worker 0 and the server."""
    mv.init()
    yield
    mv.shutdown()


# -- digests ------------------------------------------------------------------

def test_sparse_digest_order_independent_and_content_sensitive():
    """Two servers holding the SAME rows inserted in different orders
    digest equal; flipping one element changes the digest; row count
    rides the digest (an empty table != a table of zero rows at key 7)."""
    a, b = SparseServer(1000, width=2), SparseServer(1000, width=2)
    keys = np.array([3, 700, 41, 12], np.int64)
    vals = np.arange(8, dtype=np.float32).reshape(4, 2)
    a.process_add((keys, vals, None))
    for i in np.random.default_rng(SEED).permutation(4):
        b.process_add((keys[i:i + 1], vals[i:i + 1], None))
    assert table_digest(a) == table_digest(b)
    assert table_digest(a)["rows"] == 4

    b.process_add((keys[:1], np.float32([[1e-3, 0]]), None))
    assert table_digest(a)["digest"] != table_digest(b)["digest"]

    empty = SparseServer(1000, width=2)
    zero_row = SparseServer(1000, width=2)
    zero_row.process_add((np.array([7], np.int64),
                          np.zeros((1, 2), np.float32), None))
    assert table_digest(empty)["digest"] != table_digest(zero_row)["digest"]


def test_tiered_digest_folds_cold_rows_without_promotion(tmp_path):
    """The acceptance property: a tiered table digests equal to a plain
    table loaded from its snapshot, and digesting folds the cold segments
    in place — TIER_PROMOTIONS stays flat and the cold tier keeps its
    rows (an audit must not blow away the working set)."""
    tiered = TieredSparseServer(10_000, width=4,
                                resident_bytes=4 * 4 * 4, cold_bits=0,
                                tier_dir=str(tmp_path / "tier"))
    rng = np.random.default_rng(SEED)
    keys = rng.choice(10_000, 40, replace=False).astype(np.int64)
    vals = rng.normal(0, 1, (40, 4)).astype(np.float32)
    tiered.process_add((keys, vals, None))
    tiered._tier.maintain()
    assert tiered.tier_stats()["cold_rows"] > 0

    promotions = Dashboard.counter_value("TIER_PROMOTIONS")
    cold_before = tiered.tier_stats()["cold_rows"]
    tiered_digest = table_digest(tiered)
    assert Dashboard.counter_value("TIER_PROMOTIONS") == promotions
    assert tiered.tier_stats()["cold_rows"] == cold_before

    buf = MemoryStream()
    tiered.store(buf)
    buf.seek(0)
    plain = SparseServer(10_000, width=4)
    plain.load(buf)
    assert table_digest(plain) == tiered_digest
    tiered._tier.close()


def test_digest_covers_ftrl_kv_tiered_kv_and_dense_kinds(tmp_path):
    """Every server kind digests, and distinct states digest apart."""
    ftrl = SparseFTRLServer(100, width=2)
    ftrl.process_add((np.array([5], np.int64),
                      np.float32([[0.5, -0.5]]), None))
    d1 = table_digest(ftrl)
    ftrl.process_add((np.array([5], np.int64),
                      np.float32([[0.1, 0.1]]), None))
    assert table_digest(ftrl)["digest"] != d1["digest"]

    kv = KVServer(value_dtype=np.float32)
    kv.process_add(([3, 9], [10.0, 20.0], None))
    tkv = TieredKVServer(value_dtype=np.float32, cold_bits=0,
                         resident_bytes=4, tier_dir=str(tmp_path / "kv"))
    tkv.process_add(([3, 9], [10.0, 20.0], None))
    tkv._tier.maintain()
    # plain and tiered KV twins applying the same stream digest equal
    assert table_digest(kv) == table_digest(tkv)
    tkv._tier.close()


def test_digest_dense_kind_via_store_fallback(port_env):
    """Dense kinds fold their canonical store() stream as one pseudo-row:
    still process-stable and content-sensitive."""
    t = mv.create_table("array", 8, np.float32)
    d_zero = table_digest(t)
    assert d_zero["rows"] == 1
    t.add(np.ones(8, np.float32))
    assert table_digest(t)["digest"] != d_zero["digest"]


def test_digest_payload_shape():
    t = SparseServer(10, width=1)
    payload = digest_payload({0: t}, role="primary", endpoint="x:1",
                             watermark=7, layout_version=2)
    assert payload["role"] == "primary" and payload["watermark"] == 7
    assert payload["layout_version"] == 2
    assert set(payload["tables"][0]) == {"digest", "rows"}
    json.dumps(payload)  # wire/manifest safe


# -- the auditor against an injected probe ------------------------------------

def _payload(ep, role, wm, lv=1, digest="aaaa", rows=3):
    return {"role": role, "endpoint": ep, "watermark": wm,
            "layout_version": lv,
            "tables": {0: {"digest": digest, "rows": rows}}}


class _FakeFleet:
    endpoints = ["p0:1"]
    replica_endpoints = [["r0:1"]]
    base_dir = ""


def test_auditor_divergence_fires_metric_and_manifest_flight_dump(tmp_path):
    """A replica answering a DIFFERENT digest at the primary's watermark
    is divergence: AUDIT_DIVERGENCE counts, the report names both
    digests + the watermark, and ONE manifest-carrying flight dump fires
    (edge-triggered — a persisting divergence must not flood the
    recorder)."""
    path = str(tmp_path / "flight.jsonl")
    mv.set_flag("flight_recorder_path", path)

    def probe(ep, timeout):
        role = "primary" if ep.startswith("p") else "replica"
        return _payload(ep, role, wm=10,
                        digest="aaaa" if role == "primary" else "bbbb")

    auditor = FleetAuditor(_FakeFleet(), interval=0, probe=probe,
                           manifest={"cut_id": "c1", "layout_version": 1})
    report = auditor.check()
    assert not report["ok"] and len(report["divergences"]) == 1
    div = report["divergences"][0]
    assert div["kind"] == "digest_mismatch" and div["watermark"] == 10
    assert div["primary"]["digest"] == "aaaa"
    assert div["replica"]["digest"] == "bbbb"
    assert Dashboard.counter_value("AUDIT_DIVERGENCE") == 1
    assert Dashboard.counter_value("AUDIT_RUNS") == 1

    auditor.check()  # still diverged: counts again, does NOT re-dump
    assert Dashboard.counter_value("AUDIT_DIVERGENCE") == 2
    with open(path, encoding="utf-8") as fh:
        events = [json.loads(l) for l in fh if l.strip()]
    events = [e for e in events if e.get("kind") == "event"]
    assert len(events) == 1
    assert events[0]["reason"] == "audit_divergence"
    assert events[0]["manifest"]["cut_id"] == "c1"
    assert events[0]["watermarks"]


def test_auditor_skew_and_unreachable_are_not_divergence():
    """A lagging replica (different watermark) is skew — digests of
    different prefixes are incomparable; a dead replica is unreachable.
    Neither is divergence."""
    def probe(ep, timeout):
        if ep.startswith("r"):
            if ep == "r0:1":
                raise ConnectionError("dead")
            return _payload(ep, "replica", wm=8, digest="zzzz")
        return _payload(ep, "primary", wm=10)

    fleet = {"endpoints": ["p0:1"], "replicas": [["r0:1", "r1:1"]]}
    auditor = FleetAuditor(fleet, interval=0, probe=probe)
    report = auditor.check()
    assert report["ok"]
    assert report["unreachable"] == ["r0:1"] and report["skews"] == 1
    assert Dashboard.counter_value("AUDIT_SKEW_SKIPS") == 1
    assert Dashboard.counter_value("AUDIT_UNREACHABLE") == 1


def test_auditor_conservation_ledger_catches_watermark_regression():
    """Within one layout version a member's watermark must never move
    backwards — acked records vanishing is loss. A layout-version bump
    (migration fence) legitimately resets the lineage."""
    wms = iter([10, 4, 4])
    lvs = iter([1, 1, 2])

    def probe(ep, timeout):
        return _payload(ep, "primary", wm=next(wms), lv=next(lvs))

    auditor = FleetAuditor(["p0:1"], interval=0, probe=probe)
    assert auditor.check()["ok"]
    report = auditor.check()  # wm 10 -> 4 under the same layout: loss
    kinds = [d["kind"] for d in report["divergences"]]
    assert kinds == ["watermark_regression"]
    assert auditor.check()["ok"]  # wm 4 again but lv bumped: clean slate


def test_auditor_background_mode_sweeps(tmp_path):
    """mv.audit with an interval runs sweeps on its own thread."""
    calls = []

    def probe(ep, timeout):
        calls.append(ep)
        return _payload(ep, "primary", wm=1)

    auditor = FleetAuditor(["p0:1"], interval=0.05, probe=probe).start()
    try:
        # a role-less process running a background auditor is stamped
        # with the "auditor" Prometheus role label
        assert Dashboard.identity().get("role") == "auditor"
        deadline = time.monotonic() + 5.0
        while len(calls) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(calls) >= 2
        assert auditor.last_report is not None
    finally:
        auditor.stop()


# -- parity with the JAX package -------------------------------------------------

def _seeded_ops(rng):
    """Integer-valued Adds for every table kind (exact in float32)."""
    ids = rng.integers(0, 32, 12).astype(np.int32)
    keys = rng.choice(500, 20, replace=False).astype(np.int64)
    return {
        "array": (rng.integers(-5, 6, 16).astype(np.float32),),
        "array_int": (rng.integers(-5, 6, 9).astype(np.int32),),
        "matrix": (rng.integers(-5, 6, (12, 4)).astype(np.float32), ids),
        "kv": (keys[:6], rng.integers(-9, 10, 6).astype(np.int64)),
        "kv_device": (keys[:8].astype(np.int32),
                      rng.integers(-9, 10, 8).astype(np.float32)),
        "sparse": (keys, rng.integers(-3, 4, (20, 2)).astype(np.float32)),
        "tiered_sparse": (keys,
                          rng.integers(-3, 4, (20, 4)).astype(np.float32)),
        "tiered_kv": (keys[:10], rng.integers(-9, 10, 10).astype(np.float32)),
    }


def _make(pkg, kind, tier_dir):
    if kind == "array":
        return pkg.create_table("array", 16, np.float32)
    if kind == "array_int":
        return pkg.create_table("array", 9, np.int32)
    if kind == "matrix":
        return pkg.create_table("matrix", 32, 4)
    if kind == "kv":
        return pkg.create_table("kv", np.int64)
    if kind == "kv_device":
        return pkg.create_table("kv", np.float32, capacity=256)
    if kind == "sparse":
        return pkg.create_table("sparse", 500, 2)
    if kind == "tiered_sparse":
        return pkg.create_table("tiered_sparse", 500, 4,
                                resident_bytes=4 * 4 * 4, cold_bits=0,
                                tier_dir=tier_dir)
    return pkg.create_table("tiered_kv", np.float32, resident_bytes=8,
                            cold_bits=0, tier_dir=tier_dir)


def _apply(table, kind, ops):
    args = ops[kind]
    if kind == "matrix":
        table.add(args[0], row_ids=args[1])
    elif len(args) == 1:
        table.add(args[0])
    else:
        table.add(*args)


KINDS = ["array", "array_int", "matrix", "kv", "kv_device", "sparse",
         "tiered_sparse", "tiered_kv"]


@pytest.mark.parametrize("kind", KINDS)
def test_digest_parity_with_jax_for_every_kind(kind, tmp_path):
    """The same seeded Adds into a table of each kind in both packages:
    ``table_digest`` is the same string (and row count) in both."""
    ops = _seeded_ops(np.random.default_rng(SEED + 3))
    jmv.init()
    jt = _make(jmv, kind, str(tmp_path / "jtier"))
    _apply(jt, kind, ops)
    mv.init()
    pt = _make(mv, kind, str(tmp_path / "ptier"))
    _apply(pt, kind, ops)
    with JZoo.instance().admin():
        want = jaudit.table_digest(jt)
    with Zoo.instance().admin():
        got = Zoo.instance().server.run_serialized(
            lambda: table_digest(pt))
    assert got == want
    mv.shutdown()
    jmv.shutdown()


def test_digest_parity_ftrl_kinds():
    """The sparse FTRL server's (z, n) rows and the dense FTRL table's
    stored bytes digest alike in both packages."""
    rng = np.random.default_rng(SEED + 5)
    keys = rng.choice(100, 6, replace=False).astype(np.int64)
    grads = rng.integers(-3, 4, (6, 2)).astype(np.float32) / 4
    jsp, tsp = jsparse.SparseFTRLServer(100, width=2), SparseFTRLServer(
        100, width=2)
    jsp.process_add((keys, grads, None))
    tsp.process_add((keys, grads, None))
    assert table_digest(tsp) == jaudit.table_digest(jsp)
    assert table_digest(tsp)["rows"] == 6

    jmv.init()
    mv.init()
    dense_grad = rng.integers(-3, 4, 10).astype(np.float32) / 4
    jd, td = jftrl.FTRLServer(10), tftrl.FTRLServer(10)
    jd.process_add((dense_grad, None))
    td.process_add((dense_grad, None))
    assert table_digest(td) == jaudit.table_digest(jd)
    mv.shutdown()
    jmv.shutdown()


def _spawn_primary(wal_dir):
    """The port's durable child primary (an 8-float array table)."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(here) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    child = subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_durable_primary_child.py"),
         str(port), str(wal_dir)], stdout=subprocess.PIPE, text=True, env=env)
    line = child.stdout.readline()
    while line and not line.strip().startswith("serving "):
        line = child.stdout.readline()
    if not line:
        child.kill()
        raise AssertionError("primary child died during startup")
    _, endpoint, table_id = line.split()
    return child, endpoint, int(table_id)


def test_live_primary_and_replica_audit_then_planted_divergence(tmp_path):
    """A port primary (child process) and this process's read replica
    answer ``Control_Digest`` at a common watermark: ``mv.audit`` reports
    them equal, and so does the JAX package's auditor over the same
    endpoints; a planted corrupt row on the replica fires
    ``AUDIT_DIVERGENCE``."""
    from multiverso_tpu_torch.fault.inject import corrupt_table_row
    child, endpoint, table_id = _spawn_primary(tmp_path / "primary")
    try:
        mv.init(ps_role="server", remote_workers=2,
                wal_dir=str(tmp_path / "replica"), heartbeat_seconds=0.2,
                lease_seconds=30.0)
        replica_table = mv.create_table("array", 8, np.float32)
        standby = mv.warm_standby(endpoint, endpoint, takeover=False)
        assert standby.synced.wait(60)
        read_ep = standby.serve_reads()
        client = mv.remote_connect(endpoint)
        rt = client.table(table_id)
        rng = np.random.default_rng(SEED)
        for _ in range(5):
            rt.add(rng.integers(-4, 5, 8).astype(np.float32))
        deadline = time.monotonic() + 20
        while standby.applied_watermark < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        fleet = {"endpoints": [endpoint], "replicas": [[read_ep]]}
        report = mv.audit(fleet, interval=0).check()
        assert report["ok"] and not report["skews"], report
        p, r = mv.digest(endpoint), mv.digest(read_ep)
        assert p["watermark"] == r["watermark"] == 5
        assert p["tables"][table_id] == r["tables"][table_id]
        assert jaudit.FleetAuditor(fleet, interval=0).check()["ok"]

        assert standby._run(lambda: corrupt_table_row(replica_table, 3))
        report = mv.audit(fleet, interval=0).check()
        assert not report["ok"]
        assert report["divergences"][0]["kind"] == "digest_mismatch"
        assert Dashboard.counter_value("AUDIT_DIVERGENCE") >= 1
        standby.stop()
        client.close()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_probes_degrade_against_fenced_donor_and_dead_member():
    """A fenced retired donor (layout_version bumped after a migration's
    cutover: it refuses data traffic with Reply_WrongShard) still answers
    every control probe the port serves — stats, watermark, traces,
    profile, digest (reporting its fence); a dead endpoint's probe raises
    rather than hangs. The port has no ``stats_all`` or ``attribution``
    yet, so the dead member is probed alone."""
    from multiverso_tpu_torch.runtime.message import MsgType
    from multiverso_tpu_torch.runtime.remote import (control_probe,
                                                     fetch_digest)
    mv.init(remote_workers=1)
    mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    Zoo.instance().remote_server.layout_version = 5
    assert fetch_digest(endpoint, timeout=10.0)["layout_version"] == 5
    from multiverso_tpu.runtime.remote import fetch_digest as jfetch_digest
    assert jfetch_digest(endpoint, timeout=10.0)["layout_version"] == 5
    assert control_probe(endpoint, MsgType.Control_Profile,
                         MsgType.Control_Reply_Profile,
                         timeout=10.0)["role"] == "primary"
    assert control_probe(endpoint, MsgType.Control_Traces,
                         MsgType.Control_Reply_Traces,
                         timeout=10.0)["role"] == "primary"
    assert mv.watermark(endpoint)["role"] == "primary"
    assert mv.stats(endpoint).counter("WORKER_EVICTIONS") == 0
    dead = "127.0.0.1:1"  # nothing listens on the reserved port
    with pytest.raises((OSError, RuntimeError)):
        mv.stats(dead, timeout=1.0)
    with pytest.raises((OSError, RuntimeError)):
        fetch_digest(dead, timeout=1.0)
