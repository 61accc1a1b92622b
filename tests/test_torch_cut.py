"""The port's fleet-wide consistent cuts (``multiverso_tpu_torch/durable/
cut.py``) against the JAX package's (``tests/test_cut.py``), live over
shard processes on the CPU:

* cut → restore round trip of a 2-shard fleet: the restored fleet serves
  exactly the state at the cut (post-cut writes gone), every restored
  primary's digest equals the manifest's, and a pre-cut Add resent byte
  for byte is answered from the seeded dedup window, not applied twice;
* a cut taken after a live split restores the split layout (the JAX
  package's cut names the start-time spans there: ``ROADMAP.md`` queue 3);
* a clone of a live fleet digests equal to its source;
* the replica-corruption drill: the auditor catches one flipped row of a
  replica's applied state (``MV_AUDIT_CORRUPT``);
* the port's ``restore_fleet`` of a cut taken by a JAX group: digests
  equal to the JAX group's at the fence (the cut's table files are the
  checkpoint frames both packages write).

The chaos arms keep the reference's env gate (``MV_CUT_KILL``)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.shard.group import ShardGroup as JShardGroup

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.durable.cut import load_cut_manifest
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id
from multiverso_tpu_torch.runtime.net import TcpNet
from multiverso_tpu_torch.runtime.remote import fetch_digest
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.shard.group import ShardGroup

GROUP_FLAGS = {"remote_workers": 4, "heartbeat_seconds": 0.2,
               "lease_seconds": 1.5, "request_retry_seconds": 1.0,
               "reconnect_deadline_seconds": 30.0}
START_S = 120
TABLES = [{"kind": "sparse", "key_space": 1000, "width": 2},
          {"kind": "kv", "value_dtype": "<i8"},
          {"kind": "matrix", "num_row": 20, "num_col": 3}]


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
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _digests(tables):
    """JSON/wire round trips stringify int table ids."""
    return {int(k): dict(v) for k, v in tables.items()}


def _resend(endpoint, msg):
    """One prepared frame over a fresh connection; the reply's type."""
    net = TcpNet()
    net.rank = -1
    net.connect([endpoint])
    try:
        net.send(msg)
        reply = net.recv()
        while reply is not None and reply.msg_id != msg.msg_id:
            reply = net.recv()
    finally:
        net.finalize()
    return reply.type


def test_cut_restore_roundtrip_two_shards(tmp_path, monkeypatch):
    monkeypatch.delenv("MV_CUT_KILL", raising=False)
    with ShardGroup(TABLES, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path / "src"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        sp, kv, mat = client.tables()
        keys = np.array([3, 500, 41, 999], np.int64)
        vals = np.arange(8, dtype=np.float32).reshape(4, 2)
        sp.add(keys, vals)
        kv.add([5, 700], [11, 22])
        rows = np.array([0, 9, 10, 19], np.int32)  # both shards
        mat.add(np.ones((4, 3), np.float32), row_ids=rows)
        # an Add acknowledged before the cut, as a raw frame to keep
        pre = Message(src=-1, dst=0, type=MsgType.Request_Add, table_id=2,
                      msg_id=next_msg_id(), req_id=(1 << 61) + 7,
                      data=wire.encode((np.array([1], np.int32),
                                        np.full((1, 3), 2.0, np.float32),
                                        mvt.AddOption(worker_id=-1))))
        assert _resend(group.endpoints[0], pre) == MsgType.Reply_Add
        manifest = mvt.cut_fleet(group, cut_id="roundtrip")
        assert manifest["cut_id"] == "roundtrip"
        assert set(manifest["watermarks"]) == set(group.endpoints)
        assert load_cut_manifest(group)["cut_id"] == "roundtrip"
        assert Dashboard.counter_value("CUT_FLEET_COMMITS") == 1
        sp.add(keys, vals)
        kv.add([5, 31337], [100, 9])
        mat.add(np.ones((4, 3), np.float32), row_ids=rows)
        np.testing.assert_array_equal(sp.get(keys), 2 * vals)
        client.close()

    restored = mvt.restore_fleet(group.base_dir, device="cpu",
                                 base_dir=str(tmp_path / "restored"),
                                 timeout=START_S)
    try:
        assert restored.device == "cpu"
        for shard in load_cut_manifest(group)["shards"]:
            live = fetch_digest(restored.endpoints[int(shard["shard"])],
                                timeout=30.0)
            assert _digests(live["tables"]) == _digests(shard["digests"])
        # the pre-cut Add's retransmit: answered, not applied
        assert _resend(restored.endpoints[0], pre) == MsgType.Reply_Add
        assert mvt.stats(restored.endpoints[0]).counter(
            "SERVER_DEDUP_HITS") == 1
        client = restored.connect()
        sp, kv, mat = client.tables()
        np.testing.assert_array_equal(sp.get(keys), vals)
        assert kv.get([5, 700, 31337]) == [11, 22, 0]
        want = np.zeros((20, 3), np.float32)
        want[rows] += 1.0
        want[1] += 2.0
        np.testing.assert_array_equal(mat.get(), want)
        client.close()
    finally:
        restored.stop()


def test_cut_after_a_split_restores_the_new_layout(tmp_path, monkeypatch):
    """A cut taken after a live split names the layout's three spans, not
    the start-time spec's two: the restored fleet has three shards, each
    loading its own snapshot, and serves the state at the cut."""
    monkeypatch.delenv("MV_CUT_KILL", raising=False)
    tables = [{"kind": "matrix", "num_row": 30, "num_col": 3},
              {"kind": "array", "size": 12}]
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path / "src"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        mat, arr = client.tables()
        rows = np.arange(0, 30, 4, dtype=np.int32)
        mat.add(np.ones((len(rows), 3), np.float32), row_ids=rows)
        mvt.reshard(group).split(0)
        arr.add(np.arange(12, dtype=np.float32))
        mat.add(np.ones((len(rows), 3), np.float32), row_ids=rows)
        manifest = mvt.cut_fleet(group, cut_id="after_split")
        assert manifest["num_shards"] == 3 and len(manifest["shards"]) == 3
        assert manifest["tables"][0]["partitioner"]["bounds"] == [0, 8, 15, 30]
        client.close()
    restored = mvt.restore_fleet(manifest, device="cpu", timeout=START_S,
                                 base_dir=str(tmp_path / "restored"))
    try:
        assert len(restored.endpoints) == 3
        client = restored.connect()
        want = np.zeros((30, 3), np.float32)
        want[rows] = 2.0
        np.testing.assert_array_equal(client.table(0).get(), want)
        np.testing.assert_array_equal(client.table(1).get(),
                                      np.arange(12, dtype=np.float32))
        client.close()
    finally:
        restored.stop()


def test_clone_fleet_digests_equal_source(tmp_path):
    with ShardGroup(TABLES, shards=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "src"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        sp, kv, mat = client.tables()
        sp.add(np.array([7, 77], np.int64), np.ones((2, 2), np.float32))
        kv.add([1, 2], [10, 20])
        mat.add(np.full((2, 3), 3.0, np.float32),
                row_ids=np.array([4, 15], np.int32))
        clone = mvt.clone_fleet(group, base_dir=str(tmp_path / "clone"),
                                device="cpu", timeout=START_S)
        try:
            src = fetch_digest(group.endpoints[0], timeout=30.0)
            dup = fetch_digest(clone.endpoints[0], timeout=30.0)
            assert _digests(src["tables"]) == _digests(dup["tables"])
            cclient = clone.connect()
            csp, ckv, cmat = cclient.tables()
            np.testing.assert_array_equal(
                csp.get(np.array([7, 77], np.int64)),
                np.ones((2, 2), np.float32))
            assert ckv.get([1, 2]) == [10, 20]
            np.testing.assert_array_equal(cmat.get(), mat.get())
            cclient.close()
        finally:
            clone.stop()
        client.close()


def test_auditor_catches_corrupted_replica(tmp_path, monkeypatch):
    """One row of a replica's applied state flips (the MV_AUDIT_CORRUPT
    drill); the auditor fires AUDIT_DIVERGENCE with a manifest-carrying
    flight dump."""
    flight = str(tmp_path / "flight.jsonl")
    mvt.set_flag("flight_recorder_path", flight)
    monkeypatch.setenv("MV_AUDIT_CORRUPT", "0:7:2")
    with ShardGroup([{"kind": "sparse", "key_space": 100, "width": 2}],
                    shards=1, replicas=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        monkeypatch.delenv("MV_AUDIT_CORRUPT")
        client = group.connect()
        (sp,) = client.tables()
        sp.add(np.array([7], np.int64), np.ones((1, 2), np.float32))
        sp.add(np.array([9], np.int64), np.ones((1, 2), np.float32))
        deadline = time.monotonic() + 60.0
        primary_wm = fetch_digest(group.endpoints[0], timeout=30.0)["watermark"]
        while time.monotonic() < deadline:
            if fetch_digest(group.replica_endpoints[0][0],
                            timeout=30.0)["watermark"] >= primary_wm:
                break
            time.sleep(0.1)
        auditor = mvt.audit(group, interval=0.2,
                            manifest={"cut_id": "drill", "layout_version": 1})
        try:
            deadline = time.monotonic() + 30.0
            while (Dashboard.counter_value("AUDIT_DIVERGENCE") == 0
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            assert Dashboard.counter_value("AUDIT_DIVERGENCE") > 0
            report = auditor.last_report
            assert report is not None and not report["ok"]
            assert report["divergences"][0]["kind"] == "digest_mismatch"
        finally:
            auditor.stop()
        client.close()
    with open(flight, encoding="utf-8") as fh:
        events = [json.loads(line) for line in fh if line.strip()]
    events = [e for e in events if e.get("kind") == "event"
              and e.get("reason") == "audit_divergence"]
    assert events and events[0]["manifest"]["cut_id"] == "drill"


def test_port_restores_a_cut_taken_by_a_jax_group(tmp_path, monkeypatch):
    """A JAX shard group takes the cut; the port's ``restore_fleet`` brings
    it up in port shard processes: every restored table's digest equals
    the JAX group's at the fence, and the tables equal the mirror."""
    monkeypatch.delenv("MV_CUT_KILL", raising=False)
    tables = [{"kind": "matrix", "num_row": 20, "num_col": 3},
              {"kind": "array", "size": 10},
              {"kind": "sparse", "key_space": 100, "width": 2},
              {"kind": "kv", "value_dtype": "<i8"}]
    mv.set_flag("heartbeat_seconds", 0.0)
    rng = np.random.default_rng(12)
    model = np.zeros((20, 3), np.float32)
    amodel = np.zeros(10, np.float32)
    with JShardGroup(tables, shards=2, durable=True,
                     base_dir=str(tmp_path / "jax"),
                     flags=dict(GROUP_FLAGS)) as jgroup:
        jgroup.start(timeout=180)
        jclient = jgroup.connect()
        mat, arr, sp, kv = jclient.tables()
        for _ in range(3):
            ids = rng.integers(0, 20, 6).astype(np.int32)
            vals = rng.integers(-3, 4, (6, 3)).astype(np.float32)
            mat.add(vals, row_ids=ids)
            np.add.at(model, ids, vals)
            delta = rng.integers(-3, 4, 10).astype(np.float32)
            arr.add(delta)
            amodel += delta
        sp.add(np.array([3, 60], np.int64), np.ones((2, 2), np.float32))
        kv.add([4, 9], [1, 2])
        manifest = mv.cut_fleet(jgroup, cut_id="from_jax")
        want = {int(s["shard"]): _digests(s["digests"])
                for s in manifest["shards"]}
        jclient.close()
    restored = mvt.restore_fleet(manifest, device="cpu", timeout=START_S,
                                 base_dir=str(tmp_path / "port"))
    try:
        for shard, digests in want.items():
            live = fetch_digest(restored.endpoints[shard], timeout=30.0)
            assert _digests(live["tables"]) == digests
        client = restored.connect()
        pmat, parr, psp, pkv = client.tables()
        np.testing.assert_array_equal(pmat.get(), model)
        np.testing.assert_array_equal(parr.get(), amodel)
        np.testing.assert_array_equal(psp.get(np.array([3, 60], np.int64)),
                                      np.ones((2, 2), np.float32))
        assert pkv.get([4, 9]) == [1, 2]
        client.close()
    finally:
        restored.stop()


def _repo_env():
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.skipif(os.environ.get("MV_CUT_KILL") != "shard",
                    reason="chaos arm: needs MV_CUT_KILL=shard")
def test_kill_shard_mid_cut_previous_manifest_survives(tmp_path, monkeypatch):
    monkeypatch.delenv("MV_CUT_KILL")
    with ShardGroup([{"kind": "sparse", "key_space": 100, "width": 2}],
                    shards=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (sp,) = client.tables()
        keys = np.array([1, 50], np.int64)
        vals = np.ones((2, 2), np.float32)
        sp.add(keys, vals)
        mvt.cut_fleet(group, cut_id="clean")
        monkeypatch.setenv("MV_CUT_KILL", "shard")
        with pytest.raises(RuntimeError, match="previous manifest"):
            mvt.cut_fleet(group, cut_id="doomed", timeout=20.0)
        assert Dashboard.counter_value("CUT_FLEET_FAILURES") == 1
        assert load_cut_manifest(group)["cut_id"] == "clean"
        monkeypatch.delenv("MV_CUT_KILL")
        client.close()
    restored = mvt.restore_fleet(group.base_dir, device="cpu",
                                 base_dir=str(tmp_path / "restored"))
    try:
        (sp,) = restored.connect().tables()
        np.testing.assert_array_equal(sp.get(keys), vals)
    finally:
        restored.stop()


@pytest.mark.skipif(os.environ.get("MV_CUT_KILL") != "coordinator",
                    reason="chaos arm: needs MV_CUT_KILL=coordinator")
def test_kill_coordinator_mid_cut_previous_manifest_survives(tmp_path,
                                                             monkeypatch):
    monkeypatch.delenv("MV_CUT_KILL")
    with ShardGroup([{"kind": "sparse", "key_space": 100, "width": 2}],
                    shards=1, durable=True, device="cpu",
                    base_dir=str(tmp_path / "g"),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (sp,) = client.tables()
        keys = np.array([1, 50], np.int64)
        vals = np.ones((2, 2), np.float32)
        sp.add(keys, vals)
        mvt.cut_fleet(group, cut_id="clean")
        env = _repo_env()
        env["MV_CUT_KILL"] = "coordinator"
        proc = subprocess.run(
            [sys.executable, "-c",
             "import multiverso_tpu_torch as mvt; "
             f"mvt.cut_fleet({group.base_dir!r}, cut_id='doomed')"],
            env=env, timeout=120, capture_output=True)
        assert proc.returncode == -9, proc.stderr.decode()[-2000:]
        assert load_cut_manifest(group)["cut_id"] == "clean"
        client.close()
    restored = mvt.restore_fleet(group.base_dir, device="cpu",
                                 base_dir=str(tmp_path / "restored"))
    try:
        (sp,) = restored.connect().tables()
        np.testing.assert_array_equal(sp.get(keys), vals)
    finally:
        restored.stop()
