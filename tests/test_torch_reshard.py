"""The port's elastic membership (``multiverso_tpu_torch/shard/reshard.py``,
``durable/migrate.py``) against the JAX package's (``tests/test_reshard.py``):

* migration plans (split, merge, move, the refusals), ``translate_add``
  and ``globalize_add`` equal to the JAX package's;
* the server's stale-layout fence, held by the port's client and by the
  JAX package's (``WrongShardError`` in both), after the dedup check;
* the layout fetch's retry, the router's re-fetch and re-route on a live
  fence (a refused part re-issued once, never the applied one);
* split, merge and move of a live 2-shard CPU group under two writer
  threads: zero acknowledged Adds lost, bitwise against a numpy mirror
  (integer-valued deltas), every client on the new layout;
* the hot-range detector with the JAX test's fake recorder, and over the
  port's time-series recorder.

The chaos drills keep the reference's env gate (``MV_RESHARD_KILL``)."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.durable import migrate as jmigrate
from multiverso_tpu.runtime.message import MsgType as JMsgType
from multiverso_tpu.runtime.remote import WrongShardError as JWrongShardError
from multiverso_tpu.shard import partition as jpart
from multiverso_tpu.shard import reshard as jreshard
from multiverso_tpu.shard import router as jrouter
from multiverso_tpu.tables.base import Completion as JCompletion

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.durable.migrate import translate_add
from multiverso_tpu_torch.runtime.message import MsgType, next_msg_id
from multiverso_tpu_torch.runtime.read import ReadCache
from multiverso_tpu_torch.runtime.remote import WrongShardError
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.shard import partition
from multiverso_tpu_torch.shard.group import ShardGroup
from multiverso_tpu_torch.shard.reshard import (HotRangeDetector,
                                                MigrationCoordinator,
                                                MigrationError, plan_merge,
                                                plan_move, plan_split)
from multiverso_tpu_torch.shard.router import (fetch_layout, globalize_add,
                                               split_request)
from multiverso_tpu_torch.tables.base import Completion

GROUP_FLAGS = {"remote_workers": 4, "heartbeat_seconds": 0.2,
               "lease_seconds": 1.5, "request_retry_seconds": 1.0,
               "reconnect_deadline_seconds": 30.0}
START_S = 120


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


def _manifest(bounds=(0, 5, 10), endpoints=("h:1", "h:2"), num_col=4,
              kind="matrix", part_kind="range"):
    n = len(endpoints)
    params = ({"num_row": bounds[-1], "num_col": num_col}
              if kind == "matrix" else {"size": bounds[-1]})
    return {"version": 1, "num_shards": n, "layout_version": 1,
            "endpoints": list(endpoints), "replicas": [[] for _ in range(n)],
            "tables": [{"table_id": 0, "kind": kind, "params": params,
                        "partitioner": {"kind": part_kind,
                                        "total": bounds[-1],
                                        "num_shards": n,
                                        "bounds": list(bounds)}}]}


# -- pure planning, equal to the JAX package's ----------------------------------

PLANS = [("split", (0, 5, 10), 0, 0.4), ("split", (0, 5, 10), 1, 0.5),
         ("split", (0, 3, 7, 10), 2, 0.25), ("merge", (0, 5, 10), 0, None),
         ("merge", (0, 3, 7, 10), 1, None), ("move", (0, 5, 10), 1, None),
         ("move", (0, 10), 0, None)]


@pytest.mark.parametrize("op,bounds,shard,fraction", PLANS)
@pytest.mark.parametrize("kind", ["matrix", "array"])
def test_plans_equal_jax(op, bounds, shard, fraction, kind):
    eps = tuple(f"h:{i}" for i in range(len(bounds) - 1))
    manifest = _manifest(bounds=bounds, endpoints=eps, kind=kind)
    args = (shard,) if fraction is None else (shard, fraction)
    got = {"split": plan_split, "merge": plan_merge, "move": plan_move}[op](
        json.loads(json.dumps(manifest)), *args)
    want = {"split": jreshard.plan_split, "merge": jreshard.plan_merge,
            "move": jreshard.plan_move}[op](json.loads(json.dumps(manifest)),
                                            *args)
    got_d = {f.name: getattr(got, f.name) for f in dataclasses.fields(want)}
    assert json.dumps(got_d) == json.dumps(dataclasses.asdict(want))
    assert got.new_version == want.new_version and got.timings == {}


def test_plan_refusals_fail_loud():
    with pytest.raises(MigrationError, match="hash|range"):
        plan_split(_manifest(part_kind="hash"), 0)
    kv = _manifest()
    kv["tables"][0]["kind"] = "kv"
    with pytest.raises(MigrationError, match="kv"):
        plan_split(kv, 0)
    with pytest.raises(MigrationError, match="out of range"):
        plan_split(_manifest(), 2)
    with pytest.raises(MigrationError, match="out of range"):
        plan_merge(_manifest(), 1)
    with pytest.raises(MigrationError, match="fraction"):
        plan_split(_manifest(), 0, fraction=1.5)
    with pytest.raises(MigrationError, match="too small"):
        plan_split(_manifest(bounds=(0, 1, 10)), 0)


# -- WAL translation and the router's inverse -----------------------------------

TRANSLATIONS = [
    ("matrix", (np.int32([0, 2, 5, 9]),
                np.arange(12, dtype=np.float32).reshape(4, 3), "o"),
     dict(donor_lo=2, donor_hi=6, rcpt_start=1)),
    ("matrix", (np.int32([0, 1]), np.ones((2, 3), np.float32), "o"),
     dict(donor_lo=6, donor_hi=8, rcpt_start=0)),
    ("matrix", (None, np.arange(8, dtype=np.float32).reshape(4, 2), "o"),
     dict(donor_lo=1, donor_hi=3, rcpt_start=5, num_col=2)),
    ("matrix", (None, np.arange(8, dtype=np.float32).reshape(4, 2), "o"),
     dict(donor_lo=5, donor_hi=9, rcpt_start=0, num_col=2)),
    ("array", (np.float32([1, 2, 3, 4, 5, 6]), "o"),
     dict(donor_lo=2, donor_hi=5, rcpt_start=1, rcpt_size=6)),
    ("array", (np.zeros(6, np.float32), "o"),
     dict(donor_lo=0, donor_hi=3, rcpt_start=0, rcpt_size=3)),
    ("array", (np.float32([1, 2]), "o"),
     dict(donor_lo=4, donor_hi=6, rcpt_start=0, rcpt_size=2)),
]


@pytest.mark.parametrize("case", range(len(TRANSLATIONS)))
def test_translate_add_equal_jax(case):
    kind, request, kw = TRANSLATIONS[case]
    got = translate_add(kind, request, **kw)
    want = jmigrate.translate_add(kind, request, **kw)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_globalize_add_inverts_split_and_resplits_lossless():
    """A refused Add part re-enters the router as a global request and
    re-splits under the new layout without losing or doubling a row, as
    in the JAX package."""
    old = partition.RangePartitioner(10, 2)
    new = partition.RangePartitioner(10, 3, bounds=[0, 2, 5, 10])
    jold = jpart.RangePartitioner(10, 2)
    ids = np.int32([1, 3, 4, 8])
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    params = {"num_row": 10, "num_col": 3}
    parts, _ = split_request("matrix", old, MsgType.Request_Add,
                             (ids, vals, None), params)
    by_shard = dict(parts)
    g_ids, g_vals, _ = globalize_add("matrix", by_shard[0], old, 0)
    j_ids, j_vals, _ = jrouter.globalize_add("matrix", by_shard[0], jold, 0)
    np.testing.assert_array_equal(g_ids, j_ids)
    np.testing.assert_array_equal(g_vals, j_vals)
    np.testing.assert_array_equal(g_ids, [1, 3, 4])
    reparts, _ = split_request("matrix", new, MsgType.Request_Add,
                               (g_ids, g_vals, None), params)
    regot = {}
    for shard, (rids, rvals, _o) in reparts:
        for rid, rv in zip(new.to_global(np.asarray(rids), shard),
                           np.asarray(rvals)):
            regot[int(rid)] = rv
    assert sorted(regot) == [1, 3, 4]
    for k, rv in regot.items():
        np.testing.assert_array_equal(rv, vals[list(ids).index(k)])
    aparts, _ = split_request("array", old, MsgType.Request_Add,
                              (np.arange(10, dtype=np.float32), None),
                              {"size": 10})
    g_delta, _ = globalize_add("array", dict(aparts)[1], old, 1)
    j_delta, _ = jrouter.globalize_add("array", dict(aparts)[1], jold, 1)
    np.testing.assert_array_equal(g_delta, j_delta)
    np.testing.assert_array_equal(g_delta, [0] * 5 + [5, 6, 7, 8, 9])


def test_read_cache_invalidate_table_drops_only_that_table():
    cache = ReadCache(capacity_bytes=1 << 20, lease_seconds=60.0)
    cache.store((7, "a"), np.float32([1.0]), watermark=3)
    cache.store((7, "b"), np.float32([2.0]), watermark=3)
    cache.store((9, "a"), np.float32([3.0]), watermark=3)
    cache.invalidate_table(7)
    assert cache.lookup((7, "a"), budget=-1) is None
    assert cache.lookup((7, "b"), budget=-1) is None
    np.testing.assert_array_equal(cache.lookup((9, "a"), budget=-1), [3.0])


# -- the server's version fence ----------------------------------------------

def test_server_fences_stale_stamped_requests_only():
    """A port member past cutover refuses STALE-STAMPED requests with
    Reply_WrongShard carrying the new manifest — to the port's client and
    to the JAX package's alike; current-stamped and unstamped requests
    apply; a retransmitted, already-acknowledged Add is answered from the
    dedup window, never refused (dedup first, fence second)."""
    mvt.init(remote_workers=2)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    remote = Zoo.instance().remote_server
    mv.set_flag("heartbeat_seconds", 0.0)
    client = mvt.remote_connect(endpoint)
    proxy = client.table(table.table_id)
    proxy.add(np.ones(8, np.float32))      # unstamped: never fenced
    opt = proxy._default_option(None)
    # an Add acknowledged BEFORE the fence, kept to be retransmitted
    comp = Completion()
    client._send(table.table_id, MsgType.Request_Add,
                 (np.ones(8, np.float32), opt), next_msg_id(), comp,
                 watermark=1)
    comp.wait(10.0)
    acked = max(remote._dedup)             # its req_id in the window
    manifest = _manifest(bounds=(0, 8), endpoints=(endpoint,))
    manifest["layout_version"] = 2
    remote.layout = manifest
    remote.layout_version = 2

    comp = Completion()
    client._send(table.table_id, MsgType.Request_Add,
                 (np.ones(8, np.float32), opt), next_msg_id(), comp,
                 watermark=1)              # stale stamp
    with pytest.raises(WrongShardError) as exc:
        comp.wait(10.0)
    assert exc.value.layout_version == 2
    assert exc.value.manifest["layout_version"] == 2

    jclient = mv.remote_connect(endpoint)
    jproxy = jclient.table(table.table_id)
    jcomp = JCompletion()
    jclient._send(table.table_id, JMsgType.Request_Add,
                  (np.ones(8, np.float32), jproxy._default_option(None)),
                  next_msg_id(), jcomp, watermark=1)
    with pytest.raises(JWrongShardError) as jexc:
        jcomp.wait(10.0)
    assert jexc.value.layout_version == 2
    with Zoo.instance().admin():
        np.testing.assert_array_equal(table.get(), np.full(8, 2.0, np.float32))

    # the acknowledged Add's retransmit: same req_id, stale stamp
    from multiverso_tpu_torch.runtime import wire
    from multiverso_tpu_torch.runtime.message import Message
    hits = Dashboard.counter_value("SERVER_DEDUP_HITS")
    retry = Message(src=client.worker_id, dst=0, type=MsgType.Request_Add,
                    table_id=table.table_id, msg_id=next_msg_id(),
                    req_id=acked, watermark=1,
                    data=wire.encode((np.ones(8, np.float32), opt)))
    client._net.send(retry)
    deadline = time.monotonic() + 10
    while (Dashboard.counter_value("SERVER_DEDUP_HITS") == hits
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert Dashboard.counter_value("SERVER_DEDUP_HITS") == hits + 1
    assert Dashboard.counter_value("MIGRATION_WRONG_SHARD_REPLIES") == 2

    comp = Completion()
    client._send(table.table_id, MsgType.Request_Add,
                 (np.ones(8, np.float32), opt), next_msg_id(), comp,
                 watermark=2)              # current stamp: applies
    comp.wait(10.0)
    with Zoo.instance().admin():
        np.testing.assert_array_equal(table.get(), np.full(8, 3.0, np.float32))
    client.close()
    jclient.close()


def test_fetch_layout_retries_connection_refused_within_timeout(monkeypatch):
    import multiverso_tpu_torch.runtime.remote as remote_mod
    calls = []
    manifest = _manifest()

    def flaky(endpoint, request_type, reply_type, timeout=10.0,
              what="", payload=None):
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise ConnectionRefusedError("no listener yet")
        return manifest

    monkeypatch.setattr(remote_mod, "control_probe", flaky)
    before = Dashboard.counter_value("LAYOUT_FETCH_RETRIES")
    layout = fetch_layout("127.0.0.1:1", timeout=10.0)
    assert layout.num_shards == 2 and len(calls) == 3
    assert calls[2] - calls[0] >= 0.05
    assert Dashboard.counter_value("LAYOUT_FETCH_RETRIES") - before == 2
    calls.clear()
    with pytest.raises(ConnectionRefusedError):
        fetch_layout("127.0.0.1:1", timeout=0.01)


def _fence(endpoint, manifest):
    from multiverso_tpu_torch.runtime.remote import control_probe
    return control_probe(endpoint, MsgType.Control_Migrate_Cutover,
                         MsgType.Control_Reply_Migrate_Cutover,
                         timeout=30.0, what="test fence",
                         payload={"manifest": manifest})


def test_router_refetches_and_reroutes_on_version_mismatch(tmp_path):
    """Fence one member at a same-topology manifest with a bumped version:
    a spanning Add is part-refused, the refused part re-enters under the
    fresh layout (the applied part is not re-sent), and a spanning Get
    re-fetches then re-routes."""
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4}]
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path), flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        model = np.zeros((32, 4), np.float32)
        ids = np.arange(32, dtype=np.int32)
        vals = np.arange(128, dtype=np.float32).reshape(32, 4)
        mat.add(vals, row_ids=ids)
        model[ids] += vals
        v2 = dict(group.layout.manifest)
        v2["layout_version"] = 2
        reply = _fence(group.endpoints[0], v2)
        assert reply["layout_version"] == 2 and reply["watermark"] == 1
        refreshes = Dashboard.counter_value("ROUTER_LAYOUT_REFRESHES")
        reroutes = Dashboard.counter_value("ROUTER_REROUTES")
        mat.add(vals, row_ids=ids)
        model[ids] += vals
        assert client.layout.layout_version == 2
        assert Dashboard.counter_value("ROUTER_LAYOUT_REFRESHES") > refreshes
        assert Dashboard.counter_value("ROUTER_REROUTES") > reroutes
        np.testing.assert_array_equal(mat.get(), model)  # applied ONCE
        v3 = dict(group.layout.manifest)
        v3["layout_version"] = 3
        _fence(group.endpoints[1], v3)
        np.testing.assert_array_equal(mat.get(), model)
        assert client.layout.layout_version == 3
        assert mvt.digest(group.endpoints[1])["layout_version"] == 3
        client.close()


# -- live migration under two writers -----------------------------------------

def _drill(op, base_dir, chaos=""):
    """One split/merge/move of a 2-shard durable CPU group while two writer
    threads stream integer-valued Adds: the final tables equal the mirror
    of the acknowledged Adds bitwise."""
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4},
              {"kind": "array", "size": 16}]
    flags = dict(GROUP_FLAGS)
    if chaos:
        flags["reconnect_deadline_seconds"] = 6.0
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=base_dir, flags=flags) as group:
        group.start(timeout=START_S)
        client = group.connect()
        mat, arr = client.tables()
        model = np.zeros((32, 4), np.float32)
        amodel = np.zeros(16, np.float32)
        stop = threading.Event()
        lock = threading.Lock()
        soft_errors, hard_errors = [], []

        def writer(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                ids = rng.choice(32, 6, replace=False).astype(np.int32)
                vals = rng.integers(0, 5, (6, 4)).astype(np.float32)
                a = rng.integers(0, 5, 16).astype(np.float32)
                try:
                    mat.add(vals, row_ids=ids)
                    with lock:
                        model[ids] += vals
                    arr.add(a)
                    with lock:
                        amodel[:] += a
                except Exception as exc:  # noqa: BLE001
                    (soft_errors if chaos else hard_errors).append(exc)
                    if not chaos:
                        return
                    time.sleep(0.2)
                time.sleep(0.005)

        threads = [threading.Thread(target=writer, args=(s,), daemon=True)
                   for s in (1, 2)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        coord = MigrationCoordinator(group)
        plan = {"split": lambda: coord.split(0),
                "merge": lambda: coord.merge(0),
                "move": lambda: coord.move(1)}[op]()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not hard_errors, hard_errors
        assert not any(t.is_alive() for t in threads)
        expected_shards = {"split": 3, "merge": 1, "move": 2}[op]
        assert plan.new_manifest["num_shards"] == expected_shards
        assert set(plan.timings) == {"catchup_s", "cutover_s", "serving_s",
                                     "total_s"}
        final_mat, final_arr = mat.get(), arr.get()
        assert client.layout.layout_version == plan.new_version
        if chaos:
            assert (final_mat >= model).all(), "acknowledged Adds lost"
            assert (final_arr >= amodel).all(), "acknowledged Adds lost"
        else:
            np.testing.assert_array_equal(final_mat, model)
            np.testing.assert_array_equal(final_arr, amodel)
        client.close()
        c2 = group.connect()
        assert c2.layout.layout_version == plan.new_version
        assert c2.layout.num_shards == expected_shards
        if not chaos:
            np.testing.assert_array_equal(c2.tables()[0].get(), model)
        c2.close()
        for j in plan.joiners:
            with open(os.path.join(
                    base_dir, f"join-v{plan.new_version}.{j['shard']}.status")) as f:
                status = json.load(f)
            assert status["phase"] == "serving"
            assert status["transfer_bytes"] > 0
    launches = group.kernel_launches()
    assert sum(1 for r in launches if r.startswith("join-")) == len(plan.joiners)
    return len(soft_errors)


@pytest.mark.parametrize("op", ["split", "merge", "move"])
def test_live_migration_zero_acked_add_loss(op, monkeypatch, tmp_path):
    monkeypatch.delenv("MV_RESHARD_KILL", raising=False)
    _drill(op, str(tmp_path))
    assert Dashboard.counter_value("MIGRATIONS_COMPLETED") == 1
    assert Dashboard.counter_value("MIGRATIONS_ABORTED") == 0


@pytest.mark.skipif(os.environ.get("MV_RESHARD_KILL")
                    not in ("donor", "recipient"),
                    reason="chaos drill: set MV_RESHARD_KILL="
                           "donor|recipient (ci chaos matrix)")
def test_live_migration_survives_participant_kill(tmp_path):
    _drill("split", str(tmp_path), chaos=os.environ["MV_RESHARD_KILL"])
    assert Dashboard.counter_value("MIGRATIONS_COMPLETED") == 1


@pytest.mark.skipif(os.environ.get("MV_RESHARD_KILL") != "recipient_early",
                    reason="chaos drill: set MV_RESHARD_KILL="
                           "recipient_early (ci chaos matrix)")
def test_migration_aborts_cleanly_when_joiner_dies_in_catchup(tmp_path):
    tables = [{"kind": "matrix", "num_row": 32, "num_col": 4}]
    with ShardGroup(tables, shards=2, durable=True, device="cpu",
                    base_dir=str(tmp_path), flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        (mat,) = client.tables()
        ids = np.arange(4, dtype=np.int32)
        mat.add(np.ones((4, 4), np.float32), row_ids=ids)
        with pytest.raises(MigrationError, match="catch-up"):
            MigrationCoordinator(group).split(0)
        assert group.layout.layout_version == 1
        assert Dashboard.counter_value("MIGRATIONS_ABORTED") == 1
        mat.add(np.ones((4, 4), np.float32), row_ids=ids)
        np.testing.assert_array_equal(mat.get(ids),
                                      np.full((4, 4), 2.0, np.float32))
        client.close()


def test_migration_refuses_non_durable_and_standby_groups():
    group = ShardGroup([{"kind": "array", "size": 8}], shards=2,
                       durable=False, device="cpu", flags=dict(GROUP_FLAGS))
    coord = MigrationCoordinator(group)
    with pytest.raises(MigrationError, match="start"):
        coord.split(0)
    group.layout = type("L", (), {"manifest": _manifest()})()
    with pytest.raises(MigrationError, match="durable"):
        coord.split(0)
    group.durable = True
    group.standby = True
    with pytest.raises(MigrationError, match="standby"):
        coord.split(0)


# -- hot-range detector ---------------------------------------------------------

class _FakeHist:
    def __init__(self, count):
        self.count = count


class _FakeRecorder:
    def __init__(self, counts):
        self._counts = counts

    def window_histogram(self, name, window):
        shard = int(name.replace("ROUTER_SHARD", "").split("_")[0])
        n = self._counts.get(shard, 0)
        return _FakeHist(n) if n else None


@pytest.mark.parametrize("counts,n,ratio,qps", [
    ({0: 300, 1: 3000, 2: 330}, 3, 3.0, 50.0),
    ({0: 10, 1: 90, 2: 9}, 3, 3.0, 50.0),
    ({0: 3000, 1: 4000, 2: 3300}, 3, 3.0, 50.0),
    ({0: 9000}, 1, 3.0, 50.0),
    ({0: 10, 1: 12, 2: 3000}, 3, 3.0, 50.0),
])
def test_hot_range_detector_proposes_as_jax(counts, n, ratio, qps):
    det = HotRangeDetector(n, recorder=_FakeRecorder(counts),
                           window_seconds=30.0, hot_ratio=ratio, min_qps=qps)
    jdet = jreshard.HotRangeDetector(n, recorder=_FakeRecorder(counts),
                                     window_seconds=30.0, hot_ratio=ratio,
                                     min_qps=qps)
    assert det.shard_rates() == jdet.shard_rates()
    assert det.propose() == jdet.propose()
    assert det.propose_merge() == jdet.propose_merge()
    if counts == {0: 300, 1: 3000, 2: 330}:
        assert det.propose() == {"op": "split", "shard": 1, "rate": 100.0,
                                 "median": 11.0}


def test_hot_range_autosplit_stays_behind_flag():
    det = HotRangeDetector(2, recorder=_FakeRecorder({0: 9000, 1: 30}),
                           hot_ratio=3.0, min_qps=1.0)

    class _Boom:
        def split(self, shard):
            raise AssertionError("executed a split with auto_reshard off")

    assert not mvt.get_flag("auto_reshard")
    assert det.maybe_autosplit(_Boom()) is None
    assert det.tick(_Boom())["executed"] is False
    executed = []
    mvt.set_flag("auto_reshard", True)

    class _Record:
        def split(self, shard):
            executed.append(shard)
            return "plan"

    assert det.maybe_autosplit(_Record()) == "plan"
    assert det.tick(_Record())["executed"] is True
    assert executed == [0, 0]
    assert Dashboard.counter_value("RESHARD_EXECUTED") == 1


def test_hot_range_detector_reads_the_time_series_recorder():
    """With no recorder the detector reads the port's TIMESERIES: two
    samples around a burst of shard-1 round trips make shard 1 hot."""
    from multiverso_tpu_torch.obs.timeseries import TIMESERIES
    from multiverso_tpu_torch.dashboard import observe
    TIMESERIES.reset()
    try:
        TIMESERIES.sample_now(t=1000.0)
        for _ in range(600):
            observe("ROUTER_SHARD1_SECONDS", 0.001)
        for _ in range(10):
            observe("ROUTER_SHARD0_SECONDS", 0.001)
        TIMESERIES.sample_now(t=1010.0)
        det = HotRangeDetector(2, window_seconds=10.0, hot_ratio=3.0,
                               min_qps=10.0)
        assert det.shard_rates() == [1.0, 60.0]
        assert det.propose()["shard"] == 1
        assert TIMESERIES.rate("ROUTER_FANOUT", 10.0) == 0.0
        assert TIMESERIES.quantile("ROUTER_SHARD1_SECONDS", 0.5, 10.0) > 0
    finally:
        TIMESERIES.reset()
