"""The port's sharded serving tier (``multiverso_tpu_torch/shard/``) against
the JAX package's (``tests/test_shard.py``):

* the partitioners, ``stable_hash64`` (10,000 seeded keys) and the layout
  manifest, equal to the JAX package's (the manifest byte for byte);
* ``split_request`` and its merge for every table kind and request form,
  part for part, and the error-feedback and quantized splits (the
  quantized payloads' wire bytes and the residuals exact);
* the split/merge contract on the port's own server tables: a workload
  split over shard-local tables equals one global table, bitwise;
* a 2-shard CPU group serving all five kinds through the router, against a
  numpy model (exact); the per-shard failover twin against a mirror of the
  acknowledged Adds; the layout RPC refused by a non-member in both
  packages' words; a JAX ``ShardedClient`` routing through a port group;
  a group asked for a card where there is none.

Every group sets its own start deadline and is stopped in a ``finally``
(``with``); shard processes run on the CPU (``device="cpu"``)."""

import json
import os
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.runtime import wire as jwire
from multiverso_tpu.runtime.message import MsgType as JMsgType
from multiverso_tpu.shard import partition as jpart
from multiverso_tpu.shard import router as jrouter

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import log
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.message import MsgType
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.shard import partition, router
from multiverso_tpu_torch.shard.group import ShardGroup
from multiverso_tpu_torch.updaters import AddOption, GetOption

GROUP_FLAGS = {"remote_workers": 4, "heartbeat_seconds": 0.2,
               "lease_seconds": 1.5, "request_retry_seconds": 1.0,
               "reconnect_deadline_seconds": 30.0}
START_S = 120


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread (tests/test_torch_sync.py's fixture says why);
    whatever a test starts is stopped (tests/conftest.py resets the JAX
    side)."""
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


def _same(a, b, where="") -> None:
    """Structural equality: arrays by dtype and value, containers item by
    item, anything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, where


# -- partitioners, hashing, the manifest ---------------------------------------

TABLE_SPECS = [{"kind": "array", "size": 23, "dtype": np.float32},
               {"kind": "matrix", "num_row": 37, "num_col": 5,
                "dtype": "float32", "updater_type": "adagrad"},
               {"kind": "kv", "value_dtype": np.int64, "capacity": 1000},
               {"kind": "sparse", "key_space": 997, "width": 3},
               {"kind": "matrix", "num_row": 12, "num_col": 2,
                "is_sparse": True}]


@pytest.mark.parametrize("flag", ["auto", "range"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_plan_and_shard_kwargs_equal_jax(flag, shards):
    """The layout entries are the JAX package's byte for byte (clients of
    either package bootstrap from members of either package), and so are
    every shard's local constructor arguments."""
    specs = [s for s in TABLE_SPECS if flag == "auto" or s["kind"] != "kv"]
    got = partition.plan_tables(specs, shards, flag)
    want = jpart.plan_tables(specs, shards, flag)
    assert json.dumps(got) == json.dumps(want)
    for entry in got:
        for shard in range(shards):
            assert (partition.shard_table_kwargs(entry, shard)
                    == jpart.shard_table_kwargs(entry, shard))


def test_range_partitioner_equal_jax():
    for total, n in ((10, 3), (1_000_000, 2), (7, 7), (5, 1)):
        p, q = partition.RangePartitioner(total, n), jpart.RangePartitioner(total, n)
        assert p.bounds == q.bounds and p.to_spec() == q.to_spec()
        ids = np.arange(total)
        np.testing.assert_array_equal(p.shard_of(ids), q.shard_of(ids))
        for s in range(n):
            assert p.span(s) == q.span(s)
            assert p.local_size(s) == q.local_size(s)
    custom = partition.partitioner_from_spec(
        {"kind": "range", "total": 10, "num_shards": 3, "bounds": [0, 2, 5, 10]})
    assert custom.span(1) == (2, 5)


def test_stable_hash64_equal_jax_on_seeded_keys():
    rng = np.random.default_rng(2024)
    keys = np.concatenate([rng.integers(-(1 << 62), 1 << 62, 9_990),
                           [0, 1, 2, -1, (1 << 63) - 1, -(1 << 63), 5, 77,
                            123456, 1 << 40]]).astype(np.int64)
    assert keys.size == 10_000
    got = partition.stable_hash64(keys)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jpart.stable_hash64(keys))
    for n in (2, 3, 4, 7):
        np.testing.assert_array_equal(partition.HashPartitioner(n).shard_of(keys),
                                      jpart.HashPartitioner(n).shard_of(keys))


def test_flag_validation_fails_fast_like_jax():
    for fn, arg in ((partition.validate_partitioner_flag, "bogus"),
                    (partition.parse_shard_endpoints, "localhost,127.0.0.1:x"),
                    (partition.parse_shard_endpoints, "")):
        with pytest.raises(log.FatalError):
            fn(arg)
    with pytest.raises(log.FatalError, match="span-positional"):
        partition.plan_tables([{"kind": "matrix", "num_row": 8, "num_col": 2}],
                              2, "hash")
    with pytest.raises(log.FatalError, match="unbounded"):
        partition.plan_tables([{"kind": "kv"}], 2, "range")
    with pytest.raises(log.FatalError, match="range|hash"):
        partition.make_partitioner("zipf", 2, total=10)
    text = "10.0.0.1:5550, 10.0.0.2:5550"
    assert (partition.parse_shard_endpoints(text)
            == jpart.parse_shard_endpoints(text))
    assert partition.validate_partitioner_flag(" Range ") == "range"
    for name in ("shards", "shard_partitioner", "shard_endpoints", "replicas",
                 "auto_reshard", "reshard_hot_ratio", "reshard_min_qps",
                 "reshard_cold_qps", "timeseries_interval_seconds",
                 "timeseries_samples"):
        assert mvt.get_flag(name) == mv.get_flag(name), name


# -- split_request and its merges, part for part --------------------------------

def _fake_reply(kind, msg_type, shard, sub):
    """A deterministic per-shard reply shaped like the server's."""
    if msg_type == MsgType.Request_Add:
        return None
    if msg_type == MsgType.Request_Query:
        ids = np.array([[shard * 2, shard * 2 + 1], [shard, 0]], np.int64)
        return ids, np.array([[9.0 - shard, 5.0], [3.0, 3.0]], np.float32)
    if kind == "array":
        return np.arange(4, dtype=np.float32) + 10 * shard
    if kind == "kv":
        keys, _opt = sub
        if keys is None:
            return {100 + shard: shard, 7 * shard: 1}
        return [int(k) * 3 + shard for k in keys]
    ids = sub[0]
    if ids is None:
        if kind == "sparse":
            return (np.array([5 + shard, 1 + shard], np.int64),
                    np.full((2, 3), shard, np.float32))
        return np.full((3, 2), shard, np.float32)
    return (np.asarray(ids, np.float32).reshape(-1, 1) * 2 + shard).repeat(2, 1)


def _requests():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 40, 12).astype(np.int32)
    vals = rng.standard_normal((12, 3)).astype(np.float32)
    keys = rng.integers(0, 997, 9).astype(np.int64)
    return [
        ("matrix", "range", MsgType.Request_Get, (ids, "opt")),
        ("matrix", "range", MsgType.Request_Get, (None, "opt")),
        ("matrix", "range", MsgType.Request_Get, (ids[:0], "opt")),
        ("matrix", "range", MsgType.Request_Add, (ids, vals, "opt")),
        ("matrix", "range", MsgType.Request_Add,
         (None, np.ones((40, 3), np.float32), "opt")),
        ("matrix", "range", MsgType.Request_Query,
         (np.ones((2, 3), np.float32), 2, "dot")),
        ("array", "range", MsgType.Request_Get, "opt"),
        ("array", "range", MsgType.Request_Add,
         (np.arange(40, dtype=np.float32), "opt")),
        ("kv", "hash", MsgType.Request_Get, ([int(k) for k in keys], None)),
        ("kv", "hash", MsgType.Request_Get, (None, None)),
        ("kv", "hash", MsgType.Request_Add,
         ([int(k) for k in keys], list(range(9)), None)),
        ("sparse", "hash", MsgType.Request_Get, (keys, None)),
        ("sparse", "range", MsgType.Request_Get, (keys, None)),
        ("sparse", "hash", MsgType.Request_Get, (None, None)),
        ("sparse", "range", MsgType.Request_Add,
         (keys, np.ones((9, 3), np.float32), None)),
    ]


@pytest.mark.parametrize("case", range(15))
def test_split_request_parts_and_merge_equal_jax(case):
    kind, part_kind, msg_type, request = _requests()[case]
    total = 40 if kind in ("matrix", "array") else 997
    params = {"num_row": 40, "num_col": 3, "size": 40, "key_space": 997,
              "width": 3, "dtype": "<f4"}
    part = partition.make_partitioner(part_kind, 3, total=total)
    jp = jpart.make_partitioner(part_kind, 3, total=total)
    parts, merge = router.split_request(kind, part, msg_type, request, params)
    jparts, jmerge = jrouter.split_request(kind, jp, JMsgType(int(msg_type)),
                                           request, params)
    _same(parts, jparts, "parts")
    replies = [_fake_reply(kind, msg_type, s, sub) for s, sub in parts]
    if parts:
        _same(merge(replies), jmerge(replies), "merged")
    else:
        _same(router._empty_reply(kind, msg_type, request, params),
              jrouter._empty_reply(kind, JMsgType(int(msg_type)), request,
                                   params), "empty")


def test_error_feedback_and_quantized_split_equal_jax():
    """Per-shard residual slices tile the layout; each quantized part
    encodes to the JAX package's wire bytes, and the residuals stay equal
    over six pushes with duplicate ids (the 1-bit-SGD identity holds)."""
    part = partition.RangePartitioner(12, 2)
    jp = jpart.RangePartitioner(12, 2)
    params = {"num_col": 3, "dtype": "<f4"}
    efs = router.make_shard_error_feedback("matrix", params, part, bits=2)
    jefs = jrouter.make_shard_error_feedback("matrix", params, jp, bits=2)
    assert [e.residual.shape for e in efs] == [e.residual.shape for e in jefs]
    assert router.make_shard_error_feedback(
        "matrix", {"num_col": 3, "dtype": "<i4"}, part, bits=4) is None
    assert router.make_shard_error_feedback("kv", {}, part, bits=4) is None
    arr_efs = router.make_shard_error_feedback(
        "array", {"dtype": "<f4"}, partition.RangePartitioner(7, 2), bits=8)
    assert [e.residual.shape for e in arr_efs] == [(4,), (3,)]
    rng = np.random.default_rng(5)
    true_sum = np.zeros((12, 3), np.float32)
    decoded_sum = np.zeros((12, 3), np.float32)
    for _ in range(6):
        ids = rng.choice(12, 8, replace=True).astype(np.int32)
        vals = rng.standard_normal((8, 3)).astype(np.float32)
        np.add.at(true_sum, ids, vals)
        request = router.dedup_add_ids("matrix", (ids, vals, None))
        _same(request, jrouter.dedup_add_ids("matrix", (ids, vals, None)))
        parts, _ = router.split_request("matrix", part, MsgType.Request_Add,
                                        request, params)
        jparts, _ = jrouter.split_request("matrix", jp, JMsgType.Request_Add,
                                          request, params)
        got = router.quantize_split_parts("matrix", efs, parts)
        want = jrouter.quantize_split_parts("matrix", jefs, jparts)
        for (s, (lid, quant, _o)), (js, (jlid, jquant, _jo)) in zip(got, want):
            assert s == js
            np.testing.assert_array_equal(lid, jlid)
            assert bytes(b"".join(bytes(x) for x in wire.encode(quant))) == \
                bytes(b"".join(bytes(x) for x in jwire.encode(jquant)))
            decoded = wire.decode(wire.encode(quant))
            lo, hi = part.span(s)
            np.add.at(decoded_sum[lo:hi], np.asarray(lid), decoded)
    for e, je in zip(efs, jefs):
        np.testing.assert_array_equal(e.residual, je.residual)
    residual = np.concatenate([ef.residual for ef in efs])
    np.testing.assert_allclose(decoded_sum + residual, true_sum, rtol=0,
                               atol=1e-4)


def test_globalize_add_equal_jax():
    old = partition.RangePartitioner(10, 2)
    jold = jpart.RangePartitioner(10, 2)
    ids = np.int32([1, 3, 4, 8])
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    params = {"num_row": 10, "num_col": 3, "size": 10}
    for kind, request in (("matrix", (ids, vals, None)),
                          ("matrix", (None, np.ones((10, 3), np.float32), None)),
                          ("array", (np.arange(10, dtype=np.float32), None))):
        parts, _ = router.split_request(kind, old, MsgType.Request_Add,
                                        request, params)
        for shard, sub in parts:
            _same(router.globalize_add(kind, sub, old, shard),
                  jrouter.globalize_add(kind, sub, jold, shard))


# -- split/merge on the port's server tables ----------------------------------

def test_split_over_port_server_tables_equals_one_table():
    """A workload split over shard-local port tables and merged equals the
    same workload on ONE port table, bit for bit (matrix with duplicate
    ids and whole-table forms, sparse-staleness matrix, array)."""
    from multiverso_tpu_torch.tables.array_table import ArrayServer
    from multiverso_tpu_torch.tables.matrix_table import MatrixServer
    mvt.init()
    rows, cols = 37, 5
    part = partition.RangePartitioner(rows, 3)
    params = {"num_row": rows, "num_col": cols, "dtype": "<f4"}

    def run(kind, servers, msg_type, request):
        parts, merge = router.split_request(kind, part, msg_type, request,
                                            params)
        out = [servers[s].process_get(sub) if msg_type == MsgType.Request_Get
               else servers[s].process_add(sub) for s, sub in parts]
        return merge(out) if parts else router._empty_reply(
            kind, msg_type, request, params)

    whole = MatrixServer(rows, cols, np.float32)
    shards = [MatrixServer(part.local_size(s), cols, np.float32)
              for s in range(3)]
    rng = np.random.default_rng(7)
    opt = AddOption(worker_id=0)
    for _ in range(6):
        ids = rng.integers(0, rows, 9).astype(np.int32)  # duplicates too
        vals = rng.integers(-3, 4, (9, cols)).astype(np.float32)
        whole.process_add((ids, vals, opt))
        run("matrix", shards, MsgType.Request_Add, (ids, vals, opt))
        probe = rng.integers(0, rows, 7).astype(np.int32)
        np.testing.assert_array_equal(
            run("matrix", shards, MsgType.Request_Get, (probe, GetOption(0))),
            whole.process_get((probe, GetOption(0))))
    dense = np.ones((rows, cols), np.float32)
    whole.process_add((None, dense, opt))
    run("matrix", shards, MsgType.Request_Add, (None, dense, opt))
    np.testing.assert_array_equal(
        run("matrix", shards, MsgType.Request_Get, (None, GetOption(0))),
        whole.process_get((None, GetOption(0))))

    sparse_whole = MatrixServer(rows, cols, np.float32, is_sparse=True,
                                num_workers=2)
    sparse_shards = [MatrixServer(part.local_size(s), cols, np.float32,
                                  is_sparse=True, num_workers=2)
                     for s in range(3)]
    touched = np.array([5, 20, 33], np.int32)
    for step in range(3):
        if step == 1:
            sparse_whole.process_add((touched, np.ones((3, cols), np.float32),
                                      opt))
            run("matrix", sparse_shards, MsgType.Request_Add,
                (touched, np.ones((3, cols), np.float32), opt))
        got = run("matrix", sparse_shards, MsgType.Request_Get,
                  (None, GetOption(worker_id=0)))
        want = sparse_whole.process_get((None, GetOption(worker_id=0)))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    apart = partition.RangePartitioner(23, 4)
    awhole = ArrayServer(23, np.float32)
    ashards = [ArrayServer(apart.local_size(s), np.float32) for s in range(4)]
    for _ in range(3):
        delta = rng.integers(-3, 4, 23).astype(np.float32)
        awhole.process_add((delta, opt))
        aparts, _ = router.split_request("array", apart, MsgType.Request_Add,
                                         (delta, opt), {"size": 23})
        for s, sub in aparts:
            ashards[s].process_add(sub)
    gparts, gmerge = router.split_request("array", apart, MsgType.Request_Get,
                                          GetOption(0), {"size": 23})
    np.testing.assert_array_equal(
        gmerge([ashards[s].process_get(sub) for s, sub in gparts]),
        awhole.process_get(GetOption(0)))


# -- live groups ----------------------------------------------------------------

def test_group_round_trip_all_kinds_against_numpy(tmp_path):
    """A 2-shard CPU group serves every table kind through the router;
    results equal a numpy model exactly; a second client bootstraps from
    one member; a routed top-k query equals the numpy oracle; both
    shards' router histograms are fed."""
    tables = [{"kind": "array", "size": 16},
              {"kind": "matrix", "num_row": 32, "num_col": 4},
              {"kind": "kv", "value_dtype": "<i8"},
              {"kind": "sparse", "key_space": 1000, "width": 2},
              {"kind": "matrix", "num_row": 12, "num_col": 2,
               "is_sparse": True}]
    with ShardGroup(tables, shards=2, device="cpu", base_dir=str(tmp_path),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        arr, mat, kv, sp, smat = client.tables()
        arr.add(np.arange(16, dtype=np.float32))
        np.testing.assert_array_equal(arr.get(), np.arange(16, dtype=np.float32))

        model = np.zeros((32, 4), np.float32)
        rng = np.random.default_rng(0)
        for _ in range(4):
            ids = rng.integers(0, 32, 6).astype(np.int32)
            vals = rng.integers(-3, 4, (6, 4)).astype(np.float32)
            mat.add(vals, row_ids=ids)
            np.add.at(model, ids, vals)
        np.testing.assert_array_equal(mat.get(), model)
        probe = np.array([0, 31, 16, 15], np.int32)
        np.testing.assert_array_equal(mat.get(probe), model[probe])

        kv.add([5, 77, 123456], [2, 3, 4])
        kv.add(5, 1)
        assert kv.get([5, 77, 123456]) == [3, 3, 4]
        assert kv.get() == {5: 3, 77: 3, 123456: 4}

        sp.add([10, 999, 500], np.ones((3, 2), np.float32))
        np.testing.assert_array_equal(
            sp.get([10, 999, 500, 2]),
            np.array([[1, 1], [1, 1], [1, 1], [0, 0]], np.float32))
        live, _vals = sp.get()
        np.testing.assert_array_equal(live, [10, 500, 999])

        assert smat.is_sparse
        np.testing.assert_array_equal(smat.get(), np.zeros((12, 2)))
        smat.add(np.ones((2, 2), np.float32), row_ids=np.array([2, 9], np.int32))
        second = smat.get()
        np.testing.assert_array_equal(second[[2, 9]], np.ones((2, 2)))
        np.testing.assert_array_equal(second[0], np.zeros(2))

        vecs = rng.integers(-2, 3, (3, 4)).astype(np.float32)
        ids, scores = mat.query(vecs, 5)
        oracle = vecs @ model.T
        for r in range(3):
            order = np.lexsort((np.arange(32), -oracle[r]))[:5]
            np.testing.assert_array_equal(ids[r], order)
            np.testing.assert_array_equal(scores[r], oracle[r, order])

        assert Dashboard.counter_value("ROUTER_FANOUT") > 0
        assert Dashboard.histogram("ROUTER_SHARD0_SECONDS").count > 0
        assert Dashboard.histogram("ROUTER_SHARD1_SECONDS").count > 0
        client2 = mvt.shard_connect(group.endpoints[1])
        np.testing.assert_array_equal(client2.table(1).get(probe), model[probe])
        for ep in group.endpoints:
            assert mvt.stats(ep).histogram("SERVER_PROCESS_ADD_MSG").count > 0
        client.close()
        client2.close()
    launches = group.kernel_launches()
    assert set(launches) == {"shard0", "shard1"}
    assert all(c["device"] == "cpu" and c["scatter_add_rows"] == 0
               for c in launches.values())  # the CPU path launches nothing


def test_group_failover_twin_zero_loss_other_shard_unaffected(tmp_path):
    """The per-shard failover drill (the reference's
    ``test_shard_group_failover_zero_loss_other_shards_unaffected``), held
    to a numpy mirror of the acknowledged Adds: SIGKILL shard 0's primary,
    shard 1 keeps serving at request time, the standby takes over shard
    0's endpoint, and the final table equals the mirror bitwise."""
    tables = [{"kind": "matrix", "num_row": 16, "num_col": 2}]
    with ShardGroup(tables, shards=2, standby=True, device="cpu",
                    base_dir=str(tmp_path), flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        client = group.connect()
        mat = client.table(0)
        model = np.zeros((16, 2), np.float32)
        for i in range(10):  # shard 0 owns rows 0-7, shard 1 rows 8-15
            ids = np.array([i % 8, 8 + i % 8], np.int32)
            mat.add(np.ones((2, 2), np.float32), row_ids=ids)
            model[ids] += 1.0
        t_kill = time.time()
        group.kill_shard(0)
        latencies = []
        for i in range(6):
            ids = np.array([8 + i % 8], np.int32)
            t0 = time.monotonic()
            mat.add(np.ones((1, 2), np.float32), row_ids=ids)
            latencies.append(time.monotonic() - t0)
            model[ids] += 1.0
        assert group.wait_failover(0, timeout=90) == group.endpoints[0]
        # shard 1 never waited on shard 0: every one of its Adds took less
        # than the failover itself (a router blocked on the dead shard
        # waits until the standby serves); load stretches both alike
        took = os.path.getmtime(os.path.join(group.base_dir,
                                             "standby0.tookover")) - t_kill
        assert max(latencies) < took, (latencies, took)
        for i in range(4):
            ids = np.array([i, 8 + i], np.int32)
            mat.add(np.ones((2, 2), np.float32), row_ids=ids)
            model[ids] += 1.0
        np.testing.assert_array_equal(mat.get(), model)
        assert mvt.stats(group.endpoints[0]).counter("FAILOVERS") == 1
        shard1 = mvt.stats(group.endpoints[1])
        assert shard1.counter("FAILOVERS") == 0
        assert shard1.histogram("SERVER_PROCESS_ADD_MSG").count > 0
        client.close()


def test_layout_rpc_refused_by_non_member():
    """Asking a plain port server for a shard layout is a clean refusal
    in the JAX package's words, through either package's probe."""
    mvt.init(remote_workers=1)
    mvt.create_table("array", 4, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    with pytest.raises(RuntimeError, match="not a shard-group member"):
        router.fetch_layout(endpoint, timeout=10.0)
    with pytest.raises(RuntimeError, match="not a shard-group member"):
        jrouter.fetch_layout(endpoint, timeout=10.0)


def test_jax_sharded_client_routes_through_port_group(tmp_path):
    """A JAX ``ShardedClient`` bootstraps from a port member's layout and
    routes matrix and array Adds; the port group's tables equal the
    mirror, read back through both packages' routers."""
    tables = [{"kind": "matrix", "num_row": 20, "num_col": 3},
              {"kind": "array", "size": 10}]
    mv.set_flag("heartbeat_seconds", 0.0)
    with ShardGroup(tables, shards=2, device="cpu", base_dir=str(tmp_path),
                    flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        layout = jrouter.fetch_layout(group.endpoints[0], timeout=10.0)
        assert json.dumps(layout.manifest) == json.dumps(group.layout.manifest)
        jclient = jrouter.ShardedClient(layout, timeout=30.0)
        jmat, jarr = jclient.table(0), jclient.table(1)
        model = np.zeros((20, 3), np.float32)
        amodel = np.zeros(10, np.float32)
        rng = np.random.default_rng(3)
        for _ in range(5):
            ids = rng.integers(0, 20, 7).astype(np.int32)
            vals = rng.integers(-3, 4, (7, 3)).astype(np.float32)
            jmat.add(vals, row_ids=ids)
            np.add.at(model, ids, vals)
            delta = rng.integers(-3, 4, 10).astype(np.float32)
            jarr.add(delta)
            amodel += delta
        np.testing.assert_array_equal(jmat.get(), model)
        np.testing.assert_array_equal(jarr.get(), amodel)
        jclient.close()
        client = group.connect()
        np.testing.assert_array_equal(client.table(0).get(), model)
        np.testing.assert_array_equal(client.table(1).get(), amodel)
        client.close()


def test_group_on_a_card_that_is_absent_raises(tmp_path):
    """The group's device is the caller's: asked for ``cuda`` where there
    is none, a shard child dies at init and the start fails; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    group = ShardGroup([{"kind": "array", "size": 4}], shards=1,
                       device="cuda", base_dir=str(tmp_path),
                       flags=dict(GROUP_FLAGS))
    try:
        with pytest.raises(log.FatalError, match="died during startup"):
            group.start(timeout=START_S)
        assert group._all_procs() == []  # the failed start stopped them
    finally:
        group.stop()
    with open(tmp_path / "group.json") as f:
        assert json.load(f)["device"] == "cuda"
    with open(tmp_path / "shard0.log") as f:
        assert "CUDA" in f.read()


def test_group_start_ignores_an_earlier_groups_announcements(tmp_path):
    """A base_dir reused after another group: its endpoint and launch
    files are not read as this group's (the JAX group would take the old
    endpoint)."""
    (tmp_path / "shard0.endpoint").write_text("127.0.0.1:1")
    (tmp_path / "shard0.launches.json").write_text("{}")
    with ShardGroup([{"kind": "array", "size": 4}], shards=1, device="cpu",
                    base_dir=str(tmp_path), flags=dict(GROUP_FLAGS)) as group:
        group.start(timeout=START_S)
        assert group.endpoints[0] != "127.0.0.1:1"
        assert not (tmp_path / "shard0.launches.json").exists()
        client = group.connect()
        client.table(0).add(np.ones(4, np.float32))
        np.testing.assert_array_equal(client.table(0).get(), np.ones(4))
        client.close()
    assert group.kernel_launches()["shard0"]["device"] == "cpu"
