"""The port's write-ahead log (``multiverso_tpu_torch/durable/wal.py``):
the in-process cases of ``tests/test_durable.py`` on the port — record
codec and torn tails, the manifest, append then recover, snapshot
compaction, truncation, the atomic store, corrupt-frame chaos — and the
interchange with the JAX package: the same appends write byte-identical
WAL directories in both packages, and a log written by either package's
serving process recovers in the other to the same table bytes."""

import os

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu import checkpoint as jcheckpoint
from multiverso_tpu import io as jio
from multiverso_tpu.durable import wal as jwal
from multiverso_tpu.runtime import wire as jwire
from multiverso_tpu.runtime.zoo import Zoo as JZoo
from multiverso_tpu.updaters import AddOption as JAddOption

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import checkpoint
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.durable import wal as dwal
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.updaters import AddOption

SEED = int(os.environ.get("CHAOS_SEED", "7"))


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, clients
    without heartbeats, one intra-op thread (tests/test_torch_sync.py's
    fixture says why); whatever a test starts is stopped
    (tests/conftest.py resets the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TORCH_FLAGS.set("heartbeat_seconds", 0.0)
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _tree_bytes(root):
    """{relative path: file bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fp:
                out[os.path.relpath(path, root)] = fp.read()
    return out


# -- units: record codec, torn tails, manifest --------------------------------

def test_wal_record_codec_roundtrip_and_torn_tail():
    blobs = [np.arange(6, dtype=np.float32).reshape(2, 3),
             np.array([7, 8, 9], dtype=np.int64)]
    rec1 = dwal._encode_record(11, 1, 101, blobs)
    rec2 = dwal._encode_record(12, 2, 102, [np.float32([1.5])])
    # the record bytes are the JAX package's
    assert rec1 == jwal._encode_record(11, 1, 101, blobs)
    assert rec2 == jwal._encode_record(12, 2, 102, [np.float32([1.5])])
    head = dwal._SEG_HDR.pack(dwal._SEG_MAGIC, dwal._SEG_VERSION, 5, 0)
    assert head == jwal._SEG_HDR.pack(jwal._SEG_MAGIC, jwal._SEG_VERSION,
                                      5, 0)

    records, valid, clean = dwal._read_segment(head + rec1 + rec2, "seg")
    assert clean and len(records) == 2
    assert records[0].req_id == 11 and records[0].worker == 1
    assert records[0].msg_id == 101 and records[0].table_id == 5
    np.testing.assert_array_equal(records[0].blobs[0], blobs[0])
    np.testing.assert_array_equal(records[0].blobs[1], blobs[1])

    # torn tail: rec2 cut mid-body -> rec1 survives, tear reported
    records, valid, clean = dwal._read_segment(
        head + rec1 + rec2[:len(rec2) - 3], "seg")
    assert not clean and len(records) == 1
    assert valid == len(head) + len(rec1)

    # bit-flip in rec1's body: CRC stops replay at the first bad record
    corrupt = bytearray(head + rec1 + rec2)
    corrupt[len(head) + dwal._REC_HDR.size + 4] ^= 0x40
    records, valid, clean = dwal._read_segment(bytes(corrupt), "seg")
    assert not clean and len(records) == 0 and valid == len(head)

    # unreadable segment header
    records, _, _ = dwal._read_segment(b"JUNKJUNKJUNKJUNK", "seg")
    assert records is None


def test_manifest_roundtrip(tmp_path):
    root = str(tmp_path)
    assert dwal.read_manifest(root) == {"generation": -1, "first_segment": 0}
    dwal._write_manifest(root, 3, 7)
    assert dwal.read_manifest(root) == {"generation": 3, "first_segment": 7}
    assert not os.path.exists(os.path.join(root, "MANIFEST.tmp"))
    # either package reads the other's manifest
    assert jwal.read_manifest(root) == {"generation": 3, "first_segment": 7}


def test_dashboard_render_text_dump():
    from multiverso_tpu_torch.dashboard import count, monitor
    count("WAL_APPENDS", 4)
    with monitor("SERVER_PROCESS_ADD_MSG"):
        pass
    text = Dashboard.render()
    assert "WAL_APPENDS" in text and "4" in text
    assert "SERVER_PROCESS_ADD_MSG" in text
    assert "counter" in text and "section" in text


def test_wal_sync_levels_and_bad_level(tmp_path):
    """The three sync levels append the same bytes; ``always`` observes
    the fsync histogram; an unknown level is fatal."""
    trees = {}
    for level in ("none", "batch", "always"):
        root = str(tmp_path / level)
        writer = dwal.WalWriter(root, sync=level)
        for i in range(1, 4):
            writer.append(i, 0, 0, i, [np.float32([i, -i])])
        writer.close()
        trees[level] = _tree_bytes(root)
    assert trees["none"] == trees["batch"] == trees["always"]
    assert Dashboard.histogram("WAL_FSYNC_SECONDS").count == 3
    with pytest.raises(mvt.log.FatalError):
        dwal.WalWriter(str(tmp_path / "bad"), sync="sometimes")


# -- in-process WAL: append -> recover, compaction, truncation ----------------

def _wipe(table):
    """Zero a table in place (plays a fresh process's empty state)."""
    with Zoo.instance().admin():
        table.add(-np.asarray(table.get(), np.float32))
        np.testing.assert_array_equal(np.asarray(table.get()),
                                      np.zeros_like(np.asarray(table.get())))


def test_wal_append_then_recover_restores_state_and_seeds(tmp_path):
    root = str(tmp_path / "d")
    mvt.set_flag("wal_dir", root)
    mvt.init(remote_workers=1)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    deltas = [np.full(8, float(2 ** k), np.float32) for k in range(4)]
    for d in deltas:
        rt.add(d)
    assert mvt.watermark(endpoint)["watermark"] == 4
    client.close()
    mvt.stop_serving()
    assert Dashboard.counter_value("WAL_APPENDS") == 4

    _wipe(table)
    result = mvt.durable_recover([table])
    assert result.records_replayed == 4 and result.tables_restored == 0
    assert len(result.seeds) == 4
    assert all(req and msg_id for req, _w, msg_id in result.seeds)
    with Zoo.instance().admin():
        np.testing.assert_array_equal(np.asarray(table.get()),
                                      np.full(8, 15.0, np.float32))
    # the seeds are staged for the next serve()'s dedup window
    assert Zoo.instance()._dedup_seeds == result.seeds
    mvt.serve("127.0.0.1:0")
    rs = Zoo.instance().remote_server
    assert set(s[0] for s in result.seeds) <= set(rs._dedup)
    mvt.shutdown()


def test_snapshot_compaction_rotates_and_retires(tmp_path):
    root = str(tmp_path / "d")
    mvt.set_flag("wal_dir", root)
    mvt.init(remote_workers=1)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.full(8, 1.0, np.float32))
    rt.add(np.full(8, 2.0, np.float32))

    driver = checkpoint.CheckpointDriver([table], root, wal=mvt.wal_writer())
    driver.snapshot()
    manifest = dwal.read_manifest(root)
    assert manifest["generation"] == 0 and manifest["first_segment"] == 1
    # segment 0 (pre-snapshot) is retired; generation 0 holds the snapshot
    names = os.listdir(os.path.join(root, "wal"))
    assert not any(n.startswith("seg00000000.") for n in names)
    assert os.path.exists(os.path.join(root, "gen_0", "table_0.mvckpt"))
    assert Dashboard.counter_value("SNAPSHOT_COMPACTIONS") == 1

    rt.add(np.full(8, 4.0, np.float32))  # lands in segment 1
    driver.snapshot()  # generation 1; segment 1 retired, gen_0 removed
    assert dwal.read_manifest(root) == {"generation": 1, "first_segment": 2}
    assert not os.path.exists(os.path.join(root, "gen_0", "table_0.mvckpt"))

    rt.add(np.full(8, 8.0, np.float32))  # post-snapshot tail in segment 2
    client.close()
    mvt.stop_serving()
    _wipe(table)
    result = mvt.durable_recover([table])
    assert result.tables_restored == 1 and result.records_replayed == 1
    with Zoo.instance().admin():
        np.testing.assert_array_equal(np.asarray(table.get()),
                                      np.full(8, 15.0, np.float32))
    mvt.shutdown()


def test_checkpoint_driver_refuses_split_wal_root(tmp_path):
    writer = dwal.WalWriter(str(tmp_path / "wal_root"))
    with pytest.raises(mvt.log.FatalError):
        checkpoint.CheckpointDriver([], str(tmp_path / "elsewhere"),
                                    wal=writer)
    writer.close()


def test_recover_truncates_torn_tail(tmp_path):
    root = str(tmp_path / "d")
    mvt.set_flag("wal_dir", root)
    mvt.init(remote_workers=1)
    table = mvt.create_table("array", 8, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.full(8, 3.0, np.float32))
    rt.add(np.full(8, 4.0, np.float32))
    client.close()
    mvt.stop_serving()

    seg = os.path.join(root, "wal", "seg00000000.t0.mvwal")
    good_size = os.path.getsize(seg)
    with open(seg, "ab") as fp:  # a half-written record (crash tail)
        fp.write(b"\x99" * 11)
    _wipe(table)
    result = mvt.durable_recover([table])
    assert result.records_replayed == 2
    assert result.segments_truncated == 1
    assert Dashboard.counter_value("WAL_TRUNCATED_TAIL") == 1
    assert os.path.getsize(seg) == good_size  # tail physically cut
    with Zoo.instance().admin():
        np.testing.assert_array_equal(np.asarray(table.get()),
                                      np.full(8, 7.0, np.float32))
    mvt.shutdown()


def test_store_table_is_atomic(tmp_path):
    mvt.init()
    table = mvt.create_table("array", 4, np.float32)
    with Zoo.instance().admin():
        table.add(np.full(4, 5.0, np.float32))
    path = str(tmp_path / "t.mvckpt")
    checkpoint.store_table(table, path)
    assert os.path.exists(path)
    # no temp sibling survives a successful store
    assert [n for n in os.listdir(str(tmp_path)) if ".tmp-" in n] == []
    # a stale temp file (crash leftover) never disturbs a restore
    with open(path + f".tmp-{os.getpid()}", "wb") as fp:
        fp.write(b"MVTC")  # truncated: the classic mid-write corpse
    _wipe(table)
    checkpoint.load_table(table, path)
    with Zoo.instance().admin():
        np.testing.assert_array_equal(np.asarray(table.get()),
                                      np.full(4, 5.0, np.float32))


# -- corrupt-frame chaos: bit-flips recovered via CRC + retransmit ------------

def _push_deltas_under(spec, root):
    if spec:
        mvt.set_flag("fault_spec", spec)
        mvt.set_flag("fault_seed", SEED)
    mvt.set_flag("request_retry_seconds", 0.3)
    mvt.init(remote_workers=1, wal_dir=root)
    table = mvt.create_table("array", 16, np.float32)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rng = np.random.default_rng(0)
    deltas = rng.integers(-4, 5, size=(24, 16)).astype(np.float32)
    handles = [rt.add_async(d) for d in deltas]
    for h in handles:
        rt.wait(h)
    final = np.asarray(rt.get(), np.float32)
    client.close()
    mvt.shutdown()
    return final


def test_chaos_corrupt_frames_finish_bit_for_bit(tmp_path):
    """Seeded bit-flips in Add and reply payloads: the frame CRC rejects
    each corrupt frame, retransmit + dedup recover it, the final table is
    bit-for-bit the fault-free result, and the log holds each Add once."""
    plain = _push_deltas_under("", str(tmp_path / "plain"))
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TORCH_FLAGS.set("heartbeat_seconds", 0.0)
    chaos = _push_deltas_under(
        "corrupt:type=Request_Add,every=3;corrupt:type=Reply_Add,every=4",
        str(tmp_path / "chaos"))
    np.testing.assert_array_equal(chaos, plain)
    assert Dashboard.counter_value("FRAME_CRC_REJECTS") > 0
    assert Dashboard.counter_value("FAULT_INJECTED_CORRUPT") > 0
    assert Dashboard.counter_value("CLIENT_RETRIES") > 0
    # exactly-once in the log too: 24 records, replaying to the same sum
    seg = str(tmp_path / "chaos" / "wal" / "seg00000000.t0.mvwal")
    with open(seg, "rb") as fp:
        records, _, clean = dwal._read_segment(fp.read(), seg)
    assert clean and len(records) == 24
    total = sum(wire.decode(r.blobs)[0] for r in records)
    np.testing.assert_array_equal(total, chaos)


# -- interchange with the JAX package ------------------------------------------

def _seeded_adds(seed, n):
    """``n`` integer-valued whole-array Adds of 8 floats (exact sums)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-5, 6, size=(n, 8)).astype(np.float32)


def test_wal_directory_bytes_identical_across_packages(tmp_path):
    """The same appends, a rotation, a snapshot generation and a second
    segment write the same files, byte for byte, in both packages."""
    deltas = _seeded_adds(SEED, 6)
    trees = {}
    for name, walmod, wiremod, ckpt, opt in (
            ("port", dwal, wire, checkpoint, AddOption()),
            ("jax", jwal, jwire, jcheckpoint, JAddOption())):
        root = str(tmp_path / name)
        writer = walmod.WalWriter(root, sync="batch")
        for i, d in enumerate(deltas[:4]):
            writer.append(1000 + i, 2, 0, 50 + i, wiremod.encode((d, opt)))
            writer.append(2000 + i, 3, 1, 60 + i,
                          wiremod.encode((np.arange(i + 1, dtype=np.int32),
                                          d[: i + 1], opt)))
        first = writer.rotate()
        gen_dir = os.path.join(root, "gen_0")
        os.makedirs(gen_dir)
        with open(os.path.join(gen_dir, "table_0.mvckpt"), "wb") as fp:
            stream = (mv_io if name == "port" else jio).MemoryStream()
            ckpt.write_array(stream, deltas[:4].sum(axis=0))
            fp.write(stream.getvalue())
        writer.commit_snapshot(0, first)
        for i, d in enumerate(deltas[4:]):
            writer.append(3000 + i, 2, 0, 70 + i, wiremod.encode((d, opt)))
        writer.close()
        trees[name] = _tree_bytes(root)
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert sorted(trees["port"]) == [
        "MANIFEST", os.path.join("gen_0", "table_0.mvckpt"),
        os.path.join("wal", "seg00000001.t0.mvwal")]
    for path in trees["port"]:
        assert trees["port"][path] == trees["jax"][path], path


def _drive_tables(client, table_ids, rng, rounds):
    """Integer-valued Adds to an array, a matrix, a KV and a sparse table
    through worker proxies of either package."""
    arr, mat, kv, sp = (client.table(t) for t in table_ids)
    for _ in range(rounds):
        arr.add(rng.integers(-4, 5, 8).astype(np.float32))
        ids = rng.integers(0, 32, 6).astype(np.int32)
        mat.add(rng.integers(-4, 5, (6, 4)).astype(np.float32), row_ids=ids)
        keys = rng.integers(0, 50, 3).astype(np.int64)
        kv.add(keys, rng.integers(-9, 10, 3).astype(np.int64))
        sids = np.unique(rng.integers(0, 1000, 5)).astype(np.int64)
        sp.add(sids, rng.integers(-3, 4, (len(sids), 2)).astype(np.float32))


def _make_tables(pkg):
    return [pkg.create_table("array", 8, np.float32),
            pkg.create_table("matrix", 32, 4),
            pkg.create_table("kv", np.int64),
            pkg.create_table("sparse", 1000, 2)]


def _store_bytes(server_table, io_mod):
    stream = io_mod.MemoryStream()
    server_table.store(stream)
    return stream.getvalue()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_written_by_one_package_recovers_in_the_other(writer, tmp_path):
    """A serving process of one package logs 6 rounds of Adds to four
    table kinds (a snapshot generation after round 3); the other package
    re-creates the tables, ``durable_recover``s from that directory, and
    holds every table's bytes equal to the writer's live tables."""
    root = str(tmp_path / "d")
    rng = np.random.default_rng(SEED)
    src, dst = (mv, mvt) if writer == "jax" else (mvt, mv)
    src_io, dst_io = (jio, mv_io) if writer == "jax" else (mv_io, jio)
    src_ckpt = jcheckpoint if writer == "jax" else checkpoint
    mv.set_flag("heartbeat_seconds", 0.0)
    src.init(remote_workers=1, wal_dir=root)
    tables = _make_tables(src)
    ids = [t.table_id for t in tables]
    client = dst.remote_connect(src.serve("127.0.0.1:0"))  # the other's client
    _drive_tables(client, ids, rng, 3)
    src_ckpt.CheckpointDriver(tables, root, wal=src.wal_writer()).snapshot()
    _drive_tables(client, ids, rng, 3)
    client.close()
    src.stop_serving()
    want = [_store_bytes(t._server_table, src_io) for t in tables]
    src.shutdown()

    dst.init()
    fresh = _make_tables(dst)
    result = dst.durable_recover(fresh, root)
    assert result.tables_restored == 4
    assert result.records_replayed == 12
    got = [_store_bytes(t._server_table, dst_io) for t in fresh]
    for kind, g, w in zip(("array", "matrix", "kv", "sparse"), got, want):
        assert g == w, kind
    dst.shutdown()
    JZoo._reset_instance()


def test_deterministic_server_logs_arrival_order(tmp_path):
    """The deterministic server logs each Add when it accepts it (arrival
    order) and applies in (round, worker) order. Recovery replays the
    arrival order: the port's and the JAX package's recoveries of that log
    give the same bytes, equal to the live table for integer deltas."""
    root = str(tmp_path / "d")
    mvt.init(ps_role="server", remote_workers=2, deterministic=True,
             wal_dir=root)
    table = mvt.create_table("matrix", 16, 4)
    endpoint = mvt.serve("127.0.0.1:0")
    clients = [mvt.remote_connect(endpoint) for _ in range(2)]
    proxies = [c.table(table.table_id) for c in clients]
    rng = np.random.default_rng(SEED)
    # worker 1 runs a round ahead of worker 0: arrival != apply order
    order = [1, 1, 0, 1, 0, 0]
    for w in order:
        ids = rng.integers(0, 16, 5).astype(np.int32)
        proxies[w].add(rng.integers(-4, 5, (5, 4)).astype(np.float32),
                       row_ids=ids)
    for p in proxies:
        p.finish_train()
    for c in clients:
        c.close()
    mvt.stop_serving()
    live = Zoo.instance().server.run_serialized(
        lambda: _store_bytes(table._server_table, mv_io))
    seg = os.path.join(root, "wal", "seg00000000.t0.mvwal")
    with open(seg, "rb") as fp:
        records, _, _ = dwal._read_segment(fp.read(), seg)
    workers = [r.worker for r in records]
    base = min(workers)
    assert [w - base for w in workers] == order
    mvt.shutdown()

    mvt.init()
    ported = mvt.create_table("matrix", 16, 4)
    assert mvt.durable_recover([ported], root).records_replayed == 6
    got = _store_bytes(ported._server_table, mv_io)
    mvt.shutdown()
    mv.init()
    jtable = mv.create_table("matrix", 16, 4)
    assert mv.durable_recover([jtable], root).records_replayed == 6
    want = _store_bytes(jtable._server_table, jio)
    mv.shutdown()
    assert got == want
    assert got == live
