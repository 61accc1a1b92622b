"""The port's second storage scheme, the socket-served ``mvfs://`` remote
filesystem (``multiverso_tpu_torch/io/mvfs.py``): the cases of
``tests/test_io_remote.py`` on the port but the ``fsspec`` fallback (the
port has none: an unknown scheme stays fatal) — streams, atomic commits,
directory ops, CheckpointDriver through the scheme, pool recovery — plus
the interchange (a client of either package on a server of the other) and
durable serving with its WAL root on ``mvfs://``."""

import time

import numpy as np
import pytest

import torch

from multiverso_tpu.io import mvfs as jmvfs

import multiverso_tpu_torch as mv
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.checkpoint import (CheckpointDriver, load_table,
                                             store_table)
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.io import TextReader
from multiverso_tpu_torch.io.mvfs import MvfsServer, reset_connections
from multiverso_tpu_torch.runtime.zoo import Zoo


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread; whatever a test starts is stopped."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TORCH_FLAGS.set("heartbeat_seconds", 0.0)
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


@pytest.fixture
def mvfs(tmp_path):
    server = MvfsServer(str(tmp_path / "export"))
    endpoint = server.serve("127.0.0.1:0")
    yield f"mvfs://{endpoint}"
    reset_connections()
    server.stop()


def test_mvfs_stream_roundtrip(mvfs):
    payload = bytes(range(256)) * 100
    with mv_io.get_stream(f"{mvfs}/dir/data.bin", "w") as s:
        assert s.good()
        s.write(payload[:1000])
        s.write(payload[1000:])
    with mv_io.get_stream(f"{mvfs}/dir/data.bin", "r") as s:
        assert s.read(100) == payload[:100]
        assert s.read() == payload[100:]


def test_mvfs_append_and_missing(mvfs):
    with mv_io.get_stream(f"{mvfs}/log.txt", "w") as s:
        s.write(b"one\n")
    with mv_io.get_stream(f"{mvfs}/log.txt", "a") as s:
        s.write(b"two\n")
    with mv_io.get_stream(f"{mvfs}/log.txt", "r") as s:
        assert s.read() == b"one\ntwo\n"
    # missing file: bad stream, read fatals (LocalStream contract)
    bad = mv_io.get_stream(f"{mvfs}/nope.bin", "r")
    assert not bad.good()
    with pytest.raises(mv.log.FatalError):
        bad.read()


def test_mvfs_write_commit_is_atomic(mvfs):
    """An open write handle must not be visible at the final name until
    close (temp + rename, the crash-safety contract)."""
    fs = mv_io.fs_for(mvfs)
    s = mv_io.get_stream(f"{mvfs}/atomic.bin", "w")
    s.write(b"partial")
    assert not fs.exists(f"{mvfs}/atomic.bin")
    s.close()
    assert fs.exists(f"{mvfs}/atomic.bin")


def test_mvfs_filesystem_ops(mvfs):
    fs = mv_io.fs_for(mvfs)
    fs.makedirs(f"{mvfs}/sub")
    with mv_io.get_stream(f"{mvfs}/sub/a.bin", "w") as s:
        s.write(b"x")
    assert fs.listdir(f"{mvfs}/sub") == ["a.bin"]
    fs.replace(f"{mvfs}/sub/a.bin", f"{mvfs}/sub/b.bin")
    assert fs.listdir(f"{mvfs}/sub") == ["b.bin"]
    fs.remove(f"{mvfs}/sub/b.bin")
    assert fs.listdir(f"{mvfs}/sub") == []


def test_mvfs_rejects_path_escape(mvfs):
    bad = mv_io.get_stream(f"{mvfs}/../evil.bin", "w")
    assert not bad.good()


def test_text_reader_over_mvfs(mvfs):
    """TextReader is scheme-agnostic: line reading over the remote stream
    (reference: TextReader rode Stream the same way, io.cpp:25-60)."""
    with mv_io.get_stream(f"{mvfs}/corpus.txt", "w") as s:
        s.write("first line\nsecond line\r\nthird".encode())
    reader = TextReader(f"{mvfs}/corpus.txt")
    assert reader.get_line() == "first line"
    assert reader.get_line() == "second line"
    assert reader.get_line() == "third"
    assert reader.get_line() is None
    reader.close()


def test_matrix_table_store_load_through_mvfs(port_env, mvfs):
    """Table Store/Load across the remote scheme."""
    table = mv.create_table("matrix", 6, 4, np.float32)
    vals = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
    table.add(vals)
    store_table(table, f"{mvfs}/m.mvckpt")

    fresh = mv.create_table("matrix", 6, 4, np.float32)
    load_table(fresh, f"{mvfs}/m.mvckpt")
    np.testing.assert_allclose(fresh.get(), vals, rtol=1e-6)


def test_checkpoint_driver_through_mvfs(port_env, mvfs):
    """VERDICT r2 task 5 done-criterion: CheckpointDriver round-trips a
    MatrixTable through the non-file scheme (snapshot + atomic replace +
    restore, all as mvfs RPCs)."""
    table = mv.create_table("matrix", 8, 4, np.float32)
    vals = np.random.default_rng(5).normal(size=(8, 4)).astype(np.float32)
    table.add(vals)
    driver = CheckpointDriver([table], f"{mvfs}/run1", interval_steps=1)
    driver.step()  # snapshot
    table.add(vals)  # diverge live state from the snapshot
    driver.close()

    restored = driver.restore()
    assert restored
    np.testing.assert_allclose(table.get(), vals, rtol=1e-6)


def test_unknown_scheme_still_fatals():
    with pytest.raises(mv.log.FatalError):
        mv_io.get_stream("bogus9z://x/y", "r")


def test_mvfs_down_server_yields_bad_stream():
    """A down server gives good()==False (the LocalStream contract), not a
    raw socket exception from get_stream."""
    bad = mv_io.get_stream("mvfs://127.0.0.1:1/x.bin", "r")  # port 1: refused
    assert not bad.good()


def test_mvfs_concurrent_writers_same_path(mvfs):
    """Two concurrent write handles on one path must not share a temp file;
    the committed file is exactly one writer's payload."""
    a = mv_io.get_stream(f"{mvfs}/clash.bin", "w")
    b = mv_io.get_stream(f"{mvfs}/clash.bin", "w")
    a.write(b"A" * 1000)
    b.write(b"B" * 500)
    a.close()
    b.close()
    with mv_io.get_stream(f"{mvfs}/clash.bin", "r") as s:
        data = s.read()
    assert data == b"B" * 500  # last close wins, uncorrupted


def test_checkpoint_timer_survives_store_outage(tmp_path, port_env):
    """The periodic timer must outlive a transient remote-store failure."""
    import time

    from multiverso_tpu_torch.io.mvfs import MvfsServer as Srv
    server = Srv(str(tmp_path / "x"))
    ep = server.serve("127.0.0.1:0")
    table = mv.create_table("array", 4, np.float32)
    table.add(np.ones(4, np.float32))
    driver = CheckpointDriver([table], f"mvfs://{ep}/run",
                              interval_seconds=0.15)
    time.sleep(0.4)  # at least one good snapshot
    server.stop()
    reset_connections()
    time.sleep(0.4)  # snapshots fail; the thread must survive
    assert driver._thread.is_alive(), "timer thread died on store outage"
    driver.close()


def test_mvfs_missing_port_is_fatal():
    with pytest.raises(mv.log.FatalError):
        mv_io.get_stream("mvfs://hostonly/x.bin", "r")


def test_mvfs_stop_severs_live_connections(tmp_path):
    """stop() must take established connections down too — a 'stopped'
    server must not keep serving writes into its root."""
    server = MvfsServer(str(tmp_path / "r"))
    ep = server.serve("127.0.0.1:0")
    with mv_io.get_stream(f"mvfs://{ep}/a.bin", "w") as s:
        s.write(b"x")  # establishes the pooled connection
    server.stop()
    with pytest.raises((IOError, OSError)):
        fs = mv_io.fs_for(f"mvfs://{ep}")
        fs.exists(f"mvfs://{ep}/a.bin")
    reset_connections()


def test_mvfs_pool_recovers_after_server_restart(tmp_path):
    """Filesystem ops evict broken pooled connections, so a restarted
    server is reachable without manual reset_connections()."""
    server = MvfsServer(str(tmp_path / "r"))
    ep = server.serve("127.0.0.1:0")
    fs = mv_io.fs_for(f"mvfs://{ep}")
    with mv_io.get_stream(f"mvfs://{ep}/a.bin", "w") as s:
        s.write(b"x")
    assert fs.exists(f"mvfs://{ep}/a.bin")
    server.stop()
    with pytest.raises((IOError, OSError)):
        fs.exists(f"mvfs://{ep}/a.bin")  # fails AND evicts the dead conn
    server2 = MvfsServer(str(tmp_path / "r"))
    deadline = time.monotonic() + 10
    while True:  # old conn may sit in FIN_WAIT briefly; rebind when clear
        try:
            server2.serve(ep)  # same port
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    assert fs.exists(f"mvfs://{ep}/a.bin")  # redialed automatically
    reset_connections()
    server2.stop()


@pytest.mark.parametrize("direction", ["port_client", "jax_client"])
def test_mvfs_interop_both_directions(direction, tmp_path):
    """The protocol is the JAX package's: a port client writes and lists
    through a JAX server, and a JAX client through a port server."""
    from multiverso_tpu import io as jio
    server_cls = jmvfs.MvfsServer if direction == "port_client" else MvfsServer
    client_io = mv_io if direction == "port_client" else jio
    server = server_cls(str(tmp_path / "export"))
    ep = server.serve("127.0.0.1:0")
    try:
        payload = bytes(range(256)) * 40
        with client_io.get_stream(f"mvfs://{ep}/d/x.bin", "w") as s:
            s.write(payload)
        with client_io.get_stream(f"mvfs://{ep}/d/x.bin", "a") as s:
            s.write(b"tail")
        assert client_io.fs_for(f"mvfs://{ep}").listdir(
            f"mvfs://{ep}/d") == ["x.bin"]
        with open(str(tmp_path / "export" / "d" / "x.bin"), "rb") as fp:
            assert fp.read() == payload + b"tail"
    finally:
        reset_connections()
        jmvfs.reset_connections()
        server.stop()


def test_durable_serving_with_wal_root_on_mvfs(mvfs):
    """The WAL, the snapshot generations and the MANIFEST all ride the
    scheme: serve with ``wal_dir=mvfs://...``, compact, add a tail, then
    recover from the remote root."""
    root = f"{mvfs}/durable"
    mv.init(remote_workers=1, wal_dir=root)
    table = mv.create_table("array", 8, np.float32)
    client = mv.remote_connect(mv.serve("127.0.0.1:0"))
    rt = client.table(table.table_id)
    rt.add(np.full(8, 1.0, np.float32))
    rt.add(np.full(8, 2.0, np.float32))
    CheckpointDriver([table], root, wal=mv.wal_writer()).snapshot()
    rt.add(np.full(8, 4.0, np.float32))
    client.close()
    mv.stop_serving()
    fs = mv_io.fs_for(root)
    assert fs.exists(f"{root}/MANIFEST")
    assert fs.listdir(f"{root}/gen_0") == ["table_0.mvckpt"]
    with Zoo.instance().admin():
        table.add(-table.get())
    result = mv.durable_recover([table], root)
    assert result.tables_restored == 1 and result.records_replayed == 1
    with Zoo.instance().admin():
        np.testing.assert_array_equal(table.get(), np.full(8, 7.0))
