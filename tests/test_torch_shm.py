"""The port's shared-memory ring transport (``runtime/shm.py`` and the
negotiation in ``runtime/net.py``): the cases of ``tests/test_shm.py`` on
``multiverso_tpu_torch``. The ring carries the same frame stream as TCP —
framing, CRC, req-id dedup, retransmit recovery and the chaos seams —
negotiated at connect and falling back to TCP when the peer declines;
segment files are unlinked as soon as the handshake settles."""

import glob
import os
import threading
import time

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.runtime import shm
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.net import AllreduceEngine, TcpNet


# -- the port's runtime (tests/conftest.py resets only the JAX package's) ----

@pytest.fixture(autouse=True)
def port_runtime(tmp_path):
    """The port's default flags with the tables on the CPU and the ring
    segments in the test's own temporary directory, one intra-op thread
    (the dispatcher's torch calls hand off through the CPU build's thread
    pool, which can stall for minutes on a loaded machine), and whatever
    the test started stopped."""
    import torch
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard as TorchDashboard
    from multiverso_tpu_torch.runtime.zoo import Zoo as TorchZoo
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TORCH_FLAGS.set("wire_shm_dir", str(tmp_path))
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


def _leaked_segments():
    return glob.glob(os.path.join(shm.shm_dir(),
                                  f"mvtpu-shm-{os.getpid()}-*"))


# -- ring units ----------------------------------------------------------------

def test_ring_byte_stream_across_wrap_boundary(tmp_path):
    ring = shm.Ring.create(str(tmp_path / "r"), 4096)
    payload = bytes(range(256)) * 40  # 10240 bytes >> capacity
    got = bytearray()
    done = threading.Event()

    def reader():
        while len(got) < len(payload):
            got.extend(ring.read_exact(512))
        done.set()

    t = threading.Thread(target=reader)
    t.start()
    ring.write(payload)  # blocks on full ring; reader drains
    assert done.wait(10)
    t.join(timeout=5)
    assert bytes(got) == payload
    ring.dispose()


def test_ring_closed_semantics(tmp_path):
    ring = shm.Ring.create(str(tmp_path / "r"), 4096)
    ring.write(b"tail")
    ring.close_writer()
    assert ring.read_exact(4) == b"tail"  # drains fully first
    with pytest.raises(ConnectionError):
        ring.read_exact(1)
    ring.close_reader()
    with pytest.raises(OSError):
        ring.write(b"x")
    ring.dispose()


def test_ring_open_validates_magic(tmp_path):
    path = str(tmp_path / "bogus")
    with open(path, "wb") as f:
        f.write(b"\0" * 8192)
    with pytest.raises(OSError):
        shm.Ring.open(path)


# -- negotiation + served tables ------------------------------------------------

def test_negotiated_round_trip_all_kinds_no_leaks():
    mv.init(remote_workers=2, wire_shm=True, heartbeat_seconds=0)
    mat = mv.create_table("matrix", num_row=32, num_col=4)
    arr = mv.create_table("array", 8, np.float32)
    kv = mv.create_table("kv")
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rmat, rarr, rkv = (client.table(t.table_id) for t in (mat, arr, kv))
    ids = np.array([1, 3, 5], np.int32)
    rmat.add(np.ones((3, 4), np.float32), row_ids=ids)
    np.testing.assert_array_equal(rmat.get(ids),
                                  np.ones((3, 4), np.float32))
    rarr.add(np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(rarr.get(),
                                  np.arange(8, dtype=np.float32))
    rkv.add([7, 9], [1.5, 2.5])
    assert rkv.get([7, 9]) == [1.5, 2.5]
    assert Dashboard.counter_value("SHM_TX_FRAMES") > 0
    assert Dashboard.counter_value("SHM_RX_FRAMES") > 0
    assert not _leaked_segments()  # unlinked at handshake, not at close
    client.close()
    mv.shutdown()
    assert not _leaked_segments()


def test_falls_back_to_tcp_when_server_declines():
    # server explicitly declines (the premise survives an MV_WIRE_SHM=1
    # chaos-matrix run forcing the flag on)
    mv.init(remote_workers=2, heartbeat_seconds=0, wire_shm=False)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    mv.set_flag("wire_shm", True)  # client offers; server declines
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(8, np.float32))
    np.testing.assert_array_equal(rt.get(), np.ones(8, np.float32))
    assert Dashboard.counter_value("SHM_TX_FRAMES") == 0
    assert not _leaked_segments()
    client.close()
    mv.shutdown()


def test_large_frame_streams_through_small_ring():
    mv.init(remote_workers=2, wire_shm=True, wire_shm_bytes=4096,
            heartbeat_seconds=0)
    table = mv.create_table("array", 65536, np.float32)  # 256 KiB frames
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    delta = np.arange(65536, dtype=np.float32)
    rt.add(delta)
    rt.add(delta)
    np.testing.assert_array_equal(rt.get(), 2.0 * delta)
    assert Dashboard.counter_value("SHM_TX_FRAMES") > 0
    client.close()
    mv.shutdown()


# -- chaos parity with TCP -------------------------------------------------------

def _push_deltas_under(fault_spec, use_shm):
    """12 integer-valued Adds under a seeded fault schedule; returns the
    final table (mirrors test_durable's chaos harness, over either
    transport)."""
    flags = dict(remote_workers=2, heartbeat_seconds=0,
                 request_retry_seconds=0.3, retry_base_seconds=0.05,
                 fault_spec=fault_spec, wire_shm=use_shm)
    mv.init(**flags)
    mv.set_flag("fault_seed", int(os.environ.get("CHAOS_SEED", "7")))
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    handles = []
    for i in range(12):
        handles.append(rt.add_async(np.full(8, float(2 ** (i % 5)),
                                            np.float32)))
    for h in handles:
        rt.wait(h)
    final = np.asarray(rt.get(), np.float32)
    client.close()
    mv.shutdown()
    return final


def test_corrupt_chaos_over_shm_bit_identical_to_tcp():
    """Seeded bit-flips over the ring: the v3 CRC rejects each corrupt
    frame and retransmit + dedup recover it — the final table is
    bit-for-bit both the fault-free result and the TCP chaos result."""
    spec = ("corrupt:type=Request_Add,every=3;"
            "corrupt:type=Reply_Add,every=4")
    plain = _push_deltas_under("", use_shm=True)
    shm_chaos = _push_deltas_under(spec, use_shm=True)
    assert Dashboard.counter_value("FRAME_CRC_REJECTS") > 0
    assert Dashboard.counter_value("CLIENT_RETRIES") > 0
    tcp_chaos = _push_deltas_under(spec, use_shm=False)
    np.testing.assert_array_equal(shm_chaos, plain)
    np.testing.assert_array_equal(tcp_chaos, plain)


def test_drop_chaos_over_shm_recovers_by_retransmit():
    plain = _push_deltas_under("", use_shm=True)
    dropped = _push_deltas_under("drop:type=Request_Add,every=4",
                                 use_shm=True)
    assert Dashboard.counter_value("CLIENT_RETRIES") > 0
    np.testing.assert_array_equal(dropped, plain)


# -- raw channel + collectives ----------------------------------------------------

def test_raw_channel_and_allreduce_over_shm():
    mv.set_flag("wire_shm", True)
    nets = [TcpNet() for _ in range(2)]
    endpoints = [net.bind(r, "127.0.0.1:0") for r, net in enumerate(nets)]
    for net in nets:
        net.connect(endpoints)
    try:
        nets[0].send_to(1, [np.arange(6, dtype=np.float32)])
        got = nets[1].recv_from(0)
        np.testing.assert_array_equal(got[0],
                                      np.arange(6, dtype=np.float32))
        assert Dashboard.counter_value("SHM_TX_FRAMES") > 0
        results = {}

        def run(rank):
            engine = AllreduceEngine(nets[rank])
            results[rank] = engine.allreduce(
                np.full(5, float(rank + 1), np.float64))

        threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for r in (0, 1):
            np.testing.assert_array_equal(results[r],
                                          np.full(5, 3.0, np.float64))
    finally:
        for net in nets:
            net.finalize()
    assert not _leaked_segments()
