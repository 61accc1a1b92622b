"""The port's host transport and collectives (``runtime/net.py``): the
cases of ``tests/test_net.py`` on ``multiverso_tpu_torch`` — mailbox and
raw-channel frames, multi-dtype blobs, the allreduce engine, the machine
file and the raw ``net_bind``/``net_connect`` calls."""

import threading

import numpy as np
import pytest

from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.net import AllreduceEngine, TcpNet, get_local_ip


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


def _make_world(n):
    """n TcpNet instances bound to ephemeral localhost ports."""
    nets = [TcpNet() for _ in range(n)]
    endpoints = [net.bind(r, "127.0.0.1:0") for r, net in enumerate(nets)]
    for net in nets:
        net.connect(endpoints)
    return nets


def _finalize(nets):
    for net in nets:
        net.finalize()


def test_mailbox_ping_pong():
    nets = _make_world(2)
    try:
        payload = np.arange(64, dtype=np.float32).reshape(8, 8)
        nets[0].send(Message(src=0, dst=1, type=MsgType.Request_Add,
                             table_id=7, msg_id=42, data=[payload]))
        msg = nets[1].recv()
        assert msg.src == 0 and msg.dst == 1
        assert msg.type == MsgType.Request_Add
        assert msg.table_id == 7 and msg.msg_id == 42
        np.testing.assert_array_equal(msg.data[0], payload)

        reply = msg.create_reply()
        reply.data = [payload * 2]
        nets[1].send(reply)
        back = nets[0].recv()
        assert back.type == MsgType.Reply_Add
        np.testing.assert_array_equal(back.data[0], payload * 2)
    finally:
        _finalize(nets)


def test_raw_channel_is_separate_from_mailbox():
    nets = _make_world(2)
    try:
        nets[0].send(Message(src=0, dst=1, type=MsgType.Request_Get,
                             data=[np.zeros(3, np.float32)]))
        nets[0].send_to(1, [np.ones(4, np.int32)])
        # raw frame must not be consumed by the mailbox and vice versa
        raw = nets[1].recv_from(0)
        np.testing.assert_array_equal(raw[0], np.ones(4, np.int32))
        mail = nets[1].recv()
        assert mail.type == MsgType.Request_Get
    finally:
        _finalize(nets)


def test_multi_blob_dtypes_roundtrip():
    nets = _make_world(2)
    try:
        blobs = [np.arange(5, dtype=np.int64),
                 np.float64([[1.5, -2.5]]),
                 np.zeros(0, np.float32)]
        nets[1].send_to(0, blobs)
        got = nets[0].recv_from(1)
        for a, b in zip(blobs, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    finally:
        _finalize(nets)


@pytest.mark.parametrize("world,size", [(2, 16), (4, 10), (3, 1), (5, 1024)])
def test_allreduce_sum(world, size):
    """MV_Aggregate semantics: every rank receives the elementwise sum
    (Test/test_allreduce.cpp:13-16: result == MV_Size for all-ones)."""
    nets = _make_world(world)
    results = {}

    def run(r):
        engine = AllreduceEngine(nets[r])
        data = np.full(size, float(r + 1), np.float32)
        results[r] = engine.allreduce(data)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for t in threads:
        assert not t.is_alive(), "allreduce hung"
    _finalize(nets)
    expect = np.full(size, float(sum(range(1, world + 1))), np.float32)
    for r in range(world):
        np.testing.assert_allclose(results[r], expect, err_msg=f"rank {r}")


def test_allreduce_preserves_shape_and_dtype():
    nets = _make_world(2)
    results = {}

    def run(r):
        results[r] = AllreduceEngine(nets[r]).allreduce(
            np.ones((3, 5), np.float64) * (r + 1))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    _finalize(nets)
    for r in range(2):
        assert results[r].shape == (3, 5)
        assert results[r].dtype == np.float64
        np.testing.assert_allclose(results[r], np.full((3, 5), 3.0))


def test_allgather_rank_order():
    nets = _make_world(3)
    results = {}

    def run(r):
        results[r] = AllreduceEngine(nets[r]).allgather(
            np.full(4, float(r), np.float32))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    _finalize(nets)
    for r in range(3):
        parts = results[r]
        assert len(parts) == 3
        for i, part in enumerate(parts):
            np.testing.assert_allclose(part, np.full(4, float(i)))


def test_machine_file(tmp_path):
    from multiverso_tpu_torch.config import FLAGS  # ensure port flag registered
    from multiverso_tpu_torch.runtime.net import parse_machine_file
    f = tmp_path / "machines"
    f.write_text("# cluster\n10.0.0.1:5000\n10.0.0.2\n\n10.0.0.3:7000\n")
    eps = parse_machine_file(str(f))
    assert eps[0] == "10.0.0.1:5000"
    assert eps[1].startswith("10.0.0.2:")
    assert eps[2] == "10.0.0.3:7000"


def test_get_local_ip():
    ip = get_local_ip()
    assert ip.count(".") == 3


def test_net_connect_reads_machine_file_flag(tmp_path):
    """MV_NetConnect with no endpoint list falls back to the machine_file
    flag (reference ZMQ ParseMachineFile contract, zmq_net.h:234-254)."""
    import multiverso_tpu_torch as mv

    f = tmp_path / "machines"
    f.write_text("127.0.0.1:6001\n127.0.0.1:6002\n")
    mv.set_flag("machine_file", str(f))
    try:
        mv.net_bind(0, "127.0.0.1:0")
        mv.net_connect()  # no endpoints: read the flag
        assert mv.net().size == 2
        assert mv.net()._endpoints == ["127.0.0.1:6001", "127.0.0.1:6002"]
    finally:
        mv.net_finalize()


def test_net_connect_without_machine_file_fatals():
    import multiverso_tpu_torch as mv

    try:
        mv.net_bind(0, "127.0.0.1:0")
        with pytest.raises(mv.log.FatalError):
            mv.net_connect()
    finally:
        mv.net_finalize()
