"""The port's zero-copy coalescing wire path (``runtime/net.py`` drain
loops): the transport cases of ``tests/test_wire_coalesce.py`` on
``multiverso_tpu_torch``. Vectored frames are bit-identical to the
per-frame concatenated form on the wire, a forced-coalesce burst ships
many frames per syscall with bit-identical replies, and a corrupted frame
inside a coalesced batch is CRC-rejected without desyncing the stream.
The multihost forward window (``runtime/multihost.py``) is not ported
yet, and its cases wait with it."""

import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.net import (_HEADER, _MAGIC, _VERSION, TcpNet,
                                        _pack_blob)
from multiverso_tpu_torch.runtime.zoo import Zoo


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


def _legacy_frame(msg, channel=0):
    """The per-frame concatenating frame assembly (tobytes + single-shot CRC): the
    golden reference the vectored path must match byte-for-byte."""
    parts = []
    for arr in msg.data:
        arr = np.ascontiguousarray(np.asarray(arr))
        dt = arr.dtype.str.encode()[:8].ljust(8, b" ")
        payload = arr.tobytes()
        parts.append(struct.pack("<B8sq", arr.ndim, dt, len(payload))
                     + struct.pack(f"<{arr.ndim}q", *arr.shape))
        parts.append(payload)
    payload = b"".join(parts)
    header = _HEADER.pack(_MAGIC, _VERSION, channel, msg.src, msg.dst,
                          int(msg.type), msg.table_id, msg.msg_id,
                          msg.req_id, msg.watermark, 0, len(msg.data),
                          len(payload), zlib.crc32(payload))
    return header + payload


def _messages():
    rng = np.random.default_rng(3)
    return [
        Message(src=0, dst=0, type=MsgType.Request_Add, table_id=2,
                msg_id=11, req_id=7,
                data=[rng.standard_normal((16, 8)).astype(np.float32),
                      np.arange(5, dtype=np.int64)]),
        Message(src=0, dst=0, type=MsgType.Request_Get, msg_id=12),
        Message(src=0, dst=0, type=MsgType.Reply_Get, msg_id=13,
                data=[np.zeros(0, np.float32),          # empty blob
                      np.float32(2.5).reshape(()),      # 0-d blob
                      np.arange(6).astype(">i4")]),     # non-native order
    ]


def test_pack_blob_is_zero_copy():
    arr = np.arange(64, dtype=np.float32)
    head, payload, nbytes = _pack_blob(arr)
    assert nbytes == arr.nbytes and len(payload) == arr.nbytes
    # the payload memoryview aliases the array's own memory — no copy
    assert payload.obj is arr
    assert bytes(payload) == arr.tobytes()


def test_vectored_frame_bit_identical_to_legacy():
    net = TcpNet()  # coalescing defaults on; _frame materializes segments
    for msg in _messages():
        assert net._frame(msg, 0) == _legacy_frame(msg, 0)
        assert net._frame(msg, 1) == _legacy_frame(msg, 1)


def test_coalesced_batch_bytes_equal_legacy_concatenation():
    """Golden on-the-wire equivalence: a held-then-released burst arrives
    as exactly the legacy frames concatenated — receivers cannot tell
    coalescing ever happened."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    net = TcpNet()
    net.rank = 0
    net.connect([f"127.0.0.1:{listener.getsockname()[1]}"])
    try:
        msgs = _messages()
        expected = b"".join(_legacy_frame(m, 0) for m in msgs)
        sock = net._socket_for(0)
        conn, _ = listener.accept()
        net._hold_sends(sock)
        for m in msgs:
            threading.Thread(target=net.send, args=(m,)).start()
        st = net._state_for(sock)
        deadline = time.monotonic() + 10
        while len(st.frames) < len(msgs):
            assert time.monotonic() < deadline, "frames never queued"
            time.sleep(0.01)
        net._release_sends(sock)
        got = b""
        conn.settimeout(10)
        while len(got) < len(expected):
            got += conn.recv(len(expected) - len(got))
        assert got == expected
        conn.close()
    finally:
        net.finalize()
        listener.close()


def test_sendmsg_all_partial_writes_and_iov_chunking():
    """>512 segments (IOV_MAX chunking) and partial kernel writes both
    reassemble to the exact byte stream."""
    s1, s2 = socket.socketpair()
    s1.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
    rng = np.random.default_rng(0)
    segs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in ([3, 0, 70000] + [17] * 1200)]
    expected = b"".join(segs)
    received = bytearray()

    def read():
        while len(received) < len(expected):
            chunk = s2.recv(1 << 16)
            if not chunk:
                return
            received.extend(chunk)

    t = threading.Thread(target=read)
    t.start()
    syscalls = TcpNet._sendmsg_all(s1, [memoryview(s) for s in segs])
    t.join(timeout=20)
    assert bytes(received) == expected
    assert syscalls >= 3  # 1200+ segments cannot fit one iovec
    s1.close()
    s2.close()


def _serve_matrix(rows=32, cols=4):
    mv.set_flag("heartbeat_seconds", 0)
    mv.init(remote_workers=1)
    table = mv.create_table("matrix", num_row=rows, num_col=cols)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    return table, client


def test_forced_coalesce_many_async_adds_bit_identical():
    """The acceptance shape from the issue: a burst of async Adds queued
    behind an in-flight send flushes as ONE vectored syscall each way —
    WIRE_FRAMES_PER_SYSCALL p50 ends up well above 1 — and the replies /
    final table are bit-identical to what any per-frame path produces."""
    table, client = _serve_matrix()
    try:
        rt = client.table(table.table_id)
        rng = np.random.default_rng(1)
        deltas = rng.integers(-3, 4, size=(32, 32, 4)).astype(np.float32)
        rt.add(deltas[0])  # warm: dials the conn, settles registration
        Dashboard.reset()

        cnet = client._net
        csock = cnet._conns[0]
        snet = Zoo.instance().remote_server._net
        deadline = time.monotonic() + 10
        while not snet._accepted:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ssock = snet._accepted[0]

        cnet._hold_sends(csock)
        snet._hold_sends(ssock)
        handles = [rt.add_async(d) for d in deltas[1:]]
        cstate = cnet._state_for(csock)
        while len(cstate.frames) < len(handles):
            assert time.monotonic() < deadline, "client frames never queued"
            time.sleep(0.01)
        cnet._release_sends(csock)
        sstate = snet._state_for(ssock)
        while len(sstate.frames) < len(handles):
            assert time.monotonic() < deadline, "replies never queued"
            time.sleep(0.01)
        snet._release_sends(ssock)
        for h in handles:
            rt.wait(h)

        hist = Dashboard.histogram("WIRE_FRAMES_PER_SYSCALL")
        assert hist.count >= 2
        assert hist.p50 > 1.0, f"p50={hist.p50} (no coalescing happened)"
        assert Dashboard.counter_value("SEND_COALESCED_FRAMES") >= 62
        np.testing.assert_array_equal(np.asarray(rt.get(), np.float32),
                                      deltas.sum(axis=0))
    finally:
        client.close()
        mv.shutdown()


def test_corrupt_coalesced_batch_crc_reject_without_desync():
    """ChaosNet flips a bit inside frames riding coalesced batches: the
    receiver CRC-rejects exactly those frames, the stream stays in sync
    (later frames in the same batch still parse), and retransmit + dedup
    recover every Add exactly once."""
    mv.set_flag("fault_spec", "corrupt:type=Request_Add,every=4")
    mv.set_flag("fault_seed", 7)
    mv.set_flag("request_retry_seconds", 0.3)
    table, client = _serve_matrix(rows=16, cols=4)
    try:
        rt = client.table(table.table_id)
        rng = np.random.default_rng(2)
        deltas = rng.integers(-4, 5, size=(24, 16, 4)).astype(np.float32)
        handles = [rt.add_async(d) for d in deltas]
        for h in handles:
            rt.wait(h)
        assert Dashboard.counter_value("FRAME_CRC_REJECTS") >= 1
        np.testing.assert_array_equal(np.asarray(rt.get(), np.float32),
                                      deltas.sum(axis=0))
    finally:
        client.close()
        mv.shutdown()


def test_legacy_flag_restores_per_frame_sendall():
    """wire_coalesce_frames=0: the per-frame posture — every frame its
    own syscall, no drain threads — still round-trips bit-identically."""
    mv.set_flag("wire_coalesce_frames", 0)
    table, client = _serve_matrix(rows=8, cols=4)
    try:
        assert not client._net._coalesce
        rt = client.table(table.table_id)
        delta = np.ones((8, 4), np.float32)
        rt.add(delta)
        np.testing.assert_array_equal(np.asarray(rt.get(), np.float32),
                                      delta)
        assert Dashboard.counter_value("SEND_SYSCALLS") > 0
    finally:
        client.close()
        mv.shutdown()


# -- windowed multihost control plane ----------------------------------------
