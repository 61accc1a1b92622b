"""The port's remote serving (``runtime/remote.py``, ``runtime/wire.py``):
the cases of ``tests/test_remote.py`` on ``multiverso_tpu_torch`` — the
codec, a client and server over real localhost TCP, a true second OS
process (the JAX package's unchanged ``remote_child.py`` and the port's
``torch_remote_child.py``), the BSP contract across the wire, device IO
refused on a proxy, and quantized pushes with error feedback."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.runtime import wire
from multiverso_tpu_torch.updaters import AddOption, GetOption


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


# -- codec -------------------------------------------------------------------

def test_wire_roundtrip_structures():
    cases = [
        None,
        7,
        3.25,
        "hello",
        True,
        [1, 2, 3],
        (None, np.arange(6, dtype=np.int32), AddOption(worker_id=3)),
        {"worker_id": 5, "tables": [{"kind": "array", "size": 8}]},
        {1: 2.5, 7: 3.5},
        GetOption(worker_id=9),
        (np.zeros((4, 3), np.float32), [10, 20], "tail"),
    ]
    for obj in cases:
        blobs = wire.encode(obj)
        out = wire.decode(blobs)
        _assert_tree_equal(obj, out)


def _assert_tree_equal(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (AddOption, GetOption)):
        assert a == b
    else:
        assert a == b, (a, b)


def test_wire_sparse_compression_shrinks_and_roundtrips():
    arr = np.zeros((64, 128), np.float32)
    arr[5, :7] = 1.5
    arr[40, 2] = -2.0
    blobs = wire.encode(arr, compress=True)
    compressed_bytes = sum(np.asarray(b).nbytes for b in blobs)
    assert compressed_bytes < arr.nbytes // 4, compressed_bytes
    np.testing.assert_array_equal(wire.decode(blobs), arr)
    # dense arrays pass through untouched
    dense = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    np.testing.assert_array_equal(wire.decode(wire.encode(dense, compress=True)),
                                  dense)


# -- remote client over real TCP (same process, separate runtime path) -------

def test_remote_array_adds_visible_to_server_and_clients():
    mv.init(remote_workers=2)
    table = mv.create_table("array", 16, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    c1 = mv.remote_connect(endpoint)
    c2 = mv.remote_connect(endpoint)
    assert {c1.worker_id, c2.worker_id} == {1, 2}
    t1 = c1.table(table.table_id)
    t2 = c2.table(table.table_id)
    n = 5
    for _ in range(n):
        t1.add(np.ones(16, np.float32))
        t2.add(np.ones(16, np.float32) * 2)
    expected = np.full(16, n * 3.0, np.float32)
    np.testing.assert_allclose(t1.get(), expected)
    np.testing.assert_allclose(table.get(), expected)  # server-side view
    c1.close()
    c2.close()
    mv.shutdown()


def test_remote_matrix_rows_and_kv():
    mv.init(remote_workers=1)
    matrix = mv.create_table("matrix", 64, 12, np.float32)
    kv = mv.create_table("kv", np.int64)
    endpoint = mv.serve("127.0.0.1:0")

    client = mv.remote_connect(endpoint)
    # directory carries both tables
    kinds = sorted(s["kind"] for s in client.directory)
    assert kinds == ["kv", "matrix"]
    rmat = client.table(matrix.table_id)
    rkv = client.table(kv.table_id)

    ids = np.array([3, 9, 33], np.int32)
    rmat.add(np.full((3, 12), 1.25, np.float32), row_ids=ids)
    np.testing.assert_allclose(rmat.get(ids), np.full((3, 12), 1.25))
    # whole-table get agrees with the server-side worker
    np.testing.assert_allclose(rmat.get(), matrix.get())

    rkv.add([7, 11], [2, 3])
    rkv.add(7, 5)
    assert rkv.get(7) == 7
    assert rkv.get([11])[0] == 3
    whole = rkv.get()
    assert whole == {7: 7, 11: 3}
    client.close()
    mv.shutdown()


def test_remote_async_handles_and_error_reply():
    mv.init(remote_workers=1)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)

    handles = [rt.add_async(np.ones(8, np.float32)) for _ in range(4)]
    for h in handles:
        rt.wait(h)
    np.testing.assert_allclose(rt.get(), np.full(8, 4.0))

    # unknown table id → server-side failure surfaces as a client exception
    with pytest.raises(KeyError):
        client.table(99)
    bad = client.table(table.table_id)
    bad.table_id = 99  # simulate a stale handle
    with pytest.raises(RuntimeError, match="server-side failure"):
        bad.get()
    client.close()
    mv.shutdown()


def test_remote_sparse_matrix_stale_rows():
    """is_sparse staleness tracking works across the wire: a second get
    returns only rows invalidated since."""
    mv.init(remote_workers=1)
    matrix = mv.create_table("matrix", 32, 4, np.float32, is_sparse=True)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rmat = client.table(matrix.table_id)
    assert rmat.is_sparse

    first = rmat.get()  # refreshes the whole client cache
    np.testing.assert_allclose(first, np.zeros((32, 4)))
    rmat.add(np.ones((2, 4), np.float32), row_ids=np.array([5, 9], np.int32))
    second = rmat.get()
    np.testing.assert_allclose(second[5], np.ones(4))
    np.testing.assert_allclose(second[9], np.ones(4))
    np.testing.assert_allclose(second[0], np.zeros(4))
    client.close()
    mv.shutdown()


def test_remote_compressed_hop_end_to_end():
    """A mostly-zero row delta actually crosses the wire in sparse form
    (payload large enough to engage the codec) and lands correctly."""
    delta = np.zeros((8, 32), np.float32)
    delta[2, :5] = 4.0
    tree_blob = wire.encode(delta, compress=True)[0]
    assert b'"sparse"' in bytes(np.asarray(tree_blob, np.uint8))

    mv.init(remote_workers=1)
    matrix = mv.create_table("matrix", 64, 32, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rmat = client.table(matrix.table_id)
    ids = np.arange(8, dtype=np.int32)
    rmat.add(delta, row_ids=ids)
    np.testing.assert_allclose(rmat.get(ids), delta)
    client.close()
    mv.shutdown()


# -- a true second OS process ------------------------------------------------

@pytest.mark.parametrize("child", [["remote_child.py"],
                                   ["torch_remote_child.py", "adds"]],
                         ids=["jax_client", "port_client"])
def test_remote_second_process(child):
    """A second OS process adds to the port's array table: the JAX
    package's own, unchanged client script and the port's twin."""
    mv.init(remote_workers=1)
    table = mv.create_table("array", 16, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    script = os.path.join(os.path.dirname(__file__), child[0])
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(script)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    n, delta = 6, 1.5
    proc = subprocess.run(
        [sys.executable, script] + child[1:] + [endpoint, str(table.table_id),
                                                str(n), str(delta)],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    np.testing.assert_allclose(table.get(), np.full(16, n * delta))
    mv.shutdown()


def test_remote_registration_refused_over_capacity():
    """A client beyond remote_workers is refused (an out-of-range id would
    alias slot-0 per-worker state and bypass BSP clocks)."""
    mv.init(remote_workers=1)
    mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    c1 = mv.remote_connect(endpoint)
    with pytest.raises(RuntimeError, match="registration refused"):
        mv.remote_connect(endpoint)
    c1.close()
    mv.shutdown()


def test_remote_reconnect_recycles_worker_slot():
    """Graceful close frees the worker slot so a reconnecting client fits
    within remote_workers (static membership otherwise, like the reference)."""
    mv.init(remote_workers=1)
    mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    c1 = mv.remote_connect(endpoint)
    wid = c1.worker_id
    c1.close()
    import time
    time.sleep(0.3)  # let the deregister frame land
    c2 = mv.remote_connect(endpoint)
    assert c2.worker_id == wid
    c2.close()
    mv.shutdown()


def test_remote_whole_add_ships_only_nonzero_rows():
    """A remote client's whole-table Add with 3 touched rows crosses the
    wire as exactly 3 rows."""
    mv.init(remote_workers=1)
    t = mv.create_table("matrix", 8, 2, np.float32, is_sparse=True)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.tables()[0]
    seen = []
    orig = t._server_table.process_add
    t._server_table.process_add = lambda req: (seen.append(req[0]), orig(req))[1]
    delta = np.zeros((8, 2), np.float32)
    delta[[0, 4, 7]] = 1.0
    rt.add(delta)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], [0, 4, 7])  # 3 rows, not 8
    np.testing.assert_allclose(t.get(row_ids=[0, 4, 7]), np.ones((3, 2)))
    client.close()
    mv.shutdown()


def test_remote_bogus_deregister_ignored():
    """A deregister for a slot that is not currently leased (src=-1, a local
    worker id, or a replay) must not enter the free list — otherwise two
    later clients could share one worker id."""
    from multiverso_tpu_torch.runtime.message import Message, MsgType
    from multiverso_tpu_torch.runtime.zoo import Zoo
    mv.init(remote_workers=2)
    mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    rs = Zoo.instance().remote_server
    c1 = mv.remote_connect(endpoint)
    rs._handle(Message(src=-1, dst=0, type=MsgType.Control_Deregister,
                       msg_id=1), False)
    rs._handle(Message(src=0, dst=0, type=MsgType.Control_Deregister,
                       msg_id=2), False)
    assert rs._free_slots == []
    c2 = mv.remote_connect(endpoint)
    assert c2.worker_id != c1.worker_id
    c1.close()
    c2.close()
    mv.shutdown()


# -- BSP across the wire -----------------------------------------------------

def test_remote_bsp_contract():
    """Two remote clients are the only workers (server-only role): every
    worker's i-th Get observes exactly i rounds of BOTH workers' Adds."""
    mv.init(sync=True, ps_role="server", remote_workers=2)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    rounds = 4
    results = {}
    errors = []

    def run(idx):
        try:
            client = mv.remote_connect(endpoint)
            rt = client.table(table.table_id)
            out = []
            for _ in range(rounds):
                rt.add(np.ones(8, np.float32))
                out.append(rt.get().copy())
            rt.finish_train()
            results[idx] = out
            client.close()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for t in threads:
        assert not t.is_alive(), "remote BSP deadlock"
    assert not errors, errors
    for idx, outs in results.items():
        for i, val in enumerate(outs):
            np.testing.assert_allclose(
                val, np.full(8, (i + 1) * 2.0, np.float32),
                err_msg=f"client {idx} round {i}")
    mv.shutdown()


def test_remote_bsp_with_serverside_admin_reads():
    """Administrative reads on the serving node (worker id -1: no worker
    role) must NOT consume BSP clock rounds — regression for the deadlock
    where the server-side get aliased remote worker 0."""
    mv.init(sync=True, ps_role="server", remote_workers=1)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    from multiverso_tpu_torch.runtime.zoo import Zoo
    assert Zoo.instance().current_worker_id() == -1

    done = {}

    def run():
        client = mv.remote_connect(endpoint)
        rt = client.table(table.table_id)
        for r in range(3):
            rt.add(np.ones(4, np.float32))
            np.testing.assert_allclose(rt.get(), np.full(4, r + 1.0))
        client.close()
        done["ok"] = True

    t = threading.Thread(target=run)
    t.start()
    # interleave admin reads from the serving node while rounds run
    for _ in range(5):
        table.get()
    t.join(timeout=60)
    assert not t.is_alive(), "admin reads consumed BSP clock rounds (deadlock)"
    assert done.get("ok")
    np.testing.assert_allclose(table.get(), np.full(4, 3.0))
    mv.shutdown()


def test_remote_bsp_client_crash_names_stalled_worker():
    """A crashed remote worker's halted clock used to
    wedge all peers silently. Kill a client mid-round and observe the
    watchdog naming the dead worker; an operator finish_train on its behalf
    releases the survivors."""
    import subprocess
    import time

    from multiverso_tpu_torch.runtime.message import Message, MsgType
    from multiverso_tpu_torch.runtime.zoo import Zoo

    mv.init(sync=True, ps_role="server", remote_workers=2,
            sync_stall_seconds=0.3)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    server = Zoo.instance().server

    child_script = os.path.join(os.path.dirname(__file__),
                                "torch_remote_child.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(child_script)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, child_script, "crash", endpoint, str(table.table_id)],
        stdout=subprocess.PIPE, text=True, env=env)

    survivor_done = {}

    def survivor():
        client = mv.remote_connect(endpoint)
        rt = client.table(table.table_id)
        for _ in range(2):  # round 1 completes with the child; round 2's
            rt.add(np.ones(4, np.float32))  # get blocks on the dead worker
            rt.get()
        survivor_done["ok"] = True
        client.close()

    t = threading.Thread(target=survivor)
    t.start()
    # the child's round-1 get needs the survivor's round-1 add (BSP), so
    # read its id only after the survivor is running
    line = child.stdout.readline().strip()
    assert line.startswith("round-1-done "), line
    dead_wid = int(line.split()[1])
    child.wait(timeout=60)
    assert child.returncode == 9
    deadline = time.monotonic() + 15
    while server.last_stall is None and time.monotonic() < deadline:
        time.sleep(0.05)
    stall = server.last_stall
    assert stall is not None, "watchdog never named the crashed worker"
    assert f"worker(s) [{dead_wid}]" in stall, stall
    # operator recovery: finish the dead worker's training on its behalf
    server.send(Message(src=dead_wid, type=MsgType.Server_Finish_Train,
                        table_id=table.table_id))
    t.join(timeout=60)
    assert not t.is_alive(), "survivor still wedged after finish_train"
    assert survivor_done.get("ok")
    mv.shutdown()


def test_remote_matrix_refuses_device_io():
    """Device IO is the in-process shortcut; a remote proxy must refuse it
    loudly (and advertise supports_device_io=False so PSTrainer falls back
    to the host path) rather than ship device requests over the wire."""
    mv.init(remote_workers=1)
    table = mv.create_table("matrix", 8, 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    assert table.supports_device_io is True
    assert rt.supports_device_io is False
    with pytest.raises(mv.log.FatalError):
        rt.get_device_async(np.array([1, 2], np.int32))
    with pytest.raises(mv.log.FatalError):
        rt.add_device_async(None, np.array([1], np.int32))
    client.close()
    mv.shutdown()


def test_quant_codec_roundtrip_and_native_parity():
    """1/2/4/8-bit quant codec: decode error bounded by step/2, and the
    native C++ packer must be byte-identical to the numpy fallback
    (same contract SparseFilter holds)."""
    from multiverso_tpu_torch.utils import quantization as q

    rng = np.random.default_rng(0)
    for bits in (1, 2, 4, 8):
        for n in (1, 7, 64, 1000):
            x = (rng.normal(size=n) * 3).astype(np.float32)
            via_np = q.quant_encode(x, bits, force_numpy=True)
            payload = q.quant_encode(x, bits)
            if q.native_available():
                assert payload == via_np, f"native != numpy at bits={bits}"
            dec_np = q.quant_decode(via_np, n, force_numpy=True)
            dec = q.quant_decode(payload, n)
            np.testing.assert_array_equal(dec, dec_np)
            step = np.frombuffer(via_np, np.float32, 1, offset=20)[0]
            assert np.abs(dec - x).max() <= step / 2 + 1e-6
        # constant array: step == 0, decodes exactly
        c = np.full(33, 2.5, np.float32)
        np.testing.assert_array_equal(
            q.quant_decode(q.quant_encode(c, bits), 33), c)


def test_quant_wire_compression_ratio_and_error_feedback_convergence():
    """The OneBits slot, completed: remote SGD with
    4-bit quantized pushes + error feedback must (a) shrink ADD payloads
    ~8x and (b) reach the same final loss as uncompressed pushes on the
    same logreg problem."""
    from multiverso_tpu_torch.runtime import wire
    from multiverso_tpu_torch.utils.quantization import QuantizedDelta

    rng = np.random.default_rng(3)
    dim = 32
    X = rng.normal(size=(256, dim)).astype(np.float32)
    true_w = rng.normal(size=dim).astype(np.float32)
    y = (X @ true_w > 0).astype(np.float32)

    def loss_of(w):
        z = X @ w
        p = 1.0 / (1.0 + np.exp(-z))
        eps = 1e-7
        return float(-np.mean(y * np.log(p + eps)
                              + (1 - y) * np.log(1 - p + eps)))

    def train(bits):
        mv.set_flag("wire_quant_bits", bits)
        try:
            mv.init(remote_workers=1)
            table = mv.create_table("array", dim, np.float32)
            endpoint = mv.serve("127.0.0.1:0")
            client = mv.remote_connect(endpoint)
            t = client.table(table.table_id)
            for _ in range(120):
                w = np.asarray(t.get(), np.float32)
                z = X @ w
                p = 1.0 / (1.0 + np.exp(-z))
                grad = X.T @ (p - y) / len(y)
                t.add((-0.5 * grad).astype(np.float32))
            final = np.asarray(t.get(), np.float32)
            client.close()
            return loss_of(final)
        finally:
            mv.shutdown()
            mv.set_flag("wire_quant_bits", 0)

    base = train(0)
    quant = train(4)
    assert quant < base + 0.05, (
        f"4-bit EF training diverged: {quant} vs {base}")

    # measured wire shrinkage on a representative delta payload
    delta = rng.normal(size=(64, 128)).astype(np.float32)
    plain = sum(np.asarray(b).nbytes
                for b in wire.encode((None, delta, None)))
    from multiverso_tpu_torch.utils.quantization import ErrorFeedback
    ef = ErrorFeedback(delta.shape, 4)
    qblobs = wire.encode((None, ef.compress(delta), None))
    qsize = sum(np.asarray(b).nbytes for b in qblobs)
    ratio = plain / qsize
    assert ratio > 6.0, f"4-bit codec only shrank {ratio:.1f}x"
    # and the tagged payload decodes server-side to the dequantized delta
    _, dec, _ = wire.decode(qblobs)
    assert dec.shape == delta.shape
    assert np.abs(dec - delta).max() < np.abs(delta).max()


def test_quant_duplicate_ids_preaggregated_before_error_feedback():
    """A quantized ADD batch with DUPLICATE row ids must apply exactly
    the same update as the equivalent pre-aggregated batch: duplicates
    are merged client-side before ErrorFeedback.compress so each row's
    residual is read and written once (otherwise duplicates
    previously shared one residual read and last-wrote the update,
    permanently losing part of the feedback)."""
    mv.set_flag("wire_quant_bits", 8)
    try:
        mv.init(remote_workers=1)
        ta = mv.create_table("matrix", num_row=4, num_col=3)
        tb = mv.create_table("matrix", num_row=4, num_col=3)
        endpoint = mv.serve("127.0.0.1:0")
        client = mv.remote_connect(endpoint)
        ra, rb = client.table(ta.table_id), client.table(tb.table_id)
        rng = np.random.default_rng(7)
        vals = rng.normal(size=(5, 3)).astype(np.float32)
        dup_ids = np.array([0, 2, 0, 1, 2], np.int32)
        ra.add(vals, row_ids=dup_ids)
        merged = np.zeros((3, 3), np.float32)
        np.add.at(merged, dup_ids, vals)
        rb.add(merged, row_ids=np.array([0, 1, 2], np.int32))
        np.testing.assert_array_equal(np.asarray(ra.get()),
                                      np.asarray(rb.get()))
        client.close()
    finally:
        mv.shutdown()
        mv.set_flag("wire_quant_bits", 0)
