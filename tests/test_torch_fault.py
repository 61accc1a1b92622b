"""The port's fault core (``fault/``): the cases of ``tests/test_fault.py``
on ``multiverso_tpu_torch`` — the fault-spec parser, retry and liveness
units, exactly-once Adds under seeded drop/dup/reorder/partition chaos
(bit for bit the fault-free table, through the server's dedup window),
reconnect and resume, and a worker killed mid-round evicted under BSP and
SSP. The child processes are the port's own
(``tests/torch_remote_child.py``)."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.fault.inject import FaultRule, parse_fault_spec
from multiverso_tpu_torch.fault.retry import RetryPolicy
from multiverso_tpu_torch.fault.detector import LivenessDetector
from multiverso_tpu_torch.runtime.zoo import Zoo

SEED = int(os.environ.get("CHAOS_SEED", "7"))


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


# -- units -------------------------------------------------------------------

def test_parse_fault_spec():
    from multiverso_tpu_torch.runtime.message import MsgType
    rules = parse_fault_spec(
        "drop:type=Request_Add,dst=0,first=2 ; "
        "delay:type=Reply_Get,prob=0.5,seconds=0.2;"
        "dup:every=3,after=1;partition:src=1,dst=0")
    assert [r.action for r in rules] == ["drop", "delay", "dup", "partition"]
    assert rules[0].type == MsgType.Request_Add and rules[0].first == 2
    assert rules[1].prob == 0.5 and rules[1].seconds == 0.2
    assert rules[2].every == 3 and rules[2].after == 1
    assert rules[3].src == 1 and rules[3].dst == 0
    with pytest.raises(mv.log.FatalError):
        parse_fault_spec("explode:dst=0")
    with pytest.raises(mv.log.FatalError):
        parse_fault_spec("drop:bogus_key=1")


def test_fault_rule_limiters():
    import random
    from multiverso_tpu_torch.runtime.message import Message
    rng = random.Random(0)
    rule = FaultRule(action="drop", after=1, every=2)
    fired = []
    for _ in range(8):
        assert rule.matches(Message())
        rule.seen += 1
        fired.append(rule.applies(rng))
    # matches 2,4,6,8 relative to `after=1` -> absolute frames 3,5,7
    assert fired == [False, False, True, False, True, False, True, False]


def test_retry_policy_backoff_and_deadline():
    import random
    policy = RetryPolicy(base=0.1, cap=1.0, deadline=60.0,
                         rng=random.Random(0))
    assert policy.backoff(0) == 0.0
    for attempt, lo_hi in ((1, (0.05, 0.1)), (2, (0.1, 0.2)),
                           (3, (0.2, 0.4)), (10, (0.5, 1.0))):
        d = policy.backoff(attempt)
        assert lo_hi[0] <= d <= lo_hi[1], (attempt, d)
    # deadline=0 is the fail-fast escape hatch: zero attempts
    assert list(RetryPolicy(deadline=0.0).attempts()) == []
    # a finite deadline stops the sequence
    fast = RetryPolicy(base=0.01, cap=0.02, deadline=0.15)
    attempts = [a for a, _ in fast.attempts()]
    assert attempts and attempts[0] == 0 and len(attempts) < 50


def test_liveness_detector_lease_cycle():
    det = LivenessDetector(lease_seconds=0.2)
    det.register(3)
    det.register(4)
    det.beat(99)  # unknown id: ignored, must not resurrect anything
    assert det.tracked() == [3, 4]
    assert det.reap() == []
    for _ in range(6):  # worker 4 keeps beating, worker 3 goes silent
        time.sleep(0.06)
        det.beat(4)
    assert det.reap() == [3]
    assert det.reap() == []  # reported exactly once
    assert det.is_evicted(3) and not det.is_evicted(4)
    det.beat(3)  # a zombie frame cannot resurrect the lease
    assert det.reap() == []
    det.forget(4)
    assert det.tracked() == []
    # disabled leases never expire
    immortal = LivenessDetector(lease_seconds=0.0)
    immortal.register(1)
    assert immortal.reap() == []


def test_dashboard_counters():
    from multiverso_tpu_torch.dashboard import count
    count("TEST_EVENT")
    count("TEST_EVENT", 2)
    assert Dashboard.counter_value("TEST_EVENT") == 3
    assert Dashboard.counter_value("NEVER_TOUCHED") == 0
    assert "Counter(TEST_EVENT: 3)" in Dashboard.display()


# -- exactly-once Adds under chaos (acceptance) ------------------------------

def _push_deltas(fault_spec):
    """One full remote session pushing a fixed delta sequence; returns
    (final table bytes, number of server-side process_add calls).
    CHAOS_EXTRA_SPEC (CI matrix) appends rules to every non-empty
    schedule — e.g. a corrupt-mode run layering bit-flips on top."""
    if fault_spec:
        fault_spec += os.environ.get("CHAOS_EXTRA_SPEC", "")
        mv.set_flag("fault_spec", fault_spec)
        mv.set_flag("fault_seed", SEED)
    mv.set_flag("request_retry_seconds", 0.3)
    # per-message dispatch: this harness pins "one process_add call per
    # Add" — the retry/dedup layer's invariant. The fused apply path
    # folds concurrent Adds into fewer calls by design; its exactly-once
    # story is covered by tests/test_apply_batch.py and the mid_batch
    # crash point in tests/test_durable.py.
    mv.set_flag("apply_batch_msgs", 0)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 16, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    applied = []
    orig = table._server_table.process_add
    table._server_table.process_add = (
        lambda req: (applied.append(1), orig(req))[1])
    # integer-valued float32 deltas: sums are exact, so the bit-for-bit
    # comparison is robust to apply-order changes from retransmission
    rng = np.random.default_rng(0)
    deltas = rng.integers(-4, 5, size=(24, 16)).astype(np.float32)
    handles = [rt.add_async(d) for d in deltas]
    for h in handles:
        rt.wait(h)
    final = np.asarray(rt.get(), np.float32)
    client.close()
    mv.shutdown()
    return final, len(applied)


def test_chaos_adds_apply_exactly_once():
    """Seeded drop+dup schedule on Add and reply frames: every delta lands
    exactly once; the final table is bit-for-bit the no-fault result."""
    plain, n_plain = _push_deltas("")
    assert n_plain == 24
    chaos, n_chaos = _push_deltas(
        "drop:type=Request_Add,every=3;dup:type=Request_Add,every=4;"
        "drop:type=Reply_Add,every=5;dup:type=Reply_Add,every=2")
    assert n_chaos == 24, "a dropped or duplicated Add broke exactly-once"
    np.testing.assert_array_equal(chaos, plain)
    assert Dashboard.counter_value("SERVER_DEDUP_HITS") > 0
    assert Dashboard.counter_value("CLIENT_RETRIES") > 0
    assert Dashboard.counter_value("FAULT_INJECTED_DROP") > 0
    assert Dashboard.counter_value("FAULT_INJECTED_DUP") > 0


def test_chaos_delay_and_reorder_preserve_results():
    """Delay and reorder rules perturb timing/ordering but not totals."""
    plain, _ = _push_deltas("")
    chaos, n = _push_deltas(
        "delay:type=Reply_Add,every=4,seconds=0.05;"
        "reorder:type=Request_Add,every=5,seconds=0.1")
    assert n == 24
    np.testing.assert_array_equal(chaos, plain)


def test_chaos_bsp_contract_survives_drops():
    """BSP across a lossy wire: round gating + idempotent replay still
    give every worker's i-th Get exactly i rounds of both workers' Adds."""
    mv.set_flag("fault_spec",
                "drop:type=Request_Add,every=5;drop:type=Reply_Get,every=4")
    mv.set_flag("fault_seed", SEED)
    mv.set_flag("request_retry_seconds", 0.3)
    mv.init(sync=True, ps_role="server", remote_workers=2)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    rounds, results, errors = 3, {}, []

    def run(idx):
        try:
            client = mv.remote_connect(endpoint)
            rt = client.table(table.table_id)
            out = []
            for _ in range(rounds):
                rt.add(np.ones(8, np.float32))
                out.append(np.asarray(rt.get()).copy())
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
        assert not t.is_alive(), "remote BSP deadlock under chaos"
    assert not errors, errors
    for idx, outs in results.items():
        for i, val in enumerate(outs):
            np.testing.assert_allclose(
                val, np.full(8, (i + 1) * 2.0, np.float32),
                err_msg=f"client {idx} round {i}")
    mv.shutdown()


# -- liveness: dead workers are evicted from the sync gates (acceptance) -----

@pytest.mark.parametrize("mode", ["bsp", "ssp"])
def test_dead_worker_evicted_run_completes(mode):
    """One worker killed mid-round: the survivor completes via lease-based
    eviction — no operator intervention, no deadlock."""
    flags = dict(ps_role="server", remote_workers=2, sync_stall_seconds=0.2,
                 lease_seconds=1.0, heartbeat_seconds=0.2)
    if mode == "bsp":
        flags["sync"] = True
    else:
        flags["ssp_staleness"] = 0
    mv.init(**flags)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")

    child_script = os.path.join(os.path.dirname(__file__),
                                "torch_remote_child.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(child_script)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, child_script, "crash", endpoint, str(table.table_id)],
        stdout=subprocess.PIPE, text=True, env=env)

    done = {}

    def survivor():
        client = mv.remote_connect(endpoint)
        rt = client.table(table.table_id)
        for _ in range(3):
            rt.add(np.ones(4, np.float32))
            rt.get()
        done["ok"] = True
        client.close()

    t = threading.Thread(target=survivor)
    t.start()
    line = child.stdout.readline().strip()
    assert line.startswith("round-1-done "), line
    dead_wid = int(line.split()[1])
    child.wait(timeout=60)
    assert child.returncode == 9
    t.join(timeout=60)
    assert not t.is_alive(), f"{mode} survivor still wedged after crash"
    assert done.get("ok")
    assert Dashboard.counter_value("WORKER_EVICTIONS") >= 1
    assert Zoo.instance().remote_server.liveness.is_evicted(dead_wid)
    mv.shutdown()


def test_evicted_worker_cannot_resume():
    """An evicted worker's clock history is retired: a resume claim for
    the slot is refused, and its own deferred requests were already failed
    with the eviction error."""
    mv.init(sync=True, ps_role="server", remote_workers=2,
            sync_stall_seconds=0.1, lease_seconds=0.4, heartbeat_seconds=0.1)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    wid = client.worker_id
    errors = []

    def blocked_round():
        try:
            rt.add(np.ones(4, np.float32))
            rt.get()  # defers: the second remote slot never registers
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    t = threading.Thread(target=blocked_round)
    t.start()
    time.sleep(0.2)
    client._stop_maint.set()  # freeze the client: heartbeats stop
    t.join(timeout=30)
    assert not t.is_alive(), "eviction never released the frozen worker"
    assert errors and "evicted" in repr(errors[0])
    rs = Zoo.instance().remote_server
    assert rs.liveness.is_evicted(wid)

    class _FakeMsg:
        _conn = object()

    refusal = rs._resume_slot(session=12345, resume=wid, msg=_FakeMsg())
    assert refusal is not None and "evicted" in refusal
    client.close()
    mv.shutdown()


# -- retry/replay mechanics --------------------------------------------------

def test_registration_survives_dropped_reply():
    """A dropped Control_Reply_Register frame: the client re-sends its
    (idempotent) registration and the server answers from the dedup cache
    — exactly one worker slot is consumed."""
    mv.set_flag("fault_spec", "drop:type=Control_Reply_Register,first=1")
    mv.set_flag("fault_seed", SEED)
    mv.init(remote_workers=2)
    mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rs = Zoo.instance().remote_server
    assert client.worker_id >= 0
    assert rs._next_remote == 1, "replayed registration double-allocated"
    assert Dashboard.counter_value("SERVER_DEDUP_HITS") >= 1
    client.close()
    mv.shutdown()


def _sever_server_connections(rs):
    """Simulate a peer-visible connection loss: close every accepted data
    connection AND any shm channel riding on one — a ring segment does
    not die with a TCP FIN (only with its peer process), so a 'network
    blip' against an shm-negotiated client must sever both."""
    net = rs._net
    with net._conn_lock:
        channels = list(net._shm_channels.values())
        net._shm_channels.clear()
    for ch in channels:
        ch.close()
    for conn in list(net._accepted):
        conn.close()


def test_client_reconnects_and_resumes_after_connection_loss():
    """A network blip (every server-side connection severed): the client
    reconnects under the same session, keeps its worker id, and the
    interrupted request is retransmitted — nothing is lost or doubled."""
    mv.set_flag("reconnect_deadline_seconds", 15.0)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(8, np.float32))
    wid = client.worker_id
    rs = Zoo.instance().remote_server
    _sever_server_connections(rs)
    time.sleep(0.2)
    rt.add(np.ones(8, np.float32))  # rides the recovered connection
    np.testing.assert_allclose(np.asarray(rt.get()), np.full(8, 2.0))
    assert client.worker_id == wid
    assert Dashboard.counter_value("CLIENT_RECONNECTS") >= 1
    client.close()
    mv.shutdown()


def test_server_restart_with_checkpoint_restore():
    """Full server-restart recovery: snapshot, kill the remote server,
    restore tables from the latest checkpoint, re-serve the same endpoint
    — the client resumes its slot and its traffic continues seamlessly."""
    from multiverso_tpu_torch import checkpoint
    mv.set_flag("reconnect_deadline_seconds", 20.0)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    host, port = endpoint.rsplit(":", 1)
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    for _ in range(3):
        rt.add(np.ones(8, np.float32))
    ckdir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                         f"mv_fault_ck_{os.getpid()}")
    driver = checkpoint.CheckpointDriver([table], ckdir)
    driver.snapshot()
    wid = client.worker_id

    mv.stop_serving()  # the "crash"
    with Zoo.instance().admin():  # play a fresh process's empty table
        table.add(np.full(8, -3.0, np.float32))
        np.testing.assert_allclose(np.asarray(table.get()), np.zeros(8))
    assert checkpoint.restore_tables([table], ckdir) == 1  # the restart
    assert mv.serve(f"{host}:{port}") == endpoint

    rt.add(np.ones(8, np.float32))  # client reconnects + resumes here
    np.testing.assert_allclose(np.asarray(rt.get()), np.full(8, 4.0))
    assert client.worker_id == wid
    client.close()
    driver.close()
    mv.shutdown()


def test_server_killed_client_surfaces_clean_error():
    """Server-side kill mid-session (the mirror of remote_crash_child):
    when the server never comes back, the client's pending requests fail
    with a clean ConnectionError once the reconnect deadline passes —
    no hang, no stack-less stall."""
    child_script = os.path.join(os.path.dirname(__file__),
                                "torch_remote_child.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(child_script)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, child_script, "serve"],
                             stdout=subprocess.PIPE, text=True, env=env)
    try:
        line = child.stdout.readline().strip()
        assert line.startswith("serving "), line
        _, endpoint, table_id = line.split()

        mv.set_flag("reconnect_deadline_seconds", 2.0)
        mv.set_flag("retry_base_seconds", 0.05)
        client = mv.remote_connect(endpoint)
        rt = client.table(int(table_id))
        rt.add(np.ones(16, np.float32))
        np.testing.assert_allclose(np.asarray(rt.get()), np.ones(16))

        child.kill()  # SIGKILL: no deregister, no FIN handshake niceties
        child.wait(timeout=30)
        errors = []

        def doomed():
            try:
                rt.get()
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        t = threading.Thread(target=doomed)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "client hung instead of failing cleanly"
        assert errors, "get() succeeded against a dead server?"
        assert isinstance(errors[0], ConnectionError), errors
        assert "reconnect gave up" in str(errors[0])
        client.close()
    finally:
        if child.poll() is None:
            child.kill()


def test_fail_fast_flag_restores_old_posture():
    """reconnect_deadline_seconds=0: a connection loss fails pending
    requests immediately — the pre-fault-subsystem contract, for
    deployments that prefer crash-fast supervision."""
    mv.set_flag("reconnect_deadline_seconds", 0.0)
    mv.set_flag("heartbeat_seconds", 0.0)
    mv.set_flag("request_retry_seconds", 0.0)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(4, np.float32))
    # slow server gets: requests stay genuinely in flight, so the sever
    # is guaranteed to catch pending ones — fail-fast means exactly
    # those fail (an empty pending set failing "immediately" is vacuous)
    orig_get = table._server_table.process_get
    table._server_table.process_get = (
        lambda req: (time.sleep(0.1), orig_get(req))[1])
    errors = []
    handles = []

    def sender():
        # NEVER waits: post-sever sends are what lets the TCP posture
        # detect the loss (the shm transport detects it via the ring
        # flags on its own); get_async swallows send errors into the
        # recovery path, which with deadline 0 is immediate fail-all
        for _ in range(30):
            handles.append(rt.get_async())
            time.sleep(0.02)

    t = threading.Thread(target=sender)
    t.start()
    time.sleep(0.1)
    _sever_server_connections(Zoo.instance().remote_server)
    t.join(timeout=20)
    assert not t.is_alive()
    try:
        for h in handles:
            rt.wait(h)
    except (ConnectionError, RuntimeError) as exc:
        errors.append(exc)
    assert errors, "no pending request failed fast on connection loss"
    client.close()
    mv.shutdown()
