"""The port's overload layer (``runtime/admission.py``, the deadline
field, ``fault/retry.py``'s retry budget and circuit breaker, the stall
chaos mode, ``utils/backoff.py``): the cases of ``tests/test_overload.py``
on ``multiverso_tpu_torch``, against the port's server, client and
dispatcher — deadline arithmetic across processes, priority lanes, the
admission gate, tenant quotas, shed Adds dropped and not errored, tenant
isolation and the breaker. The train-while-serve drill runs a shard
group (``shard/``), which is not ported yet."""

import os
import random
import threading
import time

import numpy as np
import pytest

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.fault.retry import CircuitBreaker, RetryBudget
from multiverso_tpu_torch.runtime.admission import (AdmissionGate, TenantQuotas,
                                              lane_of, lane_order,
                                              LANE_CONTROL, LANE_SERVING,
                                              LANE_TRAINING)
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.utils.backoff import Backoff, full_jitter


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


# -- backoff helper (satellite: unified retry loops) --------------------------

def test_full_jitter_bounds():
    rng = random.Random(0)
    for attempt, ceiling in ((1, 0.1), (2, 0.2), (3, 0.4), (10, 1.0)):
        for _ in range(50):
            d = full_jitter(0.1, 1.0, attempt, rng)
            assert ceiling * 0.5 <= d <= ceiling, (attempt, d)


def test_backoff_deadline_stops_sequence():
    bo = Backoff(base=0.01, cap=0.02,
                 deadline=time.monotonic() + 0.08)
    waits = 0
    while bo.wait():
        waits += 1
        assert waits < 50
    assert waits >= 1
    assert bo.remaining() <= 0.08


def test_backoff_budget_denial_stops_sequence():
    budget = RetryBudget(tokens=2.0, ratio=0.1)
    bo = Backoff(base=0.001, cap=0.002, budget=budget)
    assert bo.wait() and bo.wait()  # two tokens
    before = Dashboard.counter_value("RETRY_BUDGET_DENIALS")
    assert not bo.wait()            # bucket dry: sequence ends, no sleep
    assert Dashboard.counter_value("RETRY_BUDGET_DENIALS") == before + 1


def test_backoff_cancel_event():
    cancel = threading.Event()
    bo = Backoff(base=5.0, cap=5.0, cancel=cancel)
    threading.Timer(0.05, cancel.set).start()
    t0 = time.monotonic()
    assert not bo.wait()  # cancelled mid-sleep, long before 2.5s+
    assert time.monotonic() - t0 < 2.0


# -- retry budget + circuit breaker -------------------------------------------

def test_retry_budget_spend_refill_denial():
    budget = RetryBudget(tokens=2.0, ratio=0.5)
    assert budget.enabled
    assert budget.allow() and budget.allow()
    denials0 = Dashboard.counter_value("RETRY_BUDGET_DENIALS")
    assert not budget.allow()
    assert Dashboard.counter_value("RETRY_BUDGET_DENIALS") == denials0 + 1
    budget.on_success()  # +0.5: still under one token
    assert not budget.allow()
    budget.on_success()  # 1.0: one retry earned back
    assert budget.allow()
    # disabled budget (cap 0, the default posture) is unlimited
    assert not RetryBudget(tokens=0.0).enabled
    assert all(RetryBudget(tokens=0.0).allow() for _ in range(100))


def test_circuit_breaker_trip_halfopen_recover():
    br = CircuitBreaker(failures=3, reset_seconds=0.1)
    assert br.enabled and br.allow()
    trips0 = Dashboard.counter_value("BREAKER_TRIPS")
    br.record_failure()
    br.record_failure()
    assert br.allow()       # under threshold: still closed
    br.record_failure()     # third consecutive: trips
    assert br.is_open and not br.allow()
    assert Dashboard.counter_value("BREAKER_TRIPS") == trips0 + 1
    time.sleep(0.12)
    assert br.allow()       # exactly one half-open probe
    assert not br.allow()   # a second concurrent probe is refused
    br.record_success()     # probe came back: closed
    assert not br.is_open and br.allow()
    # re-trip, then a FAILED half-open probe re-opens without a fresh streak
    for _ in range(3):
        br.record_failure()
    time.sleep(0.12)
    assert br.allow()
    br.record_failure()
    assert br.is_open and not br.allow()
    # success streak reset: two failures, a success, two more never trip
    ok = CircuitBreaker(failures=3, reset_seconds=1.0)
    ok.record_failure(), ok.record_failure(), ok.record_success()
    ok.record_failure(), ok.record_failure()
    assert not ok.is_open
    # disabled (failures=0, the default posture) never opens
    off = CircuitBreaker(failures=0)
    for _ in range(10):
        off.record_failure()
    assert not off.enabled and off.allow()


# -- lanes --------------------------------------------------------------------

def _msg(mtype, src=5, req_id=1, table_id=0, deadline=0.0, data=()):
    return Message(src=src, dst=0, type=mtype, table_id=table_id,
                   msg_id=req_id, req_id=req_id, deadline=deadline,
                   data=list(data))


def test_lane_of_classification():
    # the read tier's slot-free forwards (src < 0) are the serving lane
    assert lane_of(_msg(MsgType.Request_Get, src=-1)) == LANE_SERVING
    # a WORKER's Get shares the training lane with its Adds: the stable
    # sort must never reorder a worker's Get ahead of its earlier Adds
    assert lane_of(_msg(MsgType.Request_Get, src=3)) == LANE_TRAINING
    assert lane_of(_msg(MsgType.Request_Add, src=3)) == LANE_TRAINING
    assert lane_of(_msg(MsgType.Control_Heartbeat)) == LANE_CONTROL
    # barrier-semantics messages must NOT be lifted over the writes they
    # fence: Server_Execute is a documented full barrier (checkpoint and
    # multihost quiesce ride it), so it shares the training lane and the
    # stable sort keeps it behind every Add queued ahead of it
    assert lane_of(_msg(MsgType.Server_Execute)) == LANE_TRAINING
    assert lane_of(_msg(MsgType.Control_Cut)) == LANE_TRAINING
    assert lane_of(_msg(MsgType.Control_Migrate_Cutover)) == LANE_TRAINING


def test_lane_order_stable_per_worker_fifo():
    add1 = _msg(MsgType.Request_Add, src=3, req_id=1)
    add2 = _msg(MsgType.Request_Add, src=3, req_id=2)
    get3 = _msg(MsgType.Request_Get, src=3, req_id=3)
    serve = _msg(MsgType.Request_Get, src=-1, req_id=4)
    ctrl = _msg(MsgType.Control_Heartbeat, req_id=5)
    ordered = lane_order([add1, add2, get3, serve, ctrl])
    # serving read first, control next, training batch untouched inside
    assert ordered == [serve, ctrl, add1, add2, get3]


# -- admission gate + tenant quotas -------------------------------------------

class _Completion:
    def __init__(self):
        self.error = None
        self.result = "unset"

    def fail(self, exc):
        self.error = exc

    def done(self, value):
        self.result = value


def test_admission_gate_sheds_lowest_lane_first():
    gate = AdmissionGate(queue_limit=10)
    add = _msg(MsgType.Request_Add)
    get = _msg(MsgType.Request_Get)
    assert gate.refusal(add, depth=5) is None
    text = gate.refusal(add, depth=11)
    assert text is not None and text.startswith("shed:")
    # serving Gets brown out only at 4x the training limit
    assert gate.refusal(get, depth=11) is None
    assert gate.refusal(get, depth=41) is not None
    # in-process requests (req_id == 0) are NEVER shed: no retry path
    local = _msg(MsgType.Request_Add, req_id=0)
    assert gate.refusal(local, depth=10_000) is None


def test_tenant_quota_parse_and_isolation():
    quotas = TenantQuotas.parse(
        "ctr:tables=0|1,qps=0.001,burst=2;ranker:tables=2,qps=1000")
    # ctr burns its 2-token burst, then sheds — on BOTH its tables
    assert quotas.refusal(0) is None and quotas.refusal(1) is None
    text = quotas.refusal(0)
    assert text is not None and "ctr" in text and text.startswith("shed:")
    # ranker (own bucket) and the unmetered table 9 are untouched
    assert quotas.refusal(2) is None
    assert quotas.refusal(9) is None
    assert Dashboard.counter_value("TENANT_ctr_SHED") >= 1
    assert Dashboard.counter_value("TENANT_ranker_ADMITTED") == 1
    for bad in ("nocolon", "t:qps=5", "t:tables=0",
                "t:tables=0,qps=1,bogus=2",
                "a:tables=0,qps=1;b:tables=0,qps=1"):
        with pytest.raises(mv.log.FatalError):
            TenantQuotas.parse(bad)


# -- deadline arithmetic ------------------------------------------------------

def _wire_roundtrip(msg):
    """Encode one message through the real wire framing and decode it
    from the byte stream — the exact cross-process path, minus the
    socket (so the test can also fake clock skew deterministically)."""
    import io
    from multiverso_tpu_torch.runtime import net as netmod
    net = netmod.TcpNet.__new__(netmod.TcpNet)
    segments, _nbytes = net._frame_segments(msg, 0)
    stream = io.BytesIO(b"".join(bytes(s) for s in segments))
    out = net._read_frame(lambda n: stream.read(n), set())
    assert out is not None, "frame failed CRC on the loopback path"
    return out


def test_wire_deadline_monotonic_across_processes():
    """The frame carries a REMAINING budget, not an absolute instant:
    the receiver re-anchors on its own monotonic clock, so any wall or
    monotonic clock offset between the two processes is irrelevant."""
    budget = 0.5
    msg = _msg(MsgType.Request_Add, deadline=time.monotonic() + budget)
    out = _wire_roundtrip(msg)
    left = out.deadline - time.monotonic()
    assert 0.3 < left <= budget + 0.01, left


def test_wire_deadline_zero_is_preserved_as_none():
    out = _wire_roundtrip(_msg(MsgType.Request_Add, deadline=0.0))
    assert out.deadline == 0.0


def test_wire_deadline_expired_at_encode_ships_floor():
    """A deadline that expired before encode still ships (1µs floor):
    the RECEIVER's drain refuses it with the truthful deadline_exceeded
    answer — silently vanishing frames would look like loss."""
    out = _wire_roundtrip(
        _msg(MsgType.Request_Add, deadline=time.monotonic() - 5.0))
    assert 0.0 < out.deadline <= time.monotonic() + 0.001


def _make_server():
    from multiverso_tpu_torch.runtime.server import Server
    server = Server.__new__(Server)
    server.admission = AdmissionGate.from_flags()
    server._queue = type("Q", (), {"size": staticmethod(lambda: 0)})()
    return server


def test_drain_drops_expired_deadline_mid_queue():
    server = _make_server()
    done = _Completion()
    expired = _msg(MsgType.Request_Add,
                   deadline=time.monotonic() - 0.2, data=[done])
    live_done = _Completion()
    live = _msg(MsgType.Request_Add,
                deadline=time.monotonic() + 30.0, data=[live_done])
    drops0 = Dashboard.counter_value("DEADLINE_EXPIRED_DROPS")
    admitted = server._admit([expired, live])
    assert admitted == [live] and live_done.error is None
    assert Dashboard.counter_value("DEADLINE_EXPIRED_DROPS") == drops0 + 1
    assert done.error is not None
    assert done.error.wire_text.startswith("deadline_exceeded:")


def test_drain_never_refuses_legacy_deadline_zero():
    """Legacy peers (and flag-off clients) stamp no deadline — the 0.0
    sentinel must sail through the drain untouched, forever."""
    server = _make_server()
    msgs = [_msg(MsgType.Request_Add, deadline=0.0, data=[_Completion()]),
            _msg(MsgType.Request_Get, deadline=0.0, data=[_Completion()])]
    assert server._admit(msgs) == msgs


def test_client_fails_expired_at_send_without_wire_trip():
    """A deadline already gone at submit time fails locally — no frame,
    no round trip, no inflight entry."""
    mv.init(remote_workers=1)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(4, np.float32))  # live baseline: the path works

    from multiverso_tpu_torch.runtime.message import next_msg_id
    from multiverso_tpu_torch.tables.base import Completion
    completion = Completion()
    expired0 = Dashboard.counter_value("DEADLINE_EXPIRED_AT_SEND")
    req = client._send(table.table_id, MsgType.Request_Add,
                       (np.ones(4, np.float32), None), next_msg_id(),
                       completion, deadline=time.monotonic() - 1.0)
    assert req == 0
    assert Dashboard.counter_value("DEADLINE_EXPIRED_AT_SEND") \
        == expired0 + 1
    with pytest.raises(RuntimeError, match="deadline_exceeded"):
        completion.wait(timeout=5.0)
    assert not client._inflight
    # and the expired Add never applied
    np.testing.assert_array_equal(np.asarray(rt.get()),
                                  np.ones(4, np.float32))
    client.close()
    mv.shutdown()


# -- graceful shedding end to end ---------------------------------------------

def test_shed_add_is_dropped_not_errored():
    """A tenant-quota shed comes home as ``Reply_Error "shed: ..."`` and
    the client completes the Add as a DROPPED update: rt.wait() returns,
    CLIENT_ADDS_SHED counts it, the table shows only admitted deltas."""
    mv.set_flag("tenant_quota_spec", "train:tables=0,qps=0.001,burst=2")
    mv.init(remote_workers=1)
    table = mv.create_table("array", 8, np.float32)
    assert table.table_id == 0
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(0)
    handles = [rt.add_async(np.ones(8, np.float32)) for _ in range(6)]
    for h in handles:
        rt.wait(h)  # sheds settle as done(None): nothing raises
    shed = Dashboard.counter_value("CLIENT_ADDS_SHED")
    assert shed == 4, "burst=2 should admit exactly 2 of 6 Adds"
    assert Dashboard.counter_value("SHED_ADDS") == shed
    assert Dashboard.counter_value("TENANT_train_SHED") == shed
    np.testing.assert_array_equal(np.asarray(rt.get()),
                                  np.full(8, 2.0, np.float32))
    client.close()
    mv.shutdown()


def test_tenant_quota_cannot_starve_another_tenant():
    """Tenant 'greedy' exhausting its bucket sheds ONLY its own writes:
    tenant 'steady' (and the serving lane) see zero refusals."""
    mv.set_flag("tenant_quota_spec",
                "greedy:tables=0,qps=0.001,burst=1;"
                "steady:tables=1,qps=10000,burst=100")
    mv.init(remote_workers=1)
    t0 = mv.create_table("array", 4, np.float32)
    t1 = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt0, rt1 = client.table(t0.table_id), client.table(t1.table_id)
    for _ in range(5):
        rt0.add(np.ones(4, np.float32))
        rt1.add(np.ones(4, np.float32))
    assert Dashboard.counter_value("TENANT_greedy_SHED") == 4
    assert Dashboard.counter_value("TENANT_steady_SHED") == 0
    assert Dashboard.counter_value("SHED_GETS") == 0
    np.testing.assert_array_equal(np.asarray(rt1.get()),
                                  np.full(4, 5.0, np.float32))
    np.testing.assert_array_equal(np.asarray(rt0.get()),
                                  np.ones(4, np.float32))
    client.close()
    mv.shutdown()


def test_breaker_fast_fails_writes_then_recovers():
    """A tripped breaker fails new writes fast with the truthful
    'circuit open' error; after reset_seconds the half-open probe rides
    a real request and a correlated reply closes it again."""
    mv.set_flag("breaker_failures", 3)
    mv.set_flag("breaker_reset_seconds", 0.15)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 4, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(np.ones(4, np.float32))
    for _ in range(3):  # silence (overdue replies / connection loss)
        client._breaker.record_failure()
    assert client._breaker.is_open
    fails0 = Dashboard.counter_value("BREAKER_FAST_FAILS")
    with pytest.raises(RuntimeError, match="circuit open"):
        rt.add(np.ones(4, np.float32))
    assert Dashboard.counter_value("BREAKER_FAST_FAILS") == fails0 + 1
    time.sleep(0.2)
    rt.add(np.ones(4, np.float32))  # the half-open probe, answered
    assert not client._breaker.is_open
    np.testing.assert_array_equal(np.asarray(rt.get()),
                                  np.full(4, 2.0, np.float32))
    client.close()
    mv.shutdown()


# -- stall gray-failure chaos (satellite) -------------------------------------

def test_parse_stall_rule():
    from multiverso_tpu_torch.fault.inject import parse_fault_spec
    rules = parse_fault_spec("stall:type=Reply_Add,seconds=0.3")
    assert rules[0].action == "stall" and rules[0].seconds == 0.3


def test_stall_drips_frames_in_order_head_of_line():
    """Stalled frames queue per destination and release ONE per
    interval, preserving order — slow-but-alive, not dead."""
    from multiverso_tpu_torch.fault.inject import (ChaosNet, FaultInjector,
                                             parse_fault_spec)
    net = ChaosNet(FaultInjector(
        parse_fault_spec("stall:type=Request_Add,seconds=0.05")))
    sent = []
    order_done = threading.Event()

    def fake_send(i):
        def send():
            sent.append(i)
            if len(sent) == 3:
                order_done.set()
        return send

    for i in range(3):
        net._stall(("rank", 0), fake_send(i), 0.05)
    assert sent == [], "stall must defer, not pass through"
    assert order_done.wait(5.0)
    assert sent == [0, 1, 2]
    # the drip queue drained itself: the per-key timer chain ends when
    # the FIFO empties, so there is nothing left to tear down
    with net._stall_lock:
        assert not net._stalled.get(("rank", 0))


def test_stall_slow_peer_survives_end_to_end():
    """A stalled (slow-but-alive) reply path: every Add still applies
    exactly once — retransmits ride the dedup window, the drip delivers
    late instead of never."""
    mv.set_flag("fault_spec", "stall:type=Reply_Add,every=3,seconds=0.2")
    mv.set_flag("fault_seed", 7)
    mv.set_flag("request_retry_seconds", 0.3)
    mv.set_flag("apply_batch_msgs", 0)
    mv.init(remote_workers=1)
    table = mv.create_table("array", 8, np.float32)
    endpoint = mv.serve("127.0.0.1:0")
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    handles = [rt.add_async(np.ones(8, np.float32)) for _ in range(12)]
    for h in handles:
        rt.wait(h)
    np.testing.assert_array_equal(np.asarray(rt.get()),
                                  np.full(8, 12.0, np.float32))
    assert Dashboard.counter_value("FAULT_INJECTED_STALL") > 0
    client.close()
    mv.shutdown()
