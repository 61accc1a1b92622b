"""The port's read-replica serving tier (``multiverso_tpu_torch/durable/
standby.py``'s read server, ``runtime/read.py``'s client tier): the cases
of ``tests/test_replica.py`` on the port, against
``tests/torch_durable_primary_child.py``, and the sharded replica fleet
on a port shard group (``shard/``).

* bounded staleness: no reply is staler than the budget relative to the
  primary's WAL append watermark, with a held-back tail and with
  chaos-dropped replication frames (gap-resync);
* the cache: lease + watermark invalidation, LRU byte cap, epoch flush;
* hedged reads: the second fire wins, the loser is cancelled;
* interop: a JAX-package client reads through a port replica, and a JAX
  ``WarmStandby`` tails a port primary, each bitwise.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch

import multiverso_tpu as jmv
from multiverso_tpu.durable.standby import WarmStandby as JWarmStandby

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.read import (ReadCache, ReadRouter,
                                               ReplicaReader, cache_key)
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.updaters import GetOption

SEED = int(os.environ.get("CHAOS_SEED", "7"))
_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_durable_primary_child.py")


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


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _spawn_primary(wal_dir, *extra):
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(_CHILD)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, _CHILD, str(port), str(wal_dir), *extra],
        stdout=subprocess.PIPE, text=True, env=env)
    line = child.stdout.readline()
    while line and not line.strip().startswith("serving "):
        line = child.stdout.readline()
    if not line:
        child.kill()
        raise AssertionError("primary child died during startup")
    _, endpoint, table_id = line.split()
    return child, endpoint, int(table_id)


# -- units: watermark plumbing ------------------------------------------------

def test_message_watermark_wire_roundtrip():
    """The v4 header carries the watermark field bit-exactly, both set
    and defaulted."""
    from multiverso_tpu_torch.runtime.net import TcpNet
    net = TcpNet()
    for wm in (-1, 0, 7, 1 << 40):
        msg = Message(src=3, dst=0, type=MsgType.Reply_Read, table_id=2,
                      msg_id=11, req_id=5, watermark=wm,
                      data=[np.arange(4, dtype=np.float32)])
        frame = net._frame(msg, 0)
        view = memoryview(frame)
        pos = [0]

        def read(n):
            out = view[pos[0]:pos[0] + n]
            pos[0] += n
            return bytes(out)

        decoded = net._read_frame(read, set())
        assert decoded.watermark == wm
        assert decoded.req_id == 5 and decoded.msg_id == 11
        np.testing.assert_array_equal(decoded.data[0],
                                      np.arange(4, dtype=np.float32))


def test_wal_append_sequence_and_observer(tmp_path):
    from multiverso_tpu_torch.durable.wal import WalWriter
    writer = WalWriter(str(tmp_path), sync="none")
    seen = []
    writer.add_observer(
        lambda seq, req_id, worker, table_id, msg_id, blobs:
        seen.append((seq, req_id)))
    assert writer.seq == 0
    for i in range(1, 4):
        seq = writer.append(100 + i, 0, 0, i, [np.float32([i])])
        assert seq == i
    assert writer.seq == 3
    assert seen == [(1, 101), (2, 102), (3, 103)]
    writer.close()


# -- units: bounded-staleness cache -------------------------------------------

def test_cache_key_exact_and_option_blind():
    ids_a = np.array([1, 2, 3], dtype=np.int32)
    ids_b = np.array([1, 2, 4], dtype=np.int32)
    assert cache_key(0, (ids_a, GetOption())) != cache_key(
        0, (ids_b, GetOption()))
    assert cache_key(0, (ids_a, GetOption())) == cache_key(
        0, (ids_a.copy(), GetOption(worker_id=5)))
    assert cache_key(0, (ids_a, None)) != cache_key(1, (ids_a, None))
    assert cache_key(0, (ids_a, object())) is None  # unknown envelope


def test_read_cache_lease_watermark_and_lru():
    cache = ReadCache(capacity_bytes=4096, lease_seconds=0.15)
    key = cache_key(0, (np.array([1, 2]), None))
    value = np.arange(8, dtype=np.float32)
    cache.store(key, value, watermark=10)
    hit = cache.lookup(key, budget=5)
    np.testing.assert_array_equal(hit, value)
    hit[0] = 99.0  # defensive copy: the cached value must not alias
    np.testing.assert_array_equal(cache.lookup(key, budget=5), value)

    # watermark invalidation: horizon jumps past the budget
    cache.observe_primary(14)
    assert cache.lookup(key, budget=5) is not None  # 14 - 10 <= 5
    cache.observe_primary(16)
    assert cache.lookup(key, budget=5) is None      # 16 - 10 > 5

    # lease expiry invalidates even with a satisfied budget
    cache.store(key, value, watermark=16)
    time.sleep(0.2)
    assert cache.lookup(key, budget=1000) is None

    # LRU byte cap: filling past capacity evicts the oldest
    big = np.zeros(256, np.float32)  # ~1KiB each
    keys = [cache_key(0, (np.array([i]), None)) for i in range(6)]
    for k in keys:
        cache.store(k, big, watermark=16)
    assert cache.lookup(keys[0], budget=-1) is None  # evicted
    assert cache.lookup(keys[-1], budget=-1) is not None

    # epoch flush: a primary watermark REGRESSION (failover) flushes all
    cache.observe_primary(2)
    assert len(cache) == 0

    # write-through invalidation is per table
    cache.store(cache_key(0, (np.array([1]), None)), big, 5)
    cache.store(cache_key(1, (np.array([1]), None)), big, 5)
    cache.invalidate_table(0)
    assert cache.lookup(cache_key(0, (np.array([1]), None)), -1) is None
    assert cache.lookup(cache_key(1, (np.array([1]), None)), -1) is not None


# -- units: replica admission over a real socket ------------------------------

def test_replica_admission_and_watermark_probe(port_env):
    """Drive a ReplicaReadServer around a synthetic standby state: budget
    admission (lag vs budget, unsynced, dead primary) and the watermark
    probe, over real sockets."""
    from multiverso_tpu_torch.durable.standby import (ReplicaReadServer,
                                                WarmStandby)
    table = mv.create_table("array", 8, np.float32)
    table.add(np.ones(8, np.float32))
    standby = WarmStandby("127.0.0.1:1", "127.0.0.1:1", tables=[table],
                          takeover=False)  # never started: state set below
    server = ReplicaReadServer(standby)
    reader = ReplicaReader(server.endpoint)
    done = threading.Event()
    box = {}

    def read(budget):
        done.clear()
        box.clear()

        def cb(result, wm, err):
            box.update(result=result, wm=wm, err=err)
            done.set()

        assert reader.read_async(table.table_id, GetOption(), budget,
                                 cb) is not None
        assert done.wait(10)
        return box

    try:
        # unsynced: everything but unbounded refuses
        out = read(100)
        assert out["err"] is not None and "not yet synced" in str(out["err"])

        standby.applied_watermark = 10
        standby.received_watermark = 10
        standby.primary_watermark = 15
        standby.last_contact = time.monotonic()
        out = read(5)   # lag 5 <= budget 5
        np.testing.assert_array_equal(out["result"],
                                      np.ones(8, np.float32))
        assert out["wm"] == 10
        out = read(3)   # lag 5 > budget 3
        assert out["err"] is not None and "replica-refused" in str(out["err"])
        out = read(-1)  # unbounded always serves
        assert out["err"] is None and out["wm"] == 10

        standby.primary_dead = True
        out = read(1000)
        assert out["err"] is not None and "replica-refused" in str(out["err"])
        out = read(-1)  # unbounded still serves the last-known state
        assert out["err"] is None

        probe = mv.watermark(server.endpoint)
        assert probe["role"] == "replica" and probe["watermark"] == 10
        assert probe["lag"] == 5 and probe["primary_dead"] is True
        assert Dashboard.counter_value("REPLICA_READ_REFUSALS") >= 2
    finally:
        reader.close()
        server.stop()


def test_records_racing_the_state_transfer_are_not_lost(port_env):
    """The primary forwards records from its dispatcher thread while the
    transfer reply rides the pump thread — records can reach the standby
    BEFORE the snapshot that does not contain them. They must be
    buffered and replayed past the transfer's watermark, not applied
    early and wiped by the snapshot load (acknowledged-Add loss)."""
    from multiverso_tpu_torch import io as mv_io
    from multiverso_tpu_torch.durable.standby import WarmStandby
    from multiverso_tpu_torch.runtime import wire
    from multiverso_tpu_torch.updaters import AddOption

    table = mv.create_table("array", 8, np.float32)
    server_table = table._server_table
    snapshot = mv_io.MemoryStream()
    server_table.store(snapshot)  # the all-zeros state, watermark 0
    standby = WarmStandby("127.0.0.1:1", "127.0.0.1:1", tables=[table],
                          takeover=False)  # never started: driven by hand

    def record(seq):
        return Message(type=MsgType.Control_Wal_Record,
                       table_id=table.table_id, msg_id=seq, req_id=seq,
                       watermark=seq,
                       data=wire.encode((np.ones(8, np.float32),
                                         AddOption())))

    # two records race ahead of the transfer reply
    standby._on_record(record(1))
    standby._on_record(record(2))
    assert standby.applied_watermark == -1  # buffered, NOT applied early
    standby._load_state({
        "tables": {table.table_id: np.frombuffer(snapshot.getvalue(),
                                                 dtype=np.uint8)},
        "dedup": [], "watermark": 0})
    # the snapshot load did not wipe them: both replayed past watermark 0
    assert standby.applied_watermark == 2
    np.testing.assert_array_equal(table.get(), 2.0 * np.ones(8))
    # their dedup seeds survived for the takeover window
    assert [s[0] for s in standby._seeds] == [1, 2]
    # and a later in-order record applies straight through
    standby._on_record(record(3))
    assert standby.applied_watermark == 3


def test_audit_drill_survives_a_fresh_state_transfer(port_env):
    """The MV_AUDIT_CORRUPT drill's flip must outlive a resubscribe: a
    lease stall or a replication gap loads the primary's bytes over the
    replica's tables, and the drill re-plants the flip inside that same
    serialized load, so the auditor still finds the divergence."""
    from multiverso_tpu_torch import io as mv_io
    from multiverso_tpu_torch.durable.standby import WarmStandby
    from multiverso_tpu_torch.shard._child import _arm_audit_corruption

    table = mv.create_table("matrix", num_row=16, num_col=4)
    snapshot = mv_io.MemoryStream()
    table._server_table.store(snapshot)  # the all-zeros primary state
    transfer = {"tables": {table.table_id: np.frombuffer(
        snapshot.getvalue(), dtype=np.uint8)}, "dedup": [], "watermark": 0}
    standby = WarmStandby("127.0.0.1:1", "127.0.0.1:1", tables=[table],
                          takeover=False)  # never started: driven by hand
    standby._load_state(transfer)
    _arm_audit_corruption(standby, f"{table.table_id}:7:0")
    deadline = time.monotonic() + 30.0
    while standby.after_transfer is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert standby.after_transfer is not None

    def flipped_rows():
        bits = np.asarray(table.get(), np.float32).view(np.uint32)
        return sorted(set(np.nonzero(bits)[0].tolist()))
    assert flipped_rows() == [7]
    standby._load_state(transfer)  # the resubscribe's fresh transfer
    assert flipped_rows() == [7]


# -- hedged reads -------------------------------------------------------------

class _FakeReplica:
    """A minimal Request_Read answerer with a configurable delay — the
    hedging unit's controllable endpoints."""

    def __init__(self, delay, value, watermark=10):
        from multiverso_tpu_torch.runtime.net import TcpNet
        from multiverso_tpu_torch.runtime import wire
        self.delay = delay
        self.value = value
        self.watermark = watermark
        self.served = 0
        self._wire = wire
        self._net = TcpNet()
        self.endpoint = self._net.bind(0, "127.0.0.1:0")
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        while True:
            try:
                msg = self._net.recv()
            except ConnectionError:
                continue
            if msg is None:
                return
            if msg.type != MsgType.Request_Read:
                continue
            self.served += 1
            time.sleep(self.delay)
            try:
                self._net.send_via(msg._conn, Message(
                    src=0, dst=msg.src, type=MsgType.Reply_Read,
                    table_id=msg.table_id, msg_id=msg.msg_id,
                    watermark=self.watermark,
                    data=self._wire.encode(self.value)))
            except OSError:
                pass

    def close(self):
        self._net.finalize()


def _settled_completion():
    from multiverso_tpu_torch.tables.base import Completion
    return Completion()


def test_hedged_read_winner_and_loser_cancel():
    """Slow first-choice replica: the hedge fires the second after the
    delay, the fast reply wins, the slow one is cancelled and its late
    reply is dropped without error."""
    slow = _FakeReplica(delay=0.6, value=np.float32([1.0]))
    fast = _FakeReplica(delay=0.0, value=np.float32([2.0]))
    mv.set_flag("read_hedge_ms", 30)
    fallbacks = []
    router = ReadRouter([slow.endpoint, fast.endpoint], "hedged",
                        lambda *a: fallbacks.append(a), budget=-1,
                        cache_bytes=0)
    try:
        hedges0 = Dashboard.counter_value("READ_HEDGES")
        completion = _settled_completion()
        router.submit_get(0, (None, GetOption()), completion)
        result = completion.wait(10)
        np.testing.assert_array_equal(result, np.float32([2.0]))
        assert Dashboard.counter_value("READ_HEDGES") == hedges0 + 1
        assert Dashboard.counter_value("READ_HEDGE_WINS") >= 1
        assert slow.served == 1 and fast.served == 1
        assert not fallbacks, "hedge must not touch the primary here"
        # the loser's late reply lands ~0.6s in; nothing may blow up and
        # its pending entry must be gone (cancelled)
        time.sleep(0.8)
        with slow._net._conn_lock:
            pass  # fake still healthy
        # a second read with both fast now: no hedge needed to win
        completion = _settled_completion()
        router.submit_get(0, (None, GetOption()), completion)
        completion.wait(10)
    finally:
        router.close()
        slow.close()
        fast.close()


def test_read_router_falls_back_when_replicas_down():
    """Every replica dead: the read settles through the primary path
    with no caller-visible error."""
    dead_ep = f"127.0.0.1:{_free_port()}"

    def primary_submit(table_id, request, completion):
        completion.done(np.float32([7.0]))

    router = ReadRouter([dead_ep], "replica", primary_submit, budget=8,
                        cache_bytes=0)
    try:
        before = Dashboard.counter_value("READ_PRIMARY_FALLBACKS")
        completion = _settled_completion()
        router.submit_get(0, (None, GetOption()), completion)
        np.testing.assert_array_equal(completion.wait(10),
                                      np.float32([7.0]))
        assert Dashboard.counter_value("READ_PRIMARY_FALLBACKS") == before + 1
    finally:
        router.close()


# -- the staleness property ---------------------------------------------------

@pytest.mark.parametrize("chaos", ["clean", "drop"])
def test_replica_bounded_staleness_property(chaos, tmp_path):
    """No reply is staler than the budget relative to the WAL watermark.

    A child primary serves durably; this process runs a read replica.
    Writes advance the primary's append watermark; the replica's tail is
    (a) artificially held back past the budget and (b), in the chaos
    variant, thinned by seeded drops of replication frames (gap-resync).
    Every successful replica reply must satisfy
    ``reply.watermark >= acked_writes_at_issue - budget``; reads the
    replica cannot bound must refuse (and the routed client then serves
    them from the primary with the exact fresh value, zero errors)."""
    budget = 4
    extra = []
    if chaos == "drop":
        extra = [f"--fault-spec=drop:type=Control_Wal_Record,every=5",
                 f"--fault-seed={SEED}"]
    child, endpoint, table_id = _spawn_primary(tmp_path / "primary", *extra)
    try:
        mv.init(ps_role="server", remote_workers=2,
                wal_dir=str(tmp_path / "replica"),
                heartbeat_seconds=0.2, lease_seconds=30.0,
                read_staleness_records=budget)
        mv.create_table("array", 8, np.float32)
        from multiverso_tpu_torch.durable.standby import WarmStandby
        standby = WarmStandby(endpoint, endpoint, takeover=False).start()
        assert standby.synced.wait(60), "state transfer never completed"
        read_ep = standby.serve_reads()

        writer = mv.remote_connect(endpoint)
        wt = writer.table(table_id)
        reader = ReplicaReader(read_ep)
        acked = 0

        def replica_read():
            done = threading.Event()
            box = {}

            def cb(result, wm, err):
                box.update(result=result, wm=wm, err=err)
                done.set()

            token = reader.read_async(table_id, GetOption(), budget, cb)
            if token is None or not done.wait(10):
                return None
            return box

        served, refused = 0, 0
        for i in range(30):
            wt.add(np.ones(8, np.float32))
            acked += 1
            floor = acked  # append watermark is at least this at issue
            out = replica_read()
            assert out is not None, "replica read lost"
            if out["err"] is None:
                served += 1
                # THE property: the reply is within `budget` records of
                # the primary's append watermark at issue time
                assert out["wm"] >= floor - budget, (
                    f"stale reply: watermark {out['wm']} vs floor {floor}"
                    f" - budget {budget} (iteration {i})")
                np.testing.assert_array_equal(
                    out["result"], float(out["wm"]) * np.ones(8))
            else:
                refused += 1
        assert served > 0, "replica never served within the budget"

        # -- held-back tail: lag grows past the budget -> refusals only
        standby.hold_tail.set()
        for _ in range(budget + 3):
            wt.add(np.ones(8, np.float32))
            acked += 1
        deadline = time.monotonic() + 20
        while (standby.primary_watermark - standby.applied_watermark
               <= budget and time.monotonic() < deadline):
            time.sleep(0.05)
        out = replica_read()
        assert out is not None
        if chaos == "clean":
            assert out["err"] is not None, (
                "replica served beyond the budget with its tail held: "
                f"{out}")
            assert "replica-refused" in str(out["err"])
        elif out["err"] is None:
            # drop chaos: a gap-triggered resubscribe may have refreshed
            # the whole state past the held records — serving is then
            # legitimate, but the bound must STILL hold
            assert out["wm"] >= acked - budget, out

        # the ROUTED client sees zero errors; its value honors the bound
        # (clean: the refusal falls back to the primary — exact; drop: a
        # resynced replica may serve a legitimately bounded-stale value)
        routed = mv.remote_connect(endpoint, read_endpoints=[read_ep],
                                   read_preference="replica")
        value = routed.table(table_id).get()
        assert float(value[0]) >= acked - budget, (value, acked)
        np.testing.assert_array_equal(value, value[0] * np.ones(8))
        if chaos == "clean":
            np.testing.assert_array_equal(value,
                                          float(acked) * np.ones(8))

        standby.release_tail()
        deadline = time.monotonic() + 20
        while (standby.lag_records() > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        out = replica_read()
        assert out is not None and out["err"] is None, out
        assert out["wm"] >= acked - budget

        if chaos == "drop":
            # dropped replication frames must have been DETECTED (never
            # silently skipped): the replica resubscribed at least once
            # and still never served beyond the budget above
            assert standby.records_applied > 0
            probe = mv.watermark(read_ep)
            assert probe["lag"] <= budget

        reader.close()
        routed.close()
        writer.close()
        standby.stop()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


# -- cache invalidation against a live serving tier ---------------------------

def test_cache_invalidation_on_watermark_advance(tmp_path):
    """A cached hot-key Get re-serves without touching the wire inside
    its lease, and refetches once the observed primary watermark moves
    past the budget (the client's own Add both advances the horizon and
    write-through-invalidates the table)."""
    child, endpoint, table_id = _spawn_primary(tmp_path / "primary")
    try:
        mv.init(ps_role="server", remote_workers=2,
                wal_dir=str(tmp_path / "replica"),
                heartbeat_seconds=0.2, lease_seconds=30.0)
        mv.create_table("array", 8, np.float32)
        from multiverso_tpu_torch.durable.standby import WarmStandby
        standby = WarmStandby(endpoint, endpoint, takeover=False).start()
        assert standby.synced.wait(60)
        read_ep = standby.serve_reads()

        mv.set_flag("client_cache_bytes", 1 << 20)
        mv.set_flag("read_lease_seconds", 30.0)  # watermark, not lease,
        mv.set_flag("read_staleness_records", 2)  # must invalidate here
        client = mv.remote_connect(endpoint, read_endpoints=[read_ep],
                                   read_preference="replica")
        rt = client.table(table_id)
        rt.add(np.ones(8, np.float32))
        deadline = time.monotonic() + 20
        while standby.applied_watermark < 1 and time.monotonic() < deadline:
            time.sleep(0.05)

        first = rt.get()
        np.testing.assert_array_equal(first, np.ones(8))
        hits0 = Dashboard.counter_value("READ_CACHE_HITS")
        for _ in range(5):
            np.testing.assert_array_equal(rt.get(), first)
        assert Dashboard.counter_value("READ_CACHE_HITS") == hits0 + 5

        # 3 more adds: the Add acks advance the horizon 3 > budget 2 and
        # invalidate the table's entries outright — the next get must
        # refetch and see the new value (read-your-writes through cache)
        for _ in range(3):
            rt.add(np.ones(8, np.float32))
        deadline = time.monotonic() + 20
        while standby.applied_watermark < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        np.testing.assert_array_equal(rt.get(), 4.0 * np.ones(8))

        client.close()
        standby.stop()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


# -- interop with the JAX package ----------------------------------------------

def _primary_gets(endpoint):
    """Gets the primary's dispatcher has served (its histogram's count)."""
    hist = mv.stats(endpoint).histogram("SERVER_PROCESS_GET_MSG")
    return hist.count if hist is not None else 0


def test_jax_client_reads_from_port_replica(tmp_path):
    """A JAX-package client routed through a port read replica of a port
    primary: its Gets come off the replica (the primary's Get histogram
    does not move), bitwise equal to the primary's state."""
    child, endpoint, table_id = _spawn_primary(tmp_path / "primary")
    try:
        mv.init(ps_role="server", remote_workers=2,
                wal_dir=str(tmp_path / "replica"),
                heartbeat_seconds=0.2, lease_seconds=30.0)
        mv.create_table("array", 8, np.float32)
        standby = mv.warm_standby(endpoint, endpoint, takeover=False)
        assert standby.synced.wait(60)
        read_ep = standby.serve_reads()
        rng = np.random.default_rng(SEED)
        deltas = rng.integers(-4, 5, (5, 8)).astype(np.float32)
        jmv.set_flag("heartbeat_seconds", 0.0)
        jmv.set_flag("read_staleness_records", 0)
        writer = jmv.remote_connect(endpoint)
        for d in deltas:
            writer.table(table_id).add(d)
        deadline = time.monotonic() + 20
        while standby.applied_watermark < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        gets0 = _primary_gets(endpoint)
        reader = jmv.remote_connect(endpoint, read_endpoints=[read_ep],
                                    read_preference="replica")
        for _ in range(4):
            np.testing.assert_array_equal(reader.table(table_id).get(),
                                          deltas.sum(axis=0))
        assert Dashboard.counter_value("READS_SERVED_REPLICA") == 4
        assert _primary_gets(endpoint) == gets0
        reader.close()
        writer.close()
        standby.stop()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_jax_standby_tails_port_primary(tmp_path):
    """A JAX-package ``WarmStandby`` subscribes to a port primary: the
    state transfer, the record stream and the watermarks are the wire's,
    so its table ends bitwise equal to the port's."""
    from multiverso_tpu.runtime.zoo import Zoo as JZoo
    mv.init(remote_workers=2, wal_dir=str(tmp_path / "primary"),
            heartbeat_seconds=0.2)
    table = mv.create_table("matrix", 16, 4)
    endpoint = mv.serve("127.0.0.1:0")
    rng = np.random.default_rng(SEED)
    client = mv.remote_connect(endpoint)
    rt = client.table(table.table_id)
    rt.add(rng.integers(-4, 5, (3, 4)).astype(np.float32),
           row_ids=np.array([1, 5, 9], np.int32))

    jmv.init(ps_role="server", remote_workers=2, heartbeat_seconds=0.2,
             lease_seconds=30.0)
    jtable = jmv.create_table("matrix", 16, 4)
    jstandby = JWarmStandby(endpoint, endpoint, takeover=False).start()
    assert jstandby.synced.wait(60)
    for _ in range(4):
        ids = rng.integers(0, 16, 5).astype(np.int32)
        rt.add(rng.integers(-4, 5, (5, 4)).astype(np.float32), row_ids=ids)
    deadline = time.monotonic() + 20
    while jstandby.applied_watermark < 5 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert jstandby.applied_watermark == 5 == mv.watermark(
        endpoint)["watermark"]
    with JZoo.instance().admin():
        np.testing.assert_array_equal(np.asarray(jtable.get()), table.get())
    jstandby.stop()
    jmv.shutdown()
    client.close()


def test_sharded_replica_fleet_and_kill_drill(tmp_path):
    """A 2-shard CPU group with one serving replica a shard: routed reads
    come off the replicas, the replicas' stats show it (slot-free), and
    SIGKILLing a replica under read traffic surfaces ZERO errors — reads
    fall back to the primary. The replica processes' stats are read one
    by one (the port has no ``stats_all`` yet)."""
    rows, cols = 64, 4
    from multiverso_tpu_torch.shard.group import ShardGroup
    group = ShardGroup(
        [{"kind": "matrix", "num_row": rows, "num_col": cols,
          "dtype": "<f4"}],
        shards=2, replicas=1, base_dir=str(tmp_path), device="cpu",
        flags={"remote_workers": 4, "heartbeat_seconds": 0.2})
    try:
        group.start(timeout=120)
        mv.set_flag("read_staleness_records", 1 << 30)
        mv.set_flag("read_timeout_seconds", 1.0)
        assert all(len(f) == 1 for f in group.replica_endpoints)
        client = group.connect(read_preference="replica")
        table = client.table(0)
        values = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
        table.add(values, row_ids=np.arange(rows, dtype=np.int32))
        deadline = time.monotonic() + 60
        for fleet in group.replica_endpoints:
            while time.monotonic() < deadline:
                probe = mv.watermark(fleet[0])
                if probe["watermark"] >= 1 and probe["lag"] == 0:
                    break
                time.sleep(0.1)
        ids = np.arange(rows, dtype=np.int32)
        np.testing.assert_array_equal(table.get(row_ids=ids), values)
        assert Dashboard.counter_value("READS_VIA_REPLICA") >= 2
        replica_stats = [mv.stats(f[0]) for f in group.replica_endpoints]
        assert sum(s.counter("READS_SERVED_REPLICA")
                   for s in replica_stats) >= 2
        assert any(s.gauge("REPLICA_WATERMARK") >= 1 for s in replica_stats)

        errors, reads = [], [0]
        stop = threading.Event()

        def pound():
            while not stop.is_set():
                try:
                    np.testing.assert_array_equal(table.get(row_ids=ids),
                                                  values)
                    reads[0] += 1
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)

        thread = threading.Thread(target=pound)
        thread.start()
        time.sleep(0.5)
        group.kill_replica(0, 0)
        time.sleep(2.0)
        stop.set()
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert not errors, f"reads surfaced errors across the kill: {errors}"
        assert reads[0] > 0
        assert Dashboard.counter_value("READ_PRIMARY_FALLBACKS") >= 1
        client.close()
    finally:
        group.stop()
