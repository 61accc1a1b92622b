"""Serving across the two packages, and what the port's serving path adds.

* Interop both ways: a JAX-package client runs a seeded sequence of
  1024-row Adds and Gets on the port's served matrix table, and the port's
  child process (``tests/torch_remote_child.py``) runs the same sequence
  against the JAX package's ``mv.serve()``. Both final tables equal a numpy
  mirror and the Gets agree (rtol 1e-5, atol 1e-5: float32 sums of the
  same rows in another order).
* The table directory: every table kind's ``remote_spec`` is the JAX
  table's (logical shape, numpy dtype string; no padding on the wire).
* Lane order: one drained batch of queued Adds, a slot-free Get and a
  query is applied by both dispatchers; the Get and the query see the
  pre-Add rows in both (and, with ``priority_lanes`` off, the port's
  post-Add rows).
* ``PSTrainer`` on remote proxies of a port server against the JAX
  trainer on proxies of a JAX server: same tables, same host draws (rtol
  1e-4, atol 1e-6).
* Durable and sharded serving: a set ``wal_dir`` serves with a log, the
  read tier routes a client's Gets (the port's and the JAX package's)
  through a port replica, and the cut, digest, replication and
  replica-read frames are served, each answer the JAX package's; the
  layout frame is refused by a server outside a shard group in the JAX
  package's words. A client touches no card; a reply in a device form is
  read to the host."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu import io as mv_io_j
from multiverso_tpu.models import word2vec as jw
from multiverso_tpu.models.vocab import Dictionary as JDictionary
from multiverso_tpu.runtime.message import Message as JMessage
from multiverso_tpu.runtime.message import MsgType as JMsgType
from multiverso_tpu.runtime.zoo import Zoo as JZoo
from multiverso_tpu.tables.base import Completion as JCompletion
from multiverso_tpu.updaters import GetOption as JGetOption

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert, log
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import word2vec as tw
from multiverso_tpu_torch.models.vocab import Dictionary
from multiverso_tpu_torch.runtime import remote
from multiverso_tpu_torch.runtime.message import Message, MsgType
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.base import Completion
from multiverso_tpu_torch.updaters import GetOption

import torch_remote_child as child_mod

RTOL, ATOL = 1e-5, 1e-5
TRAINER_RTOL, TRAINER_ATOL = 1e-4, 1e-6
CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_remote_child.py")
REPO = os.path.dirname(os.path.dirname(CHILD))


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, clients
    without heartbeats; whatever a test starts is stopped
    (tests/conftest.py resets the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see tests/test_torch_sync.py's fixture
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    TORCH_FLAGS.set("heartbeat_seconds", 0.0)
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


# -- interop, both directions -------------------------------------------------

def test_seeded_sequence_both_directions(tmp_path):
    num_row, num_col, seed, rounds = 4096, 50, 11, 6
    mirror = child_mod.sequence_mirror(num_row, num_col, seed, rounds)

    # the port's child against the JAX package's server
    mv.set_flag("heartbeat_seconds", 0.0)
    mv.init(remote_workers=1)
    jtable = mv.create_table("matrix", num_row, num_col)
    endpoint = mv.serve("127.0.0.1:0")
    out = str(tmp_path / "gets.npy")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, CHILD, "sequence", endpoint, str(jtable.table_id),
         str(seed), str(rounds), out],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    gets_from_jax = np.load(out)
    jfinal = np.asarray(jtable.get())
    mv.shutdown()

    # a JAX-package client against the port's server
    mvt.init(remote_workers=1)
    ptable = mvt.create_table("matrix", num_row, num_col)
    client = mv.remote_connect(mvt.serve("127.0.0.1:0"))
    gets_from_port = child_mod.seeded_sequence(client.table(ptable.table_id),
                                               seed, rounds)
    client.close()
    pfinal = ptable.get()

    np.testing.assert_allclose(jfinal, mirror, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pfinal, mirror, rtol=RTOL, atol=ATOL)
    assert gets_from_port.shape == (rounds, 1024, num_col)
    np.testing.assert_allclose(gets_from_port, gets_from_jax, rtol=RTOL,
                               atol=ATOL)


# -- the table directory --------------------------------------------------------

SPECS = {
    "array": lambda m: m.create_table("array", 37, np.float32),
    "array_int": lambda m: m.create_table("array", 9, np.int32),
    "matrix_50": lambda m: m.create_table("matrix", 300, 50),
    "matrix_3_f64": lambda m: m.create_table("matrix", 16, 3, np.float64),
    "matrix_sparse_pipelined": lambda m: m.create_table(
        "matrix", 32, 4, is_sparse=True, is_pipelined=True),
    "kv": lambda m: m.create_table("kv", np.int64),
    "kv_device": lambda m: m.create_table("kv", np.float32, capacity=256),
    "sparse": lambda m: m.create_table("sparse", 1 << 20, 8),
    "tiered_sparse": lambda m: m.create_table("tiered_sparse", 1000, 4),
    "tiered_kv": lambda m: m.create_table("tiered_kv", np.float32),
}


def test_remote_spec_matches_jax_for_every_kind():
    """One process per package serves a table of every kind; the register
    reply's directory is the same (logical shapes, dtype strings)."""
    mv.set_flag("heartbeat_seconds", 0.0)
    mv.init(remote_workers=1)
    for make in SPECS.values():
        make(mv)
    jclient = mv.remote_connect(mv.serve("127.0.0.1:0"))
    want = jclient.directory
    jclient.close()
    mv.shutdown()
    mvt.init(remote_workers=1)
    for make in SPECS.values():
        make(mvt)
    tclient = mvt.remote_connect(mvt.serve("127.0.0.1:0"))
    got = tclient.directory
    assert got == want
    assert got[2]["num_col"] == 50  # not the port's 52 nor JAX's 128
    # every proxy builds from its entry
    assert len(tclient.tables()) == len(SPECS)
    tclient.close()


# -- lane order -----------------------------------------------------------------

def _lane_drain(pkg, msg_cls, type_cls, completion_cls, get_option):
    """Hold the dispatcher, queue two worker Adds, a slot-free Get and a
    query behind it, release: one drain. Returns (Get rows, query ids,
    query scores)."""
    table = pkg.create_table("matrix", 8, 4,
                             init_value=np.arange(32, dtype=np.float32))
    server = (JZoo if pkg is mv else Zoo).instance().server
    hold, held = threading.Event(), threading.Event()

    def park():
        held.set()
        hold.wait(30)

    parked = completion_cls()
    server.send(msg_cls(src=-1, dst=-1, type=type_cls.Server_Execute,
                        data=[park, parked]))
    assert held.wait(30)
    done = []
    for n, rid in ((1, 101), (2, 102)):
        c = completion_cls()
        server.send(msg_cls(src=0, dst=-1, type=type_cls.Request_Add,
                            table_id=table.table_id, req_id=rid,
                            data=[(np.array([1, 5], np.int32),
                                   np.full((2, 4), 100.0 * n, np.float32),
                                   None), c]))
        done.append(c)
    get_c, query_c = completion_cls(), completion_cls()
    server.send(msg_cls(src=-1, dst=-1, type=type_cls.Request_Get,
                        table_id=table.table_id, req_id=103,
                        data=[(np.array([1, 5], np.int32),
                               get_option(worker_id=-1)), get_c]))
    server.send(msg_cls(src=-1, dst=-1, type=type_cls.Request_Query,
                        table_id=table.table_id, req_id=104,
                        data=[(np.ones((1, 4), np.float32), 3, "dot"),
                              query_c]))
    hold.set()
    parked.wait(30)
    for c in done:
        c.wait(30)
    ids, scores = query_c.wait(30)
    return np.asarray(get_c.wait(30)), np.asarray(ids), np.asarray(scores)


def test_lane_order_matches_jax_dispatcher():
    mv.init()
    jget, jids, jscores = _lane_drain(mv, JMessage, JMsgType, JCompletion,
                                      JGetOption)
    mv.shutdown()
    mvt.init()
    tget, tids, tscores = _lane_drain(mvt, Message, MsgType, Completion,
                                      GetOption)
    mvt.shutdown()
    pre_add = np.arange(32, dtype=np.float32).reshape(8, 4)[[1, 5]]
    np.testing.assert_array_equal(jget, pre_add)
    np.testing.assert_array_equal(tget, jget)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tscores, jscores, rtol=1e-6)
    assert tids[0, 0] == 7  # the last row scores highest before the Adds
    # lanes off: arrival order, the Get sees both Adds
    mvt.init(priority_lanes=False)
    off, _, _ = _lane_drain(mvt, Message, MsgType, Completion, GetOption)
    np.testing.assert_array_equal(off, pre_add + 300.0)


# -- PSTrainer over the wire ----------------------------------------------------

def _dictionary(cls, counts):
    d = cls()
    d.words = [f"w{i}" for i in range(len(counts))]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.asarray(counts, np.int64)
    return d


def _on_proxies(pkg, trainer):
    """Serve the trainer's own tables and swap its proxies for remote ones:
    the trainer then takes its host branch."""
    client = pkg.remote_connect(pkg.serve("127.0.0.1:0"))
    trainer.input_table, trainer.output_table, trainer.count_table = (
        client.table(0), client.table(1), client.table(2))
    assert not trainer.input_table.supports_device_io
    return client


def test_ps_trainer_on_remote_proxies_matches_jax():
    vocab = 300
    kw = dict(vocab_size=vocab, dim=16, window=2, negatives=3,
              batch_pairs=512, sample=0.0, lr=0.1, seed=5)
    counts = np.maximum((1000 / np.arange(1, vocab + 1)).astype(np.int64), 5)
    p = counts / counts.sum()
    rng = np.random.default_rng(8)
    blocks = [np.searchsorted(np.cumsum(p), rng.random(600)).astype(np.int32)
              for _ in range(2)]
    mv.set_flag("heartbeat_seconds", 0.0)
    mv.init(remote_workers=1)
    jtr = jw.PSTrainer(jw.Word2VecConfig(**kw), _dictionary(JDictionary, counts))
    w_in0 = np.asarray(jtr.input_table.get())
    w_out0 = np.asarray(jtr.output_table.get())
    jclient = _on_proxies(mv, jtr)
    mvt.init(remote_workers=1)
    ttr = tw.PSTrainer(tw.Word2VecConfig(**kw), _dictionary(Dictionary, counts))
    convert.load_state(ttr.input_table, w_in0, {})
    convert.load_state(ttr.output_table, w_out0, {})
    tclient = _on_proxies(mvt, ttr)
    for block in blocks:
        jloss = jtr.train_block(block)
        tloss = ttr.train_block(block)
        np.testing.assert_allclose(tloss, jloss, rtol=TRAINER_RTOL)
        assert ttr.last_block_stats == jtr.last_block_stats
    for got, want in ((ttr.input_table.get(), jtr.input_table.get()),
                      (ttr.output_table.get(), jtr.output_table.get())):
        np.testing.assert_allclose(got, np.asarray(want), rtol=TRAINER_RTOL,
                                   atol=TRAINER_ATOL)
    assert not np.allclose(ttr.input_table.get(), w_in0)  # it trained
    assert ttr.count_table.get(0) == jtr.count_table.get(0) == 1200
    jclient.close()
    tclient.close()
    mv.shutdown()


# -- what stays out, and the host boundary --------------------------------------

def test_wal_dir_refused_naming_durable(tmp_path):
    """A set ``wal_dir`` is no longer refused: ``serve`` opens the log,
    and a JAX-package client's Adds land in it as records the JAX
    package's reader parses."""
    from multiverso_tpu.durable import wal as jwal
    root = str(tmp_path / "wal")
    mvt.init(wal_dir=root, remote_workers=1)
    table = mvt.create_table("array", 4)
    endpoint = mvt.serve("127.0.0.1:0")
    assert mvt.wal_writer() is not None and mvt.wal_writer().directory == root
    mv.set_flag("heartbeat_seconds", 0.0)
    client = mv.remote_connect(endpoint)
    client.table(table.table_id).add(np.arange(4, dtype=np.float32))
    assert mvt.watermark(endpoint)["watermark"] == 1
    client.close()
    mvt.stop_serving()
    assert mvt.wal_writer() is None
    seg = os.path.join(root, "wal", "seg00000000.t0.mvwal")
    with open(seg, "rb") as fp:
        records, _, clean = jwal._read_segment(fp.read(), seg)
    assert clean and len(records) == 1


def test_read_endpoints_refused_naming_read_tier(tmp_path):
    """``read_endpoints=`` is served: a port client and a JAX-package
    client routed through a JAX read replica of a port primary read the
    primary's state from the replica (the primary's Get histogram stays
    flat), and a dead replica falls back to the primary silently."""
    mvt.init(wal_dir=str(tmp_path / "wal"), remote_workers=2,
             heartbeat_seconds=0.2)
    table = mvt.create_table("array", 4)
    endpoint = mvt.serve("127.0.0.1:0")
    writer = mvt.remote_connect(endpoint)
    writer.table(table.table_id).add(np.arange(4, dtype=np.float32))

    from multiverso_tpu.durable.standby import WarmStandby as JWarmStandby
    mv.init(ps_role="server", remote_workers=2, heartbeat_seconds=0.2,
            lease_seconds=30.0)
    mv.create_table("array", 4)
    replica = JWarmStandby(endpoint, endpoint, takeover=False).start()
    assert replica.synced.wait(30)
    read_ep = replica.serve_reads()
    want = np.arange(4, dtype=np.float32)

    def gets():
        hist = mvt.stats(endpoint).histogram("SERVER_PROCESS_GET_MSG")
        return hist.count if hist is not None else 0

    before = gets()
    for connect in (mvt.remote_connect, mv.remote_connect):
        client = connect(endpoint, read_endpoints=[read_ep],
                         read_preference="replica")
        np.testing.assert_array_equal(client.table(table.table_id).get(),
                                      want)
        client.close()
    assert gets() == before
    dead = mvt.remote_connect(endpoint, read_endpoints=["127.0.0.1:1"],
                              read_preference="replica")
    np.testing.assert_array_equal(dead.table(table.table_id).get(), want)
    assert gets() == before + 1
    dead.close()
    replica.stop()
    writer.close()
    mv.shutdown()


def test_read_preference_refused_naming_read_tier():
    """``read_preference=`` is accepted now: without replicas to route to
    the client reads from the primary, as the JAX client does; with
    replicas an unknown preference is fatal."""
    mvt.init(remote_workers=1)
    table = mvt.create_table("array", 4)
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint, read_preference="replica")
    np.testing.assert_array_equal(client.table(table.table_id).get(),
                                  np.zeros(4, np.float32))
    client.close()
    with pytest.raises(log.FatalError, match="read_preference"):
        mvt.remote_connect(endpoint, read_endpoints=[endpoint],
                           read_preference="nearest")


def _primary_read(endpoint, table_id, request):
    """One slot-free Request_Read (the read tier's frame, table id set)
    answered by a primary; returns the value, checks the watermark."""
    from multiverso_tpu_torch.runtime.read import ReplicaReader
    reader = ReplicaReader(endpoint)
    done = threading.Event()
    box = {}

    def cb(result, watermark, err):
        box.update(result=result, watermark=watermark, err=err)
        done.set()

    try:
        assert reader.read_async(table_id, request, -1, cb) is not None
        assert done.wait(10)
    finally:
        reader.close()
    assert box["err"] is None and box["watermark"] == 0
    return box["result"]


@pytest.mark.parametrize("request_type,reply_type,payload", [
    (MsgType.Control_Cut, MsgType.Control_Reply_Cut, {"cut_id": "c1"}),
    (MsgType.Control_Digest, MsgType.Control_Reply_Digest, None),
    (MsgType.Control_Layout, MsgType.Control_Reply_Layout, None),
    (MsgType.Control_Replicate, MsgType.Control_Reply_Replicate, None),
    (MsgType.Request_Read, MsgType.Reply_Read, (None, None)),
], ids=["cut", "digest", "layout", "replicate", "read"])
def test_probes_of_unported_modules_refused(request_type, reply_type,
                                            payload, tmp_path):
    """(The name dates from before ``durable/cut.py`` and ``shard/`` were
    ported; the cut and layout probes are now served.) Each probe of a
    durable port primary gets the JAX package's
    answer: the cut's fence and per-table digests (``durable/cut.py``,
    against ``table_digest`` of the same JAX table), the digest string,
    the transferred table bytes, the read value; and the layout probe,
    sent to a server outside any shard group, the JAX server's refusal,
    word for word."""
    from multiverso_tpu.obs import audit as jaudit
    mvt.init(remote_workers=1, wal_dir=str(tmp_path / "wal"))
    table = mvt.create_table("array", 4)
    with Zoo.instance().admin():
        table.add(np.arange(4, dtype=np.float32))
    endpoint = mvt.serve("127.0.0.1:0")
    if request_type == MsgType.Control_Layout:
        with pytest.raises(RuntimeError) as port_err:
            remote.control_probe(endpoint, request_type, reply_type,
                                 timeout=10, payload=payload)
        mv.init()
        mv.create_table("array", 4)
        jendpoint = mv.serve("127.0.0.1:0")
        with pytest.raises(RuntimeError) as jax_err:
            remote.control_probe(jendpoint, request_type, reply_type,
                                 timeout=10, payload=payload)
        mv.shutdown()
        assert "not a shard-group member" in str(port_err.value)
        assert (str(port_err.value).replace(endpoint, "EP")
                == str(jax_err.value).replace(jendpoint, "EP"))
    else:
        if request_type == MsgType.Request_Read:
            got = _primary_read(endpoint, table.table_id, payload)
        else:
            got = remote.control_probe(endpoint, request_type, reply_type,
                                       timeout=10, payload=payload)
        mv.init()
        jtable = mv.create_table("array", 4)
        jtable.add(np.arange(4, dtype=np.float32))
        if request_type == MsgType.Control_Cut:
            assert got["cut_id"] == "c1" and got["fence"] == 0
            assert got["tables"] == [table.table_id]
            assert got["digests"][table.table_id] == jaudit.table_digest(
                jtable)
            assert os.path.isfile(os.path.join(got["cut_dir"], "CUT.json"))
        elif request_type == MsgType.Control_Digest:
            assert got["tables"][table.table_id] == jaudit.table_digest(
                jtable)
        elif request_type == MsgType.Control_Replicate:
            stream = mv_io_j.MemoryStream()
            jtable._server_table.store(stream)
            assert got["watermark"] == 0
            assert bytes(got["tables"][table.table_id]) == stream.getvalue()
        else:
            np.testing.assert_array_equal(got, np.arange(4, dtype=np.float32))
        mv.shutdown()
    # the server keeps serving
    assert mvt.stats(endpoint).counter("WORKER_EVICTIONS") == 0


def test_query_over_the_wire_in_both_clients():
    """A top-k query from either package's client, served slot-free by
    the port's dispatcher, equals the in-process answer."""
    mvt.init(remote_workers=2)
    rng = np.random.default_rng(4)
    data = rng.integers(-4, 5, (64, 8)).astype(np.float32)
    table = mvt.create_table("matrix", 64, 8, init_value=data)
    vecs = rng.integers(-4, 5, (3, 8)).astype(np.float32)
    want_ids, want_scores = mvt.query(table, vecs, 5)
    endpoint = mvt.serve("127.0.0.1:0")
    mv.set_flag("heartbeat_seconds", 0.0)
    for connect in (mvt.remote_connect, mv.remote_connect):
        client = connect(endpoint)
        ids, scores = client.table(table.table_id).query(vecs, 5)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(scores, want_scores)
        client.close()


def test_client_touches_no_card(monkeypatch):
    """Connecting, building all four proxies and a round trip each: no
    CUDA call in the client."""
    mvt.init(remote_workers=1)
    mvt.create_table("array", 4)
    mvt.create_table("matrix", 8, 3)
    mvt.create_table("kv")
    mvt.create_table("sparse", 100, 2)
    endpoint = mvt.serve("127.0.0.1:0")

    def no_cuda(*_a, **_k):
        raise AssertionError("a client touched CUDA")

    for name in ("is_available", "init", "_lazy_init", "device_count",
                 "current_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    client = mvt.remote_connect(endpoint)
    arr, mat, kv, sp = client.tables()
    arr.add(np.ones(4, np.float32))
    mat.add(np.ones((2, 3), np.float32), row_ids=[1, 2])
    kv.add([3], [2.0])
    sp.add([7], np.ones((1, 2), np.float32))
    assert arr.get().sum() == 4 and mat.get([1]).sum() == 3
    assert kv.get(3) == 2.0 and sp.get([7]).sum() == 2
    with pytest.raises(log.FatalError):
        mat.get_device_async([1])
    client.close()


def test_device_form_reply_is_read_to_host():
    """A Get in the in-process device-out form arrives as a host array:
    the dispatcher reads tensors to numpy before the codec sees them."""
    mvt.init(remote_workers=1)
    table = mvt.create_table("matrix", 8, 3,
                             init_value=np.arange(24, dtype=np.float32))
    client = mvt.remote_connect(mvt.serve("127.0.0.1:0"))
    c = Completion()
    client._send(table.table_id, MsgType.Request_Get,
                 (np.array([2], np.int32), GetOption(worker_id=-1), True),
                 99, c)
    got = c.wait(30)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got[0, :3], [6.0, 7.0, 8.0])
    assert remote._host_reply((torch.ones(2), [torch.zeros(1)]))[1][0].dtype \
        == np.float32
    client.close()


def test_shutdown_stops_the_remote_server():
    mvt.init(remote_workers=1)
    mvt.create_table("array", 4)
    endpoint = mvt.serve("127.0.0.1:0")
    assert mvt.serve() == endpoint  # serving already: the same endpoint
    assert Zoo.instance().remote_server is not None
    mvt.shutdown()
    with pytest.raises((ConnectionError, OSError, TimeoutError)):
        mvt.stats(endpoint, timeout=2)
