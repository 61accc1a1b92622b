"""The port's checkpoints (``multiverso_tpu_torch.checkpoint`` and the
tables' ``store``/``load``) against the JAX package's.

* The scenarios of ``tests/test_checkpoint.py`` on the port
  (``device="cpu"``): the array frame, store/load of both dense tables,
  the periodic driver, resume exactness under AdaGrad and momentum
  (bitwise), the sparse staleness reset and the reset at another worker
  count.
* The interchange, for each table kind (array, matrix with AdaGrad
  states, sparse matrix, host KV, sparse, sparse FTRL, dense FTRL) and
  each direction: one package stores, the other loads and stores again;
  the two files are byte-identical and the loaded state is bitwise equal
  to the stored one. JAX state carried across by ``convert`` gives the
  same port table as a checkpoint load of that state.
* Loads write into the tables' tensors: a registered program that
  closed over them sees the restored values.
* The stateful updaters keep the same named state arrays, with the same
  worker dimension and logical shape, in both packages.

Small shapes throughout, one per table kind."""

import os
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu import checkpoint as jck
from multiverso_tpu.io import MemoryStream as JaxMemoryStream
from multiverso_tpu.tables import ftrl_table as jftrl
from multiverso_tpu.tables import sparse_table as jsparse

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import checkpoint as tck
from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard as TorchDashboard
from multiverso_tpu_torch.io import MemoryStream
from multiverso_tpu_torch.runtime.programs import register_program
from multiverso_tpu_torch.tables import ftrl_table as tftrl
from multiverso_tpu_torch.tables import sparse_table as tsparse
from multiverso_tpu_torch.updaters import AddOption

CKPT = {mv: jck, mvt: tck}
SPARSE = {mv: jsparse, mvt: tsparse}
FTRL = {mv: jftrl, mvt: tftrl}


@pytest.fixture(autouse=True)
def port_flags():
    """Each test starts the port from its flag defaults and leaves no
    runtime behind (tests/conftest.py resets only the JAX package)."""
    TORCH_FLAGS.reset()
    TorchDashboard.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _restart(**flags):
    mvt.shutdown()
    TORCH_FLAGS.reset()
    mvt.init(device="cpu", **flags)


# -- the scenarios of tests/test_checkpoint.py ---------------------------------

@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<f2", "<i4", "<i8"])
def test_array_frame_roundtrip_and_bytes(dtype):
    arr = (np.arange(12) - 5).astype(dtype).reshape(3, 4)
    s = MemoryStream()
    tck.write_array(s, arr)
    j = JaxMemoryStream()
    jck.write_array(j, arr)
    assert s.getvalue() == j.getvalue()
    # a tensor frames as its numpy counterpart
    t = MemoryStream()
    tck.write_array(t, torch.from_numpy(arr))
    assert t.getvalue() == s.getvalue()
    s.seek(0)
    out = tck.read_array(s)
    assert out.dtype == arr.dtype and out.dtype.str == dtype
    np.testing.assert_array_equal(out, arr)


def test_dtype_without_numpy_counterpart_fails_at_store():
    with pytest.raises(mvt.log.FatalError, match="numpy"):
        tck.write_array(MemoryStream(), torch.zeros(3, dtype=torch.bfloat16))


def test_truncated_frame_is_fatal():
    s = MemoryStream()
    tck.write_array(s, np.arange(8, dtype=np.float32))
    with pytest.raises(mvt.log.FatalError, match="truncated"):
        tck.read_array(MemoryStream(s.getvalue()[:-4]))


def test_array_table_store_load(tmp_path):
    mvt.init(device="cpu")
    path = str(tmp_path / "array.mvckpt")
    table = mvt.create_table("array", 20, np.float32)
    table.add(np.arange(20, dtype=np.float32))
    tck.store_table(table, path)
    assert os.listdir(tmp_path) == ["array.mvckpt"]  # the temp file renamed
    fresh = mvt.create_table("array", 20, np.float32)
    tck.load_table(fresh, path)
    np.testing.assert_array_equal(fresh.get(), np.arange(20, dtype=np.float32))
    assert TorchDashboard.histogram("CHECKPOINT_STORE_SECONDS").count == 1
    assert TorchDashboard.histogram("CHECKPOINT_RESTORE_SECONDS").count == 1
    wrong = mvt.create_table("array", 21, np.float32)
    with pytest.raises(mvt.log.FatalError, match="size mismatch"):
        tck.load_table(wrong, path)


def test_matrix_table_store_load_zeroes_pads_and_sentinel(tmp_path):
    mvt.init(device="cpu")
    path = str(tmp_path / "matrix.mvckpt")
    table = mvt.create_table("matrix", 5, 3, np.float32)
    vals = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    table.add(vals)
    tck.store_table(table, path)

    fresh = mvt.create_table("matrix", 5, 3, np.float32)
    server = fresh._server_table
    assert tuple(server.data.shape) == (6, 4)  # sentinel row, 16-byte rows
    server.data.fill_(7.0)                     # pads and sentinel dirty
    tck.load_table(fresh, path)
    np.testing.assert_array_equal(fresh.get(), vals)
    want = np.zeros((6, 4), np.float32)
    want[:5, :3] = vals
    np.testing.assert_array_equal(server.data.numpy(), want)


def test_driver_periodic_and_restore(tmp_path):
    mvt.init(device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    table = mvt.create_table("array", 8, np.float32)
    driver = tck.CheckpointDriver([table], ckpt_dir, interval_steps=2)
    table.add(np.ones(8, np.float32))
    driver.step()          # step 1: no snapshot
    assert os.listdir(ckpt_dir) == []
    table.add(np.ones(8, np.float32))
    driver.step()          # step 2: snapshot at value 2
    table.add(np.ones(8, np.float32))  # not snapshotted
    driver.close()
    assert os.listdir(ckpt_dir) == [f"table_{table.table_id}.mvckpt"]

    # a restarted process re-creates its tables in the same order
    _restart()
    fresh = mvt.create_table("array", 8, np.float32)
    driver2 = tck.CheckpointDriver([fresh], ckpt_dir)
    assert driver2.restore() is True
    np.testing.assert_array_equal(fresh.get(), np.full(8, 2.0, np.float32))
    driver2.close()


def test_driver_timer_snapshots(tmp_path):
    mvt.init(device="cpu")
    ckpt_dir = str(tmp_path / "timer")
    table = mvt.create_table("array", 4, np.float32)
    table.add(np.full(4, 3.0, np.float32))
    driver = tck.CheckpointDriver([table], ckpt_dir, interval_seconds=0.05)
    path = os.path.join(ckpt_dir, f"table_{table.table_id}.mvckpt")
    deadline = time.monotonic() + 30
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.01)
    driver.close()
    fresh = mvt.create_table("array", 4, np.float32)
    tck.load_table(fresh, path)
    np.testing.assert_array_equal(fresh.get(), np.full(4, 3.0, np.float32))


def test_driver_restore_empty_dir(tmp_path):
    mvt.init(device="cpu")
    table = mvt.create_table("array", 4, np.float32)
    driver = tck.CheckpointDriver([table], str(tmp_path / "empty"))
    assert driver.restore() is False
    driver.close()


def test_driver_refuses_a_wal(tmp_path):
    """A WAL is no longer refused: a driver must share the log's root
    (MANIFEST, generations and segments are one recovery unit), and a
    snapshot through it commits generation 0 and rotates the log."""
    from multiverso_tpu.durable import wal as jwal
    from multiverso_tpu_torch.durable.wal import WalWriter
    mvt.init(device="cpu")
    table = mvt.create_table("array", 4, np.float32)
    writer = WalWriter(str(tmp_path / "root"))
    with pytest.raises(mvt.log.FatalError, match="WAL root"):
        tck.CheckpointDriver([table], str(tmp_path / "elsewhere"), wal=writer)
    tck.CheckpointDriver([table], str(tmp_path / "root"), wal=writer).snapshot()
    assert jwal.read_manifest(str(tmp_path / "root")) == {
        "generation": 0, "first_segment": 1}
    assert (tmp_path / "root" / "gen_0" / "table_0.mvckpt").exists()
    writer.close()


def _train_rounds(table, deltas, lr=0.1):
    for d in deltas:
        table.add(d, option=AddOption(worker_id=0, learning_rate=lr))


def test_resume_exactness_adagrad(tmp_path):
    """train k -> snapshot -> restore in a fresh runtime -> continue is
    bitwise identical to uninterrupted training (the MVS2 trailer carries
    the AdaGrad accumulators)."""
    rng = np.random.default_rng(5)
    deltas = [rng.normal(size=30).astype(np.float32) for _ in range(10)]
    path = str(tmp_path / "resume.mvckpt")

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("array", 30, np.float32, "adagrad")
    _train_rounds(t, deltas)
    want = t.get()

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("array", 30, np.float32, "adagrad")
    _train_rounds(t, deltas[:5])
    tck.store_table(t, path)

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("array", 30, np.float32, "adagrad")
    tck.load_table(t, path)
    _train_rounds(t, deltas[5:])
    np.testing.assert_array_equal(t.get(), want)


def test_resume_exactness_matrix_momentum(tmp_path):
    """Resume ≡ uninterrupted for a matrix table with momentum state
    (row-subset adds: the state slicing and padding round-trip)."""
    rng = np.random.default_rng(6)
    rounds = []
    for _ in range(8):
        ids = np.sort(rng.choice(12, 4, replace=False)).astype(np.int32)
        rounds.append((ids, rng.normal(size=(4, 5)).astype(np.float32)))
    path = str(tmp_path / "resume_m.mvckpt")

    def play(table, batch):
        for ids, vals in batch:
            table.add(vals, row_ids=ids,
                      option=AddOption(worker_id=0, learning_rate=0.05,
                                       momentum=0.9))

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("matrix", 12, 5, np.float32, "momentum_sgd")
    play(t, rounds)
    want = t.get()
    want_smooth = t._server_table.states["smooth"].clone()

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("matrix", 12, 5, np.float32, "momentum_sgd")
    play(t, rounds[:4])
    tck.store_table(t, path)

    _restart(local_workers=1, deterministic=True)
    t = mvt.create_table("matrix", 12, 5, np.float32, "momentum_sgd")
    tck.load_table(t, path)
    play(t, rounds[4:])
    np.testing.assert_array_equal(t.get(), want)
    assert torch.equal(t._server_table.states["smooth"], want_smooth)


def test_sparse_table_load_invalidates_staleness(tmp_path):
    """After a restore every row is served stale once: the snapshot does
    not cover worker-side client caches."""
    path = str(tmp_path / "sparse.mvckpt")
    mvt.init(device="cpu", local_workers=1)
    t = mvt.create_table("matrix", 8, 3, np.float32, is_sparse=True)
    with mvt.worker(0):
        t.add(np.ones((8, 3), np.float32))
        t.get()          # warms this worker's cache + marks rows fresh
        tck.store_table(t, path)
        tck.load_table(t, path)
        before = t.rows_pulled
        got = t.get()    # must re-pull ALL rows
        assert t.rows_pulled - before == 8
        np.testing.assert_array_equal(got, 1.0)


def test_restore_with_different_worker_count_resets_state(tmp_path):
    """Per-worker updater state (DCASGD backups) from a 4-worker snapshot
    restores into a 2-worker world by leaving that state as it is; table
    data still loads."""
    path = str(tmp_path / "elastic.mvckpt")
    _restart(local_workers=4)
    t = mvt.create_table("array", 10, np.float32, "dcasgd")
    with mvt.worker(0):
        t.add(np.ones(10, np.float32))
        want = t.get()
    tck.store_table(t, path)

    _restart(local_workers=2)
    t2 = mvt.create_table("array", 10, np.float32, "dcasgd")
    tck.load_table(t2, path)
    with mvt.worker(0):
        got = t2.get()
    np.testing.assert_array_equal(got, want)
    assert not t2._server_table.states["backup"].any()


# -- the interchange -------------------------------------------------------------

KINDS = ["array", "matrix_adagrad", "sparse_matrix", "kv", "sparse",
         "sparse_ftrl", "dense_ftrl"]


def _make(pkg, kind):
    if kind == "array":
        return pkg.create_table("array", 11, np.float32, "momentum_sgd")
    if kind == "matrix_adagrad":
        return pkg.create_table("matrix", 9, 5, np.float32, "adagrad")
    if kind == "sparse_matrix":
        return pkg.create_table("matrix", 9, 5, np.float32, is_sparse=True)
    if kind == "kv":
        return pkg.create_table("kv", np.int64)
    if kind == "sparse":
        return SPARSE[pkg].SparseWorker(1000, width=2, updater_type="sgd")
    if kind == "sparse_ftrl":
        return SPARSE[pkg].make_sparse_ftrl(1000, width=2)
    return FTRL[pkg].FTRLWorker(12)


def _fill(pkg, kind, table):
    rng = np.random.default_rng(11)
    for w in range(2):
        opt = pkg.AddOption(worker_id=w, learning_rate=0.1, momentum=0.5,
                            rho=0.1)
        with pkg.worker(w):
            if kind == "array":
                table.add(rng.normal(size=11).astype(np.float32), option=opt)
            elif kind in ("matrix_adagrad", "sparse_matrix"):
                ids = np.array([1, 4, 8], np.int32) + w
                table.add(rng.normal(size=(3, 5)).astype(np.float32),
                          row_ids=ids % 9, option=opt)
            elif kind == "kv":
                table.add([7, 3, 11 + w], [5, -2, 9])
            elif kind in ("sparse", "sparse_ftrl"):
                keys = rng.choice(1000, 6, replace=False)
                table.add(keys, rng.normal(size=(6, 2)).astype(np.float32))
            else:
                table.add(rng.normal(size=12).astype(np.float32))


def _state(kind, table):
    """The table's state as numpy arrays, at logical dims."""
    s = table._server_table
    if kind == "array":
        return [np.asarray(s.data)[: s.size]] + [
            np.asarray(s.states[k])[:, : s.size] for k in sorted(s.states)]
    if kind in ("matrix_adagrad", "sparse_matrix"):
        r, c = s.num_row, s.num_col
        return [np.asarray(s.data)[:r, :c]] + [
            np.asarray(s.states[k])[:, :r, :c] for k in sorted(s.states)]
    if kind == "kv":
        items = sorted(s._store.items())
        return [np.array([k for k, _ in items], np.int64),
                np.array([v for _, v in items], s.value_dtype)]
    if kind == "sparse":
        return list(s.process_get((None, None)))
    if kind == "sparse_ftrl":
        keys = sorted(s._z)
        return [np.array(keys, np.int64), np.stack([s._z[k] for k in keys]),
                np.stack([s._n[k] for k in keys])]
    return [np.asarray(s.z)[: s.size], np.asarray(s.n)[: s.size]]


def _convert(kind, jax_table, port_table):
    """Carry the JAX table's state into the port table with ``convert``."""
    js = jax_table._server_table
    state = _state(kind, jax_table)
    if kind in ("array", "matrix_adagrad", "sparse_matrix"):
        convert.load_state(port_table, state[0], {
            k: np.asarray(js.states[k])[(slice(None),) + tuple(
                slice(0, n) for n in state[0].shape)]
            for k in js.states})
    elif kind == "kv":
        convert.load_kv_state(port_table, jax_table.get())
    elif kind == "sparse":
        convert.load_sparse_state(port_table, *state)
    elif kind == "sparse_ftrl":
        convert.load_ftrl_state(port_table, state[1], state[2], keys=state[0])
    else:
        convert.load_ftrl_state(port_table, *state)


def _assert_same_state(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_interchange(tmp_path, kind, direction):
    mv.init(local_workers=2)
    mvt.init(device="cpu", local_workers=2)
    src, dst = (mv, mvt) if direction == "jax_to_port" else (mvt, mv)
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    t_src = _make(src, kind)
    _fill(src, kind, t_src)
    CKPT[src].store_table(t_src, first)
    t_dst = _make(dst, kind)
    CKPT[dst].load_table(t_dst, first)
    CKPT[dst].store_table(t_dst, second)
    with open(first, "rb") as a, open(second, "rb") as b:
        assert a.read() == b.read()
    _assert_same_state(_state(kind, t_dst), _state(kind, t_src))
    if src is mv:
        # convert and the checkpoint file carry the same JAX state across
        t_conv = _make(mvt, kind)
        _convert(kind, t_src, t_conv)
        _assert_same_state(_state(kind, t_conv), _state(kind, t_dst))


# -- in-place loads --------------------------------------------------------------

def test_restore_is_seen_by_a_program_registered_before_it(tmp_path):
    mvt.init(device="cpu")
    table = mvt.create_table("matrix", 6, 3, np.float32, "adagrad")
    server = table._server_table
    held_data, held_state = server.data, server.states["g_sqr"]

    def read_back(datas, states):
        # closes over the tensors captured before the restore
        return datas, states, (held_data[:6, :3].clone(),
                               held_state[:, :6, :3].clone(),
                               datas[0] is held_data)

    register_program("ckpt_test.read_back", read_back)
    vals = np.arange(18, dtype=np.float32).reshape(6, 3)
    g = np.full((1, 6, 3), 0.5, np.float32)
    src = mvt.create_table("matrix", 6, 3, np.float32, "adagrad")
    convert.load_state(src, vals, {"g_sqr": g})
    ckpt_dir = str(tmp_path / "ckpt")
    tck.store_table(src, os.path.join(ckpt_dir, f"table_{table.table_id}.mvckpt"))
    assert tck.restore_tables([table], ckpt_dir) == 1
    data, state, same = table.wait(
        table.transact_device_async("ckpt_test.read_back", []))
    assert same and server.data is held_data
    np.testing.assert_array_equal(data.numpy(), vals)
    np.testing.assert_array_equal(state.numpy(), g)


# -- updater state: the same names and layout in both packages -----------------------

@pytest.mark.parametrize("updater", ["adagrad", "momentum_sgd", "dcasgd"])
def test_updater_state_names_and_layout(updater):
    mv.init(local_workers=3)
    mvt.init(device="cpu", local_workers=3)
    for kind, args, logical in (("array", (10,), (10,)),
                                ("matrix", (7, 5), (7, 5))):
        j = mv.create_table(kind, *args, np.float32, updater)._server_table
        t = mvt.create_table(kind, *args, np.float32, updater)._server_table
        assert sorted(t.states) == sorted(j.states)
        for name in j.states:
            jarr, tarr = np.asarray(j.states[name]), t.states[name]
            assert tarr.shape[0] == jarr.shape[0]
            assert tarr.shape[0] == (3 if updater != "momentum_sgd" else 1)
            region = (slice(None),) + tuple(slice(0, n) for n in logical)
            assert tarr[region].numpy().dtype == jarr.dtype
            assert tarr[region].shape == jarr[region].shape
