"""The port's multi-process lockstep PS against the JAX package.

Real OS processes form one world: the port's ranks under
``torch.distributed`` (gloo, ``device="cpu"``, one torch thread each),
the JAX package's under ``jax.distributed`` with 4 virtual CPU devices a
process. Each port rank holds its own row range of every matrix and array
table (``runtime/multihost.py``).

The scenarios mirror ``tests/multihost_child.py`` scenario for scenario;
this file's ``__main__`` block is their runner for both packages (argv:
rank, world, rendezvous port, control port, ``<pkg>:<scenario>[:<dir>]``).
``async`` runs in a JAX world and a port world on the same seeded integer
deltas, and the final logical tables must be equal bit for bit. The
word2vec parity case is in ``test_torch_multihost_w2v.py``, the failure
and consistency-mode twins in ``test_torch_multihost_modes.py``. The rest
hold the contracts ``multihost_child.py`` asserts against numpy oracles,
inside the children. The unit tests at the end cover the hello frame (its
bytes are the JAX package's), the rank mesh and row ranges, the row
exchange and ``allreduce_host``'s summation order."""

import os
import socket
import sys
import threading
from pathlib import Path

import numpy as np

RUNNER = str(Path(__file__).resolve())


# -- the scenario runner (both packages) -------------------------------------

def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    coord_port, ctl_port = sys.argv[3], sys.argv[4]
    pkg, _, rest = sys.argv[5].partition(":")
    scenario, _, outdir = rest.partition(":")
    if pkg == "jax":
        from multiverso_tpu.runtime.multihost import init_distributed_cpu
        init_distributed_cpu(f"127.0.0.1:{coord_port}", world, rank)
        import multiverso_tpu as mv
        extra = {}
    else:
        import torch
        torch.set_num_threads(1)
        import multiverso_tpu_torch as mv
        mv.init_distributed(f"127.0.0.1:{coord_port}", world, rank)
        extra = {"device": "cpu"}
    flags = dict(local_workers=2 if scenario in ("bsp2", "ma") else 1,
                 remote_workers=1 if scenario == "remote" else 0,
                 multihost_endpoint=f"127.0.0.1:{ctl_port}",
                 ssp_staleness=1 if scenario == "ssp" else -1,
                 ma=scenario == "ma",
                 # flagmismatch: rank 1 deliberately diverges on `sync` —
                 # bring-up must fatal NAMING the flag, not desync later
                 sync=(scenario in ("bsp", "bsp2")
                       or (scenario == "flagmismatch" and rank == 1)),
                 **extra)
    mv.init(**flags)
    assert mv.size() == world and mv.rank() == rank
    ctx = {"pkg": pkg, "outdir": outdir}
    SCENARIOS[scenario](mv, rank, world, ctx)
    mv.shutdown()
    if pkg == "torch":
        import torch.distributed as dist
        dist.destroy_process_group()
    print(f"MULTIHOST_CHILD_OK rank={rank} scenario={scenario}", flush=True)
    return 0


def _rank_adds(r: int, rows: int, cols: int):
    """Rank r's seeded integer row Adds of the ``async`` scenario."""
    rng = np.random.default_rng(100 + r)
    for _ in range(5):
        ids = rng.choice(rows, size=10, replace=False).astype(np.int32)
        yield ids, rng.integers(-3, 4, size=(10, cols)).astype(np.float32)


def run_async(mv, rank, world, ctx):
    """Plain async: every rank's sync Adds (its stripe of rows, then
    seeded integer row Adds) are visible to every rank after a barrier;
    whole-table and cross-shard row-subset Gets agree with the oracle."""
    rows, cols = 64, 24
    mat = mv.create_table("matrix", num_row=rows, num_col=cols)
    arr = mv.create_table("array", size=100)
    with mv.worker(0):
        my_rows = np.arange(rank, rows, world, dtype=np.int32)
        mat.add(np.full((len(my_rows), cols), rank + 1.0, np.float32),
                row_ids=my_rows)  # sync add: applied when it returns
        for ids, vals in _rank_adds(rank, rows, cols):
            mat.add(vals, row_ids=ids)
        arr.add(np.full(100, float(rank + 1), np.float32))
    mv.process_barrier()
    expect = np.zeros((rows, cols), np.float32)
    for r in range(world):
        expect[np.arange(r, rows, world)] = r + 1.0
    for r in range(world):
        for ids, vals in _rank_adds(r, rows, cols):
            expect[ids] += vals
    with mv.worker(0):
        got = mat.get()
        np.testing.assert_array_equal(got, expect)
        # row-subset get crossing every rank's shard, with a duplicate
        sel = np.array([0, 1, rows // 2, rows - 1, 1], np.int32)
        np.testing.assert_array_equal(mat.get(sel), expect[sel])
        got_arr = arr.get()
        np.testing.assert_array_equal(
            got_arr, np.full(100, sum(range(1, world + 1)), np.float32))
    if rank == 0 and ctx["outdir"]:
        np.savez(os.path.join(ctx["outdir"], f"{ctx['pkg']}_async.npz"),
                 mat=got, arr=got_arr)
    mv.process_barrier()


def run_bsp(mv, rank, world, ctx):
    """BSP across processes: worker w's round-i Get observes exactly i
    rounds of EVERY worker's Adds, with one worker per process."""
    rows, cols = 32, 8
    mat = mv.create_table("matrix", num_row=rows, num_col=cols)
    with mv.worker(0):
        for i in range(1, 5):
            mat.add(np.full((rows, cols), float(rank + 1), np.float32))
            got = mat.get()
            np.testing.assert_array_equal(
                got, np.full((rows, cols), i * sum(range(1, world + 1)),
                             np.float32), err_msg=f"round {i}")
        mat.finish_train()
    mv.process_barrier()


def run_bsp2(mv, rank, world, ctx):
    """BSP with two worker threads per process: global worker ids are
    rank * local_workers + slot, and the round contract holds over the
    whole worker grid."""
    rows, cols, rounds, workers = 16, 4, 3, 2 * world
    mat = mv.create_table("matrix", num_row=rows, num_col=cols)
    errors = []

    def work(slot):
        try:
            with mv.worker(slot):
                wid = rank * 2 + slot
                for i in range(1, rounds + 1):
                    mat.add(np.full((rows, cols), float(wid + 1), np.float32))
                    np.testing.assert_array_equal(
                        mat.get(), np.full((rows, cols),
                                           i * sum(range(1, workers + 1)),
                                           np.float32),
                        err_msg=f"worker {wid} round {i}")
                mat.finish_train()
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)

    _join(work, 2)
    assert not errors, errors
    mv.process_barrier()


def run_ssp(mv, rank, world, ctx):
    """SSP across processes: with staleness 1, every worker's round-i Get
    reflects at least round i-1 of EVERY worker's Adds."""
    rows, cols, rounds = 16, 4, 5
    s = int(mv.get_flag("ssp_staleness"))
    mat = mv.create_table("matrix", num_row=rows, num_col=cols)
    with mv.worker(0):
        for i in range(1, rounds + 1):
            mat.add(np.full((rows, cols), 1.0, np.float32))
            got = mat.get()
            lo = i + max(i - s, 0) * (world - 1)
            assert lo <= got[0, 0] <= rounds * world, (rank, i, got[0, 0])
        mat.finish_train()
    mv.process_barrier()


def run_checkpoint(mv, rank, world, ctx):
    """Live snapshot + live restore through the lockstep dispatcher: the
    leader's CheckpointDriver broadcasts the collective store read and the
    restore bytes; every rank rebuilds its own rows."""
    import tempfile
    if ctx["pkg"] == "jax":
        from multiverso_tpu.checkpoint import CheckpointDriver
    else:
        from multiverso_tpu_torch.checkpoint import CheckpointDriver
    rows, cols = 48, 16
    mat = mv.create_table("matrix", num_row=rows, num_col=cols,
                          updater_type="adagrad")
    base = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    with mv.worker(0):
        mat.add(base * (rank + 1))
    mv.process_barrier()
    with mv.worker(0):
        before = mat.get()
    driver = None
    if rank == 0:
        driver = CheckpointDriver([mat], tempfile.mkdtemp(prefix="mvckpt_"))
        driver.snapshot()
    mv.process_barrier()
    with mv.worker(0):
        mat.add(np.full((rows, cols), 10.0, np.float32))  # every rank adds
    mv.process_barrier()
    with mv.worker(0):
        moved = mat.get()
    assert not np.array_equal(moved, before)
    mv.process_barrier()
    if rank == 0:
        assert driver.restore(), "no snapshot found"
    mv.process_barrier()
    with mv.worker(0):
        np.testing.assert_array_equal(mat.get(), before,
                                      err_msg="restore did not rebuild the "
                                              "pre-snapshot state")
    mv.process_barrier()


def run_ctrlperf(mv, rank, world, ctx):
    """Bound + record the lockstep control plane's per-op cost: a sync row
    add from EVERY rank (followers pay forward -> leader execute ->
    broadcast -> replay -> ack). 250 ms is a broken-plane bound, not a
    performance target."""
    import time
    mat = mv.create_table("matrix", num_row=64, num_col=8)
    ones = np.ones((4, 8), np.float32)
    ids = np.arange(4, dtype=np.int32)
    with mv.worker(0):
        mat.add(ones, row_ids=ids)  # warm
        samples = []
        for _ in range(50):
            t0 = time.perf_counter()
            mat.add(ones, row_ids=ids)
            samples.append(time.perf_counter() - t0)
    med = sorted(samples)[len(samples) // 2]
    print(f"CTRL_OP_MEDIAN_US rank={rank} {med * 1e6:.1f}", flush=True)
    assert med < 0.25, f"lockstep ctrl op median {med * 1e3:.2f} ms"
    mv.process_barrier()
    with mv.worker(0):
        got = mat.get(ids)
    np.testing.assert_array_equal(got, np.full((4, 8), 51.0 * world))
    mv.process_barrier()


SCENARIOS = {"async": run_async, "bsp": run_bsp, "bsp2": run_bsp2,
             "ssp": run_ssp, "checkpoint": run_checkpoint,
             "ctrlperf": run_ctrlperf}


def _join(fn, n):
    threads = [threading.Thread(target=fn, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads), "worker thread hung"


def _register_more():
    """The scenarios of the sibling files live there: the runner imports
    them when asked for a scenario this file does not hold."""
    scenario = sys.argv[5].split(":")[1]
    if scenario in SCENARIOS:
        return
    sys.path.insert(0, os.path.dirname(RUNNER))
    for name in ("test_torch_multihost_w2v", "test_torch_multihost_modes"):
        SCENARIOS.update(__import__(name).SCENARIOS)


if __name__ == "__main__":
    _register_more()
    raise SystemExit(main())


# -- the tests ----------------------------------------------------------------

import pytest  # noqa: E402

from multiverso_tpu_torch.runtime.multihost import (  # noqa: E402
    spawn_lockstep_world)

#: one torch thread per rank (the CPU torch build stalls under load with
#: its intra-op pool; see tests/test_torch_sync.py)
CHILD_ENV = {"OMP_NUM_THREADS": "1"}


def port_world(scenario, world=2, timeout=300, expect=None, outdir=""):
    spec = f"torch:{scenario}" + (f":{outdir}" if outdir else "")
    return spawn_lockstep_world(RUNNER, spec, world=world, timeout=timeout,
                                expect=expect, env=CHILD_ENV)


def jax_world(scenario, world=2, timeout=300, outdir=""):
    from multiverso_tpu.runtime.multihost import (
        spawn_lockstep_world as jax_spawn)
    spec = f"jax:{scenario}" + (f":{outdir}" if outdir else "")
    return jax_spawn(RUNNER, spec, world=world, timeout=timeout)


def test_multihost_async_add_get_matches_jax(tmp_path):
    """Async mode, two ranks: each rank's sync Adds land on the row-split
    table; whole-table and cross-shard row-subset Gets agree on every
    rank, and the port's final logical tables equal the JAX package's
    two-process world's bit for bit (integer deltas)."""
    jax_world("async", outdir=str(tmp_path))
    port_world("async", outdir=str(tmp_path))
    want = np.load(tmp_path / "jax_async.npz")
    got = np.load(tmp_path / "torch_async.npz")
    np.testing.assert_array_equal(got["mat"], want["mat"])
    np.testing.assert_array_equal(got["arr"], want["arr"])


def test_multihost_bsp_contract():
    """BSP across processes: worker w's round-i Get observes exactly i
    rounds of every worker's Adds."""
    port_world("bsp")


def test_multihost_checkpoint_snapshot_restore():
    """Live snapshot + restore of a row-split AdaGrad table: the leader
    writes the file, every rank takes part in the read; the restore
    rebuilds every rank's rows bit for bit."""
    port_world("checkpoint")


def test_multihost_three_process_world():
    """World 3 (leader + 2 followers; 64 rows split 21/21/22): barrier
    arithmetic, ack routing and the row exchange beyond two ranks."""
    port_world("async", world=3)


def test_multihost_four_process_bsp_contract():
    """World 4: the BSP round contract with the leader fanning out to three
    followers per descriptor."""
    port_world("bsp", world=4)


def test_multihost_ctrl_plane_cost_bounded():
    """Per-op lockstep control-plane cost on every rank of a 4-process
    world, bounded loosely as a broken-plane guard."""
    outs = port_world("ctrlperf", world=4)
    assert all("CTRL_OP_MEDIAN_US" in out for out in outs)


def test_multihost_bsp_two_workers_per_process():
    """BSP with 2 worker threads per process x 2 processes: the round
    contract over the whole 4-worker grid."""
    port_world("bsp2")


# -- units --------------------------------------------------------------------

def _hello_flags(registry_set):
    registry_set("sync", True)
    registry_set("ssp_staleness", 2)
    registry_set("local_workers", 3)
    registry_set("updater_type", "adagrad")
    registry_set("backup_worker_ratio", 0.25)
    registry_set("mesh_shape", "2x1")
    registry_set("mesh_axes", "server,model")
    registry_set("multihost_token", "s3cret")


@pytest.fixture
def both_flags():
    from multiverso_tpu.config import FLAGS as JAX_FLAGS
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
    JAX_FLAGS.reset()
    TORCH_FLAGS.reset()
    try:
        yield JAX_FLAGS, TORCH_FLAGS
    finally:
        JAX_FLAGS.reset()
        TORCH_FLAGS.reset()


@pytest.mark.parametrize("custom", [False, True], ids=["defaults", "set"])
def test_hello_frame_bytes_match_jax(both_flags, custom):
    """Same flags and token: the port's hello frame is the JAX package's
    byte for byte, in both directions of the check."""
    from multiverso_tpu.runtime import multihost as jmh
    from multiverso_tpu_torch.runtime import multihost as tmh
    jflags, tflags = both_flags
    if custom:
        _hello_flags(jflags.set)
        _hello_flags(tflags.set)
    for rank, world in ((0, 2), (3, 4)):
        frame = tmh._hello_frame(rank, world)
        assert frame == jmh._hello_frame(rank, world)
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            got_rank, info = tmh._read_hello(b)
        finally:
            a.close()
            b.close()
        assert got_rank == rank and info["world"] == world
        tmh._check_uniform_flags("peer", info, world)


def _read(tmh, data: bytes):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.shutdown(socket.SHUT_WR)
        return tmh._read_hello(b)
    finally:
        a.close()
        b.close()


def test_hello_rejects_garbage_and_wrong_token_without_unpickling(both_flags,
                                                                  monkeypatch):
    """Garbage, a truncated frame, a forged header and a frame keyed on
    another token are all dropped (None), and nothing is unpickled."""
    import pickle
    from multiverso_tpu_torch.runtime import multihost as tmh
    _, tflags = both_flags

    def no_unpickle(*a, **k):
        raise AssertionError("the handshake unpickled input")

    monkeypatch.setattr(pickle, "loads", no_unpickle)
    good = tmh._hello_frame(1, 2)
    assert _read(tmh, good) is not None
    assert _read(tmh, b"GET / HTTP/1.1\r\n\r\n" + b"x" * 64) is None
    assert _read(tmh, good[:-5]) is None
    evil = pickle.dumps(("exec", 1))
    assert _read(tmh, tmh._HELLO_HDR.pack(b"MVMH", 2, 1, len(evil)) + evil
                 + b"\0" * 32) is None
    assert _read(tmh, tmh._HELLO_HDR.pack(b"MVMH", 2, 1, 1 << 20)) is None
    tflags.set("multihost_token", "other")
    assert _read(tmh, good) is None


def test_flag_mismatch_names_the_flag(both_flags):
    from multiverso_tpu_torch import log
    from multiverso_tpu_torch.runtime import multihost as tmh
    _, tflags = both_flags
    info = {"world": 2, "flags": tmh._uniform_flags()}
    tflags.set("sync", True)
    with pytest.raises(log.FatalError, match="-sync=False vs local True"):
        tmh._check_uniform_flags("follower rank 1", info, 2)
    with pytest.raises(log.FatalError, match="world of 3"):
        tmh._check_uniform_flags("follower rank 1", dict(info, world=3), 2)


def test_parse_mesh_shape_and_rank_mesh():
    from multiverso_tpu_torch import log
    from multiverso_tpu_torch.parallel import mesh
    assert mesh.parse_mesh_shape("") is None
    assert mesh.parse_mesh_shape(" 2x4 ") == (2, 4)
    assert mesh.parse_mesh_shape("2*2x1") == (2, 2, 1)
    m = mesh.build_mesh(4)
    assert m.shape == {"server": 4} and m.size == 4
    m = mesh.build_mesh(4, shape=(2, 2), axis_names=("server", "model"))
    assert m.shape == {"server": 2, "model": 2}
    np.testing.assert_array_equal(m.ranks, [[0, 1], [2, 3]])
    with pytest.raises(log.FatalError, match="holds 6 ranks"):
        mesh.build_mesh(4, shape=(2, 3), axis_names=("a", "b"))
    with pytest.raises(log.FatalError, match="mesh_axes"):
        mesh.build_mesh(4, shape=(4,), axis_names=("a", "b"))


@pytest.mark.parametrize("total,world", [(64, 2), (64, 3), (10, 4), (3, 4),
                                         (1_000_000, 2)])
def test_rank_row_ranges_cover_the_table(total, world):
    """Equal chunks, the remainder on the last rank; the ranges tile
    [0, total) in rank order, as the JAX package's shard_ranges."""
    from multiverso_tpu.parallel import mesh as jmesh
    from multiverso_tpu_torch.parallel import mesh
    ranges = [mesh.table_sharding(total, r, world) for r in range(world)]
    assert ranges == jmesh.shard_ranges(total, world)
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    chunk = total // world
    assert all(hi - lo == chunk for lo, hi in ranges[:-1])
    assert mesh.replicated(total) == (0, total)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_init_range_rank_rows_match_one_process_draw(monkeypatch, world):
    """A rank draws only the row blocks that meet its range, each from its
    own seed, and its rows equal the one-process draw's bit for bit: 2-row
    blocks here, so every range cuts a block."""
    import torch
    from multiverso_tpu_torch.parallel import mesh
    from multiverso_tpu_torch.tables import matrix_table as mt
    monkeypatch.setattr(mt, "_INIT_BLOCK_VALUES", 12)
    num_row, num_col, rng = 11, 5, (-0.5, 0.5)
    whole = torch.empty(num_row, num_col)
    mt.draw_range_rows(whole, 0, num_row, rng, 3)
    drawn = []
    real = torch.Tensor.uniform_
    monkeypatch.setattr(torch.Tensor, "uniform_", lambda t, *a, **k: (
        drawn.append(t.shape[0]) or real(t, *a, **k)))
    for lo, hi in mesh.shard_ranges(num_row, world):
        mine = torch.empty(hi - lo, num_col)
        mt.draw_range_rows(mine, lo, num_row, rng, 3)
        assert mine.numpy().tobytes() == whole[lo:hi].numpy().tobytes()
        assert max(drawn) <= 2  # one block at a time, never the table
    assert (whole >= -0.5).all() and (whole <= 0.5).all()
    assert len({whole[i].numpy().tobytes() for i in range(0, num_row, 2)}
               ) == 6  # each block's seed differs


def test_init_range_one_block_keeps_the_table_seed():
    """A table of at most one block is the plain draw from its seed."""
    import torch
    from multiverso_tpu_torch.tables import matrix_table as mt
    out = torch.empty(20, 5)
    mt.draw_range_rows(out, 0, 20, (-0.5, 0.5), 3)
    want = torch.empty(20, 5).uniform_(
        -0.5, 0.5, generator=torch.Generator().manual_seed(3))
    assert out.numpy().tobytes() == want.numpy().tobytes()


def _fake_ranks(world):
    from multiverso_tpu_torch.runtime.multihost import MultihostRuntime
    ranks = []
    for r in range(world):
        rt = MultihostRuntime.__new__(MultihostRuntime)
        rt.rank, rt.world = r, world
        ranks.append(rt)
    return ranks


def _exchange(ranks, call):
    """Run ``call(rt)`` on every fake rank twice: once recording each
    rank's send, once with ``_all_gather`` answering every rank's send."""
    sends = {}
    for rt in ranks:
        rt._all_gather = lambda arr, r=rt.rank: (sends.__setitem__(r, arr)
                                                 or [arr] * rt.world)
        call(rt)
    outs = []
    for rt in ranks:
        rt._all_gather = lambda arr: [sends[r] for r in range(rt.world)]
        outs.append(call(rt))
    return sends, outs


def test_exchange_rows_selects_by_owner_bitwise():
    """Each rank sends only its owned rows, padded to the largest rank's
    count; every rank places each rank's rows at that rank's positions — a
    select, so -0.0 and NaN survive bit for bit (a zero-padded sum would
    turn -0.0 into +0.0)."""
    owner = np.array([1, 0, 1, 1, 0])
    full = np.array([[-0.0, 1], [2, np.nan], [3, -0.0], [4, 5], [6, 7]],
                    np.float32)
    sends, outs = _exchange(
        _fake_ranks(2), lambda rt: rt.exchange_rows(owner,
                                                    full[owner == rt.rank]))
    assert [sends[r].shape for r in (0, 1)] == [(3, 2), (3, 2)]
    for got in outs:
        assert got.tobytes() == full.tobytes()


def test_assemble_concatenates_rank_ranges():
    """Whole reads: each rank's range (uneven: the remainder on the last),
    along any axis (updater state keeps its worker axis first)."""
    full = np.arange(2 * 5, dtype=np.float32).reshape(2, 5)
    ranges = [(0, 2), (2, 5)]
    _, outs = _exchange(
        _fake_ranks(2), lambda rt: rt.assemble(
            full[:, slice(*ranges[rt.rank])], ranges, axis=1))
    for got in outs:
        np.testing.assert_array_equal(got, full)


def test_allreduce_host_sums_leader_first_then_ranks_in_order():
    """The leader adds the followers' leaves in rank order onto its own,
    whatever order they arrived in: float32 addition does not associate,
    and the result is that order's bits (reference order: leader, 1, 2)."""
    from multiverso_tpu_torch.runtime.multihost import MultihostRuntime
    rt = MultihostRuntime.__new__(MultihostRuntime)
    rt.rank, rt.world, rt._timeout = 0, 3, 5.0
    rt._poisoned = None
    rt._agg_seq = 0
    rt._agg_cv = threading.Condition()
    rt._writers = {}
    big, tiny = np.float32(1e8), np.float32(3.0)
    # rank 2 deposits first; the sum must still be (leader + r1) + r2
    rt._agg_contrib = {2: (1, [np.array([tiny], np.float32)]),
                       1: (1, [np.array([-big], np.float32)])}
    out = rt.allreduce_host([np.array([big], np.float32)])
    want = (np.float32(big) + np.float32(-big)) + tiny
    assert out[0].tobytes() == np.array([want], np.float32).tobytes()
    assert out[0][0] == 3.0  # the other order, big + tiny - big, gives 0.0
