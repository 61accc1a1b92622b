"""The port's table slice as a whole, against the JAX package.

Each scenario (taken from test_matrix_table.py / test_array_table.py) runs
through the public API of both packages — ``mv`` (JAX, on its 8-device
virtual CPU mesh) and ``mvt`` (torch, ``device="cpu"``) — and every
result is compared. Float results agree within rtol 1e-6 unless stated:
the port merges duplicate row ids before every row Add, where the JAX CPU
path scatters them, so sums may differ in order only. Staleness bitmaps,
ids and integer tables compare exactly."""

import threading

import numpy as np
import pytest

import multiverso_tpu as mv
import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard as TorchDashboard

PKGS = (mv, mvt)


@pytest.fixture
def both():
    """Start both runtimes; the port's is stopped here (tests/conftest.py
    stops only the JAX one)."""
    yield from _start(1)


@pytest.fixture
def both4():
    yield from _start(4)


def _start(local_workers):
    TORCH_FLAGS.reset()
    TorchDashboard.reset()
    mv.init(local_workers=local_workers)
    try:
        mvt.init(device="cpu", local_workers=local_workers)
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def _run(scenario):
    """The scenario's outputs from both packages, as numpy."""
    return [[np.asarray(x) for x in scenario(pkg)] for pkg in PKGS]


def _assert_same(jax_out, torch_out, exact=False):
    assert len(jax_out) == len(torch_out)
    for j, t in zip(jax_out, torch_out):
        assert t.shape == j.shape and t.dtype == j.dtype
        if exact:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)


def test_whole_get_add(both):
    def scenario(pkg):
        table = pkg.create_table("matrix", 6, 4, np.float32)
        out = [table.get()]
        delta = np.arange(24, dtype=np.float32).reshape(6, 4)
        table.add(delta)
        table.add(delta)
        return out + [table.get()]

    _assert_same(*_run(scenario))


def test_row_get_add_and_duplicates(both):
    def scenario(pkg):
        rng = np.random.default_rng(5)
        table = pkg.create_table("matrix", 10, 3, np.float32)
        table.add(rng.normal(size=(10, 3)).astype(np.float32))
        out = [table.get(np.array([7, 2, 9]))]
        table.add(np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32),
                  row_ids=np.array([1, 5]))
        # duplicate ids accumulate
        table.add(np.ones((4, 3), np.float32), row_ids=np.array([1, 1, 3, 1]))
        return out + [table.get(), table.get(np.array([1, 1, 0]))]

    _assert_same(*_run(scenario))


@pytest.mark.parametrize("updater", ["sgd", "momentum_sgd", "adagrad", "dcasgd"])
def test_row_add_updaters(both, updater):
    def scenario(pkg):
        rng = np.random.default_rng(9)
        table = pkg.create_table("matrix", 6, 2, np.float32, updater_type=updater)
        opt = pkg.AddOption(learning_rate=0.5, rho=0.1, momentum=0.5, worker_id=0)
        out = []
        for _ in range(3):
            ids = rng.integers(0, 6, 4)  # duplicates included
            table.add(rng.normal(size=(4, 2)).astype(np.float32), row_ids=ids,
                      option=opt)
            out.append(table.get())
        table.add(np.ones((6, 2), np.float32), option=opt)  # whole-table form
        return out + [table.get()]

    _assert_same(*_run(scenario))


def test_random_init_range(both):
    """Shape and range only: the two packages draw from different
    generators."""
    for pkg in PKGS:
        out = pkg.create_table("matrix", 20, 5, np.float32,
                               init_range=(-0.5, 0.5), seed=3).get()
        assert out.shape == (20, 5)
        assert (out >= -0.5).all() and (out <= 0.5).all()
        assert np.abs(out).sum() > 0


def test_int_dtype(both):
    def scenario(pkg):
        table = pkg.create_table("matrix", 4, 4, np.int32)
        table.add(np.full((4, 4), 2, np.int32))
        table.add(np.full((2, 4), -7, np.int32), row_ids=[3, 0])
        arr = pkg.create_table("array", 16, np.int32)
        arr.add(np.full(16, 3, np.int32))
        arr.add(np.arange(16, dtype=np.int32))
        return [table.get(), table.get([0, 0]), arr.get()]

    _assert_same(*_run(scenario), exact=True)


def test_sparse_stale_row_gets(both):
    """gen-2 up_to_date_ semantics: a sparse Get ships only rows touched
    since this worker's last Get; admin Gets bypass the bitmap."""
    def scenario(pkg):
        table = pkg.create_table("matrix", 6, 2, np.float32, is_sparse=True)
        st = table._server_table
        table.add(np.ones((6, 2), np.float32))
        out = [table.get(), st._up_to_date.copy()]
        table.add(np.full((2, 2), 5.0, np.float32), row_ids=np.array([1, 3]))
        out += [st._up_to_date.copy(), table.get(), st._up_to_date.copy()]
        delta = np.zeros((6, 2), np.float32)
        delta[[0, 4]] = 2.0  # whole-table Add ships only its nonzero rows
        table.add(delta)
        out += [st._up_to_date.copy(), table.get(row_ids=np.array([4])),
                table.get(option=pkg.GetOption(worker_id=-1)),
                st._up_to_date.copy(), table.get(), table.rows_pulled,
                st._sparse_get(pkg.GetOption(worker_id=0))[0]]
        return out

    _assert_same(*_run(scenario), exact=True)


def test_pipelined_planes(both):
    def scenario(pkg):
        table = pkg.create_table("matrix", 4, 2, np.float32, is_sparse=True,
                                 is_pipelined=True)
        st = table._server_table
        table.add(np.ones((4, 2), np.float32))
        out = [table.get(), st._up_to_date.copy(), table.get(),
               st._up_to_date.copy()]
        table.add(np.full((1, 2), 3.0, np.float32), row_ids=[2])
        out += [st._up_to_date.copy(), table.get(), table.get(),
                st._up_to_date.copy()]
        return out

    _assert_same(*_run(scenario), exact=True)


@pytest.mark.parametrize("op", ["get", "add"])
def test_out_of_range_id_is_fatal(both, op):
    for pkg in PKGS:
        table = pkg.create_table("matrix", 4, 2, np.float32)
        with pytest.raises(pkg.log.FatalError):
            if op == "get":
                table.get(np.array([4]))
            else:
                table.add(np.ones((1, 2), np.float32), row_ids=[-1])
        np.testing.assert_array_equal(table.get(), np.zeros((4, 2)))


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd", "adagrad"])
def test_array_table(both, updater):
    def scenario(pkg):
        table = pkg.create_table("array", 13, np.float32, updater_type=updater,
                                 init_value=np.linspace(0, 1, 13).astype(np.float32))
        opt = pkg.AddOption(momentum=0.5, learning_rate=0.3, rho=0.1)
        out = [table.get()]
        for k in range(3):
            table.add(np.full(13, k + 1.5, np.float32), option=opt)
            out.append(table.get())
        handles = [table.add_async(np.ones(13, np.float32), option=opt)
                   for _ in range(3)]
        for h in handles:
            table.wait(h)
        return out + [table.get()]

    _assert_same(*_run(scenario))


def test_device_reads_are_copies(both):
    """The port updates tables in place, so every device read it hands out
    is a copy that later Adds do not change (JAX arrays are immutable)."""
    matrix = mvt.create_table("matrix", 8, 4, np.float32)
    array = mvt.create_table("array", 8, np.float32)
    snaps = [matrix.get_device(), array.get_device(),
             array.wait(array.get_device_async()),
             matrix.wait_device(matrix.get_device_async([1, 2]), [1, 2])]
    matrix.add(np.ones((8, 4), np.float32))
    array.add(np.ones(8, np.float32))
    for snap in snaps:
        assert not snap.any()
    assert matrix.get().sum() == 32 and array.get().sum() == 8


def test_raw_transaction_spans_tables(both):
    """A raw-callable device transaction reads and writes two tables in one
    dispatcher op; the port's fn may update the tensors in place. Refused on
    sparse tables, as in the reference."""
    a = mvt.create_table("matrix", 8, 4, np.float32)
    b = mvt.create_table("matrix", 8, 4, np.float32)
    a.add(np.ones((8, 4), np.float32))

    def fn(datas, states, scale):
        datas[1][:8] += scale * datas[0][:8]
        datas[0][:8] *= 0
        return datas, states, datas[1][:8, :4].sum()

    extra = a.wait(a.transact_device_async(fn, [b], args=(3.0,)))
    assert float(extra) == 96.0
    np.testing.assert_array_equal(a.get(), np.zeros((8, 4)))
    np.testing.assert_array_equal(b.get(), np.full((8, 4), 3.0))
    sparse = mvt.create_table("matrix", 8, 4, np.float32, is_sparse=True)
    with pytest.raises(mvt.log.FatalError):
        sparse.transact_device_async(fn, [])
    with pytest.raises(mvt.log.FatalError):
        a.transact_device_async(fn, [sparse])


def test_multi_worker_end_to_end(both4):
    """4 worker threads x 6 rounds of 64-256-row Adds (duplicates included)
    and row Gets through each package's dispatcher. The final tables agree
    with each other and with a float64 mirror within rtol 1e-5 (fp32 sums
    in another order); the port's dispatcher fused Adds."""
    num_row, num_col, rounds = 300, 8, 6

    def batches(w):
        rng = np.random.default_rng([11, w])
        for _ in range(rounds):
            n = int(rng.integers(64, 257))
            yield (rng.integers(0, num_row, n).astype(np.int32),
                   rng.normal(size=(n, num_col)).astype(np.float32))

    def drive(pkg):
        table = pkg.create_table("matrix", num_row, num_col, np.float32)
        errors = []
        # hold the dispatcher until every worker has queued its first Adds,
        # so at least one drain finds a backlog to fuse
        gate = threading.Event()
        blocker = threading.Thread(target=pkg.Zoo.instance().server.run_serialized,
                                   args=(lambda: gate.wait(30),))
        blocker.start()

        def work(w):
            try:
                with pkg.worker(w):
                    for r, (ids, vals) in enumerate(batches(w)):
                        if r < 2:
                            table.add_async(vals, row_ids=ids)
                            continue
                        table.add(vals, row_ids=ids)
                        got = table.get(ids[:64])
                        assert got.shape == (64, num_col)
            except BaseException as exc:
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        queue = pkg.Zoo.instance().server._queue
        for _ in range(3000):  # at most 30 s
            if queue.size() >= 8 or errors:
                break
            threading.Event().wait(0.01)
        gate.set()
        for t in threads + [blocker]:
            t.join(timeout=60)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        return table.get()

    mirror = np.zeros((num_row, num_col))
    for w in range(4):
        for ids, vals in batches(w):
            np.add.at(mirror, ids, vals)
    jax_final, torch_final = drive(mv), drive(mvt)
    np.testing.assert_allclose(jax_final, mirror, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch_final, mirror, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch_final, jax_final, rtol=1e-5, atol=1e-5)
    assert TorchDashboard.counter_value("APPLY_FUSED_CALLS") >= 1
    assert TorchDashboard.counter_value("APPLY_BATCHED_MSGS") >= 2


@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_named_transaction_row_apply_matches(both, updater):
    """A program registered by name runs as a device transaction and
    applies rows through the table's row_apply_traceable: linear updaters
    as one row scatter (sign folded in), stateful ones as the row update.
    Both packages end with the same table."""
    from multiverso_tpu.runtime import programs as jprograms
    from multiverso_tpu_torch.runtime import programs as tprograms
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    n_row, n_col = 100, 6
    init = rng.normal(size=(n_row, n_col)).astype(np.float32)
    ids = np.full(64, n_row, np.int32)  # a bucket of 64, pads on the sentinel
    ids[:20] = rng.choice(n_row, 20, replace=False)
    delta = np.zeros((64, n_col), np.float32)
    delta[:20] = rng.normal(size=(20, n_col))

    def run(pkg, programs, pad, asarray):
        a = pkg.create_table("matrix", n_row, n_col, np.float32,
                             updater_type=updater, init_value=init)
        b = pkg.create_table("matrix", n_row, n_col, np.float32)
        srv = a._server_table
        apply = srv.row_apply_traceable()
        worker, scalars = srv._option_consts(pkg.AddOption(learning_rate=0.3))

        def fn(datas, states, ids_d, delta_d):
            data, st = apply(datas[0], states[0], ids_d,
                             pad(delta_d, srv.padded_cols), worker, scalars)
            return [data, datas[1]], [st, states[1]], None

        name = programs.register_program(f"test.rows/{pkg.__name__}", fn)
        assert name in programs.registered_programs()
        a.wait(a.transact_device_async(name, [b], args=(asarray(ids), delta)))
        return a.get(), b.get()

    want = run(mv, jprograms, lambda d, pc: jnp.pad(
        jnp.asarray(d), ((0, 0), (0, pc - n_col))), jnp.asarray)
    got = run(mvt, tprograms, lambda d, pc: torch.nn.functional.pad(
        torch.from_numpy(d), (0, pc - n_col)), torch.from_numpy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert not np.allclose(got[0], init)
    with pytest.raises(mvt.log.FatalError, match="unknown device program"):
        tprograms.resolve_program("test.no-such-program")


def test_shutdown_clears_named_programs():
    """A registered program closes over its tables; ``mvt.shutdown`` drops
    it so a stopped runtime's tables are not kept alive."""
    from multiverso_tpu_torch.runtime import programs as tprograms

    TORCH_FLAGS.reset()
    mvt.init(device="cpu")
    try:
        t = mvt.create_table("matrix", 10, 4)
        tprograms.register_program("test.holds-a-table", lambda *a: t)
        assert "test.holds-a-table" in tprograms.registered_programs()
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
    assert tprograms.registered_programs() == []
    with pytest.raises(mvt.log.FatalError, match="unknown device program"):
        tprograms.resolve_program("test.holds-a-table")
