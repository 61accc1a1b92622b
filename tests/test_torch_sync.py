"""The port's consistency servers (BSP, SSP, deterministic) against the JAX
package's.

Each scenario of ``tests/test_sync.py`` runs through the public API of
both packages — ``mv`` (JAX, on the CPU) and ``mvt`` (torch,
``device="cpu"``) — from the same numpy inputs, and what the contract
fixes compares exactly: every value a BSP round observes, the server's
final add and get clocks, the stall report's text, which worker finished,
the order of events around a parked SSP Get. SSP values that depend on
thread timing are held to the contract's bounds in both packages.

The twins of ``tests/test_apply_batch.py`` compare the servers' capability
flags and a deterministic run's final table, bitwise. The gated word2vec
tests of ``tests/test_word2vec.py`` run on both servers; the port's
trainer also trains under BSP, where the JAX trainer hangs (its word-count
table only takes Adds, so its second BSP round never opens). Two port runs
under ``-deterministic`` with different thread timing end bitwise equal,
to each other, to a numpy mirror applied in (round, worker) order and to
the JAX package."""

import threading
import time

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.config import FLAGS as JAX_FLAGS
from multiverso_tpu.dashboard import Dashboard as JaxDashboard
from multiverso_tpu.runtime import server as jserver
from multiverso_tpu.runtime.zoo import Zoo as JZoo

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard as TorchDashboard
from multiverso_tpu_torch.runtime import server as tserver
from multiverso_tpu_torch.runtime.zoo import Zoo as TZoo

JOIN_S = 60


@pytest.fixture(autouse=True)
def port_flags():
    """Flags stick across shutdown: each test starts the port from its
    defaults and leaves no runtime behind (tests/conftest.py resets only
    the JAX package). Worker threads and the dispatcher run torch's CPU ops
    here in turns; with torch's intra-op thread pool on a loaded machine
    those hand-offs can stall for minutes, so the tests' tiny tensors run
    on one intra-op thread."""
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


def _init(pkg, **flags):
    if pkg is mvt:
        mvt.init(device="cpu", **flags)
    else:
        mv.init(**flags)


def _stop(pkg):
    pkg.shutdown()
    (TORCH_FLAGS if pkg is mvt else JAX_FLAGS).reset()


def _server(pkg):
    return (TZoo if pkg is mvt else JZoo).instance().server


def _clocks(pkg, table):
    srv = _server(pkg)
    return (list(srv._add_clock[table.table_id]),
            list(srv._get_clock[table.table_id]))


def _run_workers(n, fn):
    """Run ``fn(slot)`` on n threads; fail (never hang) if one does not
    finish, and re-raise the first error a thread hit."""
    errors = []

    def guarded(slot):
        try:
            fn(slot)
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=(s,), daemon=True)
               for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    if errors:
        raise errors[0]


def _once(pkg, scenario):
    try:
        return scenario(pkg)
    finally:
        _stop(pkg)


def _both(scenario):
    """The scenario's result from the JAX package, then from the port."""
    return [_once(pkg, scenario) for pkg in (mv, mvt)]


def _assert_equal(jax_out, torch_out):
    assert type(jax_out) is type(torch_out)
    if isinstance(jax_out, dict):
        assert jax_out.keys() == torch_out.keys()
        for k in jax_out:
            _assert_equal(jax_out[k], torch_out[k])
    elif isinstance(jax_out, (list, tuple)):
        assert len(jax_out) == len(torch_out)
        for j, t in zip(jax_out, torch_out):
            _assert_equal(j, t)
    elif isinstance(jax_out, np.ndarray):
        assert jax_out.dtype == torch_out.dtype
        np.testing.assert_array_equal(torch_out, jax_out)
    else:
        assert torch_out == jax_out


# -- BSP (test_sync.py) -------------------------------------------------------

def test_make_server_picks_each_consistency_server():
    for argv, name in ((["-sync=true"], "SyncServer"),
                       (["-ssp_staleness=2"], "SSPServer"),
                       (["-deterministic=true"], "DeterministicServer"),
                       ([], "Server")):
        TORCH_FLAGS.reset()
        mvt.init(argv, device="cpu")
        try:
            assert type(_server(mvt)).__name__ == name
        finally:
            mvt.shutdown()


def test_sync_rounds_observe_all_workers():
    workers, rounds, size = 4, 5, 8

    def scenario(pkg):
        _init(pkg, sync=True, local_workers=workers)
        table = pkg.create_table("array", size, np.float32)
        results = {}

        def run(slot):
            with pkg.worker(slot):
                out = []
                for _ in range(rounds):
                    table.add(np.ones(size, np.float32))
                    out.append(table.get().copy())
                results[slot] = out

        _run_workers(workers, run)
        return {s: results[s] for s in range(workers)}, _clocks(pkg, table)

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    for outs in torch_out[0].values():
        for i, val in enumerate(outs):
            np.testing.assert_array_equal(
                val, np.full(size, (i + 1) * workers, np.float32))
    assert torch_out[1] == ([rounds] * workers, [rounds] * workers)


def test_sync_get_identical_across_workers():
    workers = 3

    def scenario(pkg):
        _init(pkg, sync=True, local_workers=workers)
        table = pkg.create_table("array", 4, np.float32)
        seen = {}

        def run(slot):
            with pkg.worker(slot):
                table.add(np.full(4, float(slot + 1), np.float32))
                seen[slot] = table.get().copy()

        _run_workers(workers, run)
        return {s: seen[s] for s in range(workers)}

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    for slot in range(workers):
        np.testing.assert_array_equal(torch_out[slot], np.full(4, 6.0, np.float32))


def test_finish_train_releases_peers():
    def scenario(pkg):
        _init(pkg, sync=True, local_workers=2)
        table = pkg.create_table("array", 4, np.float32)
        done = {}

        def run(slot):
            with pkg.worker(slot):
                for _ in range(1 if slot == 0 else 3):
                    table.add(np.ones(4, np.float32))
                    table.get()
                table.finish_train()
                done[slot] = True

        _run_workers(2, run)
        # admin read: past every round, outside the clocks
        with (TZoo if pkg is mvt else JZoo).instance().admin():
            final = table.get()
        return dict(sorted(done.items())), _clocks(pkg, table), final

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    assert torch_out[0] == {0: True, 1: True}
    np.testing.assert_array_equal(torch_out[2], np.full(4, 4.0, np.float32))


def test_backup_worker_ratio_ignores_straggler():
    rounds = 4

    def scenario(pkg):
        _init(pkg, sync=True, local_workers=2, backup_worker_ratio=0.5)
        table = pkg.create_table("array", 4, np.float32)
        vals = []

        def run(slot):
            if slot == 1:
                return  # straggler: never adds, never gets
            with pkg.worker(slot):
                for _ in range(rounds):
                    table.add(np.ones(4, np.float32))
                    vals.append(table.get().copy())

        _run_workers(2, run)
        return vals, _clocks(pkg, table)

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    for i, val in enumerate(torch_out[0]):
        np.testing.assert_array_equal(val, np.full(4, float(i + 1), np.float32))
    assert torch_out[1] == ([rounds, 0], [rounds, 0])


def test_sync_stall_watchdog_names_lagging_worker():
    def scenario(pkg):
        _init(pkg, sync=True, local_workers=2, sync_stall_seconds=0.2)
        table = pkg.create_table("array", 4, np.float32)
        server = _server(pkg)
        assert server.last_stall is None

        def run_fast():
            with pkg.worker(0):
                table.add(np.ones(4, np.float32))
                table.get()  # defers: worker 1's round-1 Add never arrives

        t = threading.Thread(target=run_fast, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while server.last_stall is None and time.monotonic() < deadline:
            time.sleep(0.05)
        stall = server.last_stall
        with pkg.worker(1):
            table.finish_train()  # releases the stalled round
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        return stall

    jax_out, torch_out = _both(scenario)
    assert torch_out is not None, "watchdog never fired"
    assert torch_out == jax_out
    assert "worker(s) [1]" in torch_out and "deferred gets" in torch_out


def test_async_mode_no_round_blocking():
    def scenario(pkg):
        _init(pkg)
        table = pkg.create_table("array", 4, np.float32)
        for _ in range(10):
            table.add(np.ones(4, np.float32))
        return table.get()

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    np.testing.assert_array_equal(torch_out, np.full(4, 10.0, np.float32))


# -- SSP ----------------------------------------------------------------------

def _ssp_rounds(pkg, workers, rounds, size, staleness):
    _init(pkg, ssp_staleness=staleness, local_workers=workers, sync=False)
    table = pkg.create_table("array", size, np.float32)
    results = {}

    def run(slot):
        with pkg.worker(slot):
            out = []
            for _ in range(rounds):
                table.add(np.ones(size, np.float32))
                out.append(float(table.get()[0]))
            table.finish_train()
            results[slot] = out

    _run_workers(workers, run)
    with (TZoo if pkg is mvt else JZoo).instance().admin():
        final = table.get()
    return results, _clocks(pkg, table), final


@pytest.mark.parametrize("staleness,workers,rounds", [(1, 3, 6), (0, 3, 4)])
def test_ssp_rounds_within_staleness_bound(staleness, workers, rounds):
    """staleness=1 lets a fast worker lead by one round; staleness=0 is the
    BSP read bound (without Add deferral). Observed values depend on
    timing; the bound, the final clocks and the final table do not."""
    size = 8
    outs = _both(lambda pkg: _ssp_rounds(pkg, workers, rounds, size, staleness))
    for results, clocks, final in outs:
        for slot, vals in results.items():
            for i, val in enumerate(vals):
                lo = (i + 1) + max(i + 1 - staleness, 0) * (workers - 1)
                assert lo <= val <= rounds * workers, (slot, i, val)
        assert clocks == ([rounds] * workers, [rounds] * workers)
        np.testing.assert_array_equal(final, np.full(size, rounds * workers,
                                                     np.float32))


def test_ssp_fast_worker_blocks_beyond_staleness():
    def scenario(pkg):
        _init(pkg, ssp_staleness=1, local_workers=2, sync=False)
        table = pkg.create_table("array", 4, np.float32)
        events = []
        slow_may_continue = threading.Event()

        def fast():
            with pkg.worker(0):
                table.add(np.ones(4, np.float32))
                table.get()            # round 1, needs min_adds >= 0
                table.add(np.ones(4, np.float32))
                table.get()            # round 2, needs min_adds >= 1
                events.append("fast-before-release")
                slow_may_continue.set()
                table.add(np.ones(4, np.float32))
                events.append(("fast-round3-get", float(table.get()[0])))

        def slow():
            with pkg.worker(1):
                table.add(np.ones(4, np.float32))  # round 1
                slow_may_continue.wait(30)
                time.sleep(0.2)        # fast's round-3 get must be parked
                events.append("slow-advancing")
                table.add(np.ones(4, np.float32))  # round 2 releases fast
                table.finish_train()

        _run_workers(2, lambda s: [fast, slow][s]())
        return events, _clocks(pkg, table)

    jax_out, torch_out = _both(scenario)
    _assert_equal(jax_out, torch_out)
    assert torch_out[0] == ["fast-before-release", "slow-advancing",
                            ("fast-round3-get", 5.0)]


def test_ssp_staleness_gauge_and_gate_wait():
    """The gate telemetry through the port's dashboard: a parked Get's wait
    lands in SYNC_GATE_WAIT_SECONDS, each Add sets its worker's
    SSP_STALENESS_W<i>."""
    mvt.init(device="cpu", ssp_staleness=0, local_workers=2)
    table = mvt.create_table("array", 4, np.float32)
    server = _server(mvt)
    parked = threading.Event()  # the server has parked worker 0's Get
    added = threading.Event()   # both of worker 1's Adds are applied
    gate_defer = server._gate_defer

    def defer(msg):
        gate_defer(msg)
        parked.set()

    server._gate_defer = defer

    def run(slot):
        with mvt.worker(slot):
            if slot == 0:
                table.add(np.ones(4, np.float32))
                table.get()  # parked until worker 1's first Add
                # a finished worker leaves the slowest-worker minimum, so
                # worker 0 finishes only after worker 1's second Add has
                # set its gauge against worker 0's clock
                if not added.wait(JOIN_S):
                    raise AssertionError("worker 1's Adds never landed")
            else:
                if not parked.wait(JOIN_S):
                    raise AssertionError("worker 0's Get was never parked")
                time.sleep(0.1)
                table.add(np.ones(4, np.float32))
                table.add(np.ones(4, np.float32))
                added.set()
            table.finish_train()

    _run_workers(2, run)
    hist = TorchDashboard.histogram("SYNC_GATE_WAIT_SECONDS")
    assert hist.count == 1 and hist.max >= 0.05
    assert TorchDashboard.gauge("SSP_STALENESS_W0").value == 1.0
    assert TorchDashboard.gauge("SSP_STALENESS_W1").value == 1.0


# -- test_apply_batch.py ------------------------------------------------------

def test_gated_servers_never_fuse():
    for name in ("Server", "DeterministicServer", "SyncServer", "SSPServer"):
        j, t = getattr(jserver, name), getattr(tserver, name)
        for attr in ("gates_gets", "defers_adds", "fuses_adds"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
    assert tserver.Server.fuses_adds
    assert not any(c.fuses_adds for c in (tserver.DeterministicServer,
                                          tserver.SyncServer, tserver.SSPServer))


def test_deterministic_server_unaffected_and_reproducible():
    def run(pkg):
        dashboard = TorchDashboard if pkg is mvt else JaxDashboard
        dashboard.reset()
        _init(pkg, deterministic=True)
        table = pkg.create_table("matrix", num_row=16, num_col=4)
        rng = np.random.default_rng(3)
        for _ in range(6):
            ids = rng.choice(16, 4, replace=False).astype(np.int32)
            vals = rng.standard_normal((4, 4)).astype(np.float32)
            table.add(vals, row_ids=ids)
        table.finish_train()
        final = np.asarray(table.get(), np.float32)
        return final, dashboard.counter_value("APPLY_FUSED_CALLS")

    jax_out, torch1 = _both(run)
    torch2 = _once(mvt, run)
    assert torch1[1] == 0 and torch2[1] == 0
    np.testing.assert_array_equal(torch1[0], torch2[0])
    np.testing.assert_array_equal(torch1[0], jax_out[0])


def test_deterministic_bitwise_under_thread_timing():
    """4 workers, 6 row Adds each into a 64 x 8 table, with different sleep
    jitter in each run: the final tables are bitwise equal to each other,
    to a float32 mirror applied in (round, worker) order, and to the JAX
    package's. Add completions fire at enqueue."""
    workers, rounds, rows, cols = 4, 6, 64, 8
    data = [[(np.random.default_rng([w, r]).choice(rows, 24, replace=False)
              .astype(np.int32),
              np.random.default_rng([w, r, 1]).standard_normal((24, cols))
              .astype(np.float32)) for r in range(rounds)]
            for w in range(workers)]
    mirror = np.zeros((rows, cols), np.float32)
    for r in range(rounds):
        for w in range(workers):
            ids, vals = data[w][r]
            mirror[ids] += vals

    def run(pkg, jitter_seed):
        _init(pkg, deterministic=True, local_workers=workers)
        table = pkg.create_table("matrix", rows, cols)
        jitter = np.random.default_rng(jitter_seed).uniform(
            0, 0.004, (workers, rounds))

        def work(slot):
            with pkg.worker(slot):
                for r, (ids, vals) in enumerate(data[slot]):
                    time.sleep(jitter[slot, r])
                    table.add(vals, row_ids=ids)
                table.finish_train()

        _run_workers(workers, work)
        return np.asarray(table.get(), np.float32)

    jax_final, first = _both(lambda pkg: run(pkg, 0))
    second = _once(mvt, lambda pkg: run(pkg, 1))
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, mirror)
    np.testing.assert_array_equal(first, jax_final)


# -- word2vec under gated servers (test_word2vec.py) --------------------------

def _synthetic_corpus(rng, vocab, n):
    """Even ids co-occur with even, odd with odd (test_word2vec.py)."""
    half = vocab // 2
    blocks = []
    for _ in range(n // 20):
        parity = rng.integers(0, 2)
        blocks.append(parity + 2 * rng.integers(0, half, size=20))
    return np.concatenate(blocks).astype(np.int32)


def _cluster_score(emb, vocab):
    """Mean within-parity cosine similarity minus the cross-parity one."""
    norm = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    sim = norm @ norm.T
    even, odd = np.arange(0, vocab, 2), np.arange(1, vocab, 2)
    within = (sim[np.ix_(even, even)].mean() + sim[np.ix_(odd, odd)].mean()) / 2
    return within - sim[np.ix_(even, odd)].mean()


def _dictionary(pkg, corpus, vocab):
    if pkg is mvt:
        from multiverso_tpu_torch.models.vocab import Dictionary
    else:
        from multiverso_tpu.models.vocab import Dictionary
    d = Dictionary()
    d.words = [f"w{i}" for i in range(vocab)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum(np.bincount(corpus, minlength=vocab), 1).astype(np.int64)
    return d


def _word2vec(pkg):
    if pkg is mvt:
        from multiverso_tpu_torch.models import word2vec
    else:
        from multiverso_tpu.models import word2vec
    return word2vec


def test_ps_txn_refused_under_bsp():
    """Under BSP the trainer takes the staged path, and a direct
    transaction fails loudly, in both packages."""
    def scenario(pkg):
        _init(pkg, sync=True, local_workers=1)
        vocab = 40
        corpus = _synthetic_corpus(np.random.default_rng(5), vocab, 1500)
        w2v = _word2vec(pkg)
        config = w2v.Word2VecConfig(vocab_size=vocab, dim=16, window=2,
                                    negatives=3, batch_pairs=512, sample=0.0)
        trainer = w2v.PSTrainer(config, _dictionary(pkg, corpus, vocab))
        can = trainer._can_transact()
        with pytest.raises(pkg.log.FatalError):
            trainer.input_table.transact_device_async(
                lambda datas, states: (datas, states, None), [])
        return can

    assert _both(scenario) == [False, False]


def _open_rounds(trainer):
    """BSP serves a worker's i-th Get after every worker's i-th Add: open
    the first round of both tables with a zero Add."""
    for table in (trainer.input_table, trainer.output_table):
        table.add(np.zeros((1, table.num_col), np.float32), row_ids=[0])


@pytest.mark.parametrize("flags,workers", [(dict(ssp_staleness=2), 2),
                                           (dict(sync=True), 1),
                                           (dict(sync=True), 2)],
                         ids=["ssp2-2workers", "bsp-1worker", "bsp-2workers"])
def test_ps_trainer_learns_under_gated_servers(flags, workers):
    """The JAX twin (test_ps_trainer_under_ssp_staleness) races on its
    shared slot table when two workers share a trainer and sometimes
    fails to learn; the port's trainer takes turns with it. Same corpus,
    config and bound as the JAX test; the staged path gathers and
    scatters through ops.rows."""
    from multiverso_tpu_torch.ops import rows
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(9), vocab, 4000)
    mvt.init(device="cpu", local_workers=workers, **flags)
    w2v = _word2vec(mvt)
    config = w2v.Word2VecConfig(vocab_size=vocab, dim=16, window=2,
                                negatives=4, lr=0.3, batch_pairs=512,
                                sample=0.0)
    trainer = w2v.PSTrainer(config, _dictionary(mvt, corpus, vocab))
    assert not trainer._can_transact()
    blocks = [corpus[i:i + 500] for i in range(0, len(corpus), 500)]
    rows.gather_rows.launches = rows.scatter_add_rows.launches = 0
    if flags.get("sync"):
        for slot in range(workers):
            with mvt.worker(slot):
                _open_rounds(trainer)

    def run(slot):
        with mvt.worker(slot):
            for _ in range(8):
                for b in blocks[slot::workers]:
                    trainer.train_block(b)
            trainer.input_table.finish_train()
            trainer.output_table.finish_train()

    _run_workers(workers, run)
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.15, f"PS training under {flags} failed to learn: {score}"
    assert trainer.count_table.get(0) == 8 * len(corpus)
    # CPU tensors: the wrappers ran their plain versions and counted nothing
    assert rows.gather_rows.launches == rows.scatter_add_rows.launches == 0


def test_ps_trainer_shared_by_many_threads():
    """Eight worker threads share one trainer with a short switch interval:
    every block maps its tokens through the trainer's one slot lookup
    table, which they take in turns, so no block reads another's slots
    (an out-of-bucket slot would raise), the table is clean afterwards
    and the word count is exact."""
    import sys
    workers, vocab = 8, 60
    corpus = _synthetic_corpus(np.random.default_rng(2), vocab, 4000)
    mvt.init(device="cpu", local_workers=workers)
    w2v = _word2vec(mvt)
    config = w2v.Word2VecConfig(vocab_size=vocab, dim=8, window=2,
                                negatives=3, batch_pairs=512, sample=0.0)
    trainer = w2v.PSTrainer(config, _dictionary(mvt, corpus, vocab))
    blocks = [corpus[i:i + 250] for i in range(0, len(corpus), 250)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(slot):
            with mvt.worker(slot):
                for b in blocks[slot::workers]:
                    assert np.isfinite(trainer.train_block(b))

        _run_workers(workers, run)
    finally:
        sys.setswitchinterval(interval)
    assert (trainer._slot_lut == -1).all()
    assert trainer.count_table.get(0) == len(corpus)
    assert np.isfinite(trainer.embeddings()).all()
