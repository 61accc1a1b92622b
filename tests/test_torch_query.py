"""The port's top-k query plane (``multiverso_tpu_torch/query/``) against a
numpy lexsort oracle and the JAX package's engine.

The ordering contract: score descending, ties toward the lower id. On
integer-valued float32 rows every dot product is exact, so there the ids
AND scores must equal the oracle's bit for bit, ties across the k
boundary included (``torch.topk`` promises no tie order; the engine
resolves the boundary itself). Cosine scores go through a division and
a square root, whose last bit differs between torch, numpy and XLA: they
are held within rtol 1e-5, atol 1e-6 of the oracle, and the ids exactly
wherever the oracle's neighbouring scores are further apart than that.
Where the JAX engine disagrees with the oracle (its cosine scores, from
XLA, differ from numpy's in the last bit), the oracle decides."""

import threading

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
import multiverso_tpu_torch as mvt
from multiverso_tpu.query import engine as jengine
from multiverso_tpu.tables.sparse_table import SparseServer as JSparseServer
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.query import engine
from multiverso_tpu_torch.query.engine import (check_request, device_topk,
                                               merge_topk, order_rows,
                                               query_table)
from multiverso_tpu_torch.tables.matrix_table import MatrixServer
from multiverso_tpu_torch.tables.sparse_table import (SparseFTRLServer,
                                                      SparseServer,
                                                      TieredSparseServer)
from multiverso_tpu_torch.updaters import AddOption

RTOL, ATOL = 1e-5, 1e-6
OPT = AddOption(worker_id=0)


@pytest.fixture
def one_thread():
    """One intra-op thread: worker threads and the dispatcher hand torch
    ops over in turns, which a loaded machine's intra-op pool can stall
    (as in tests/test_torch_sync.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def port(one_thread):
    TORCH_FLAGS.reset()
    mvt.init(device="cpu")
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


@pytest.fixture
def both(port):
    mv.init()
    yield


def _int_block(rng, n, dim):
    """Integer-valued float32 rows: their float32 dot products are exact."""
    return rng.integers(-8, 9, size=(n, dim)).astype(np.float32)


def _oracle(ids, rows, vecs, k, metric="dot"):
    """Plain-numpy top-k under the ordering contract (no engine code)."""
    rows = rows.astype(np.float32)
    vecs = vecs.astype(np.float32)
    if metric == "cosine":
        eps = np.float32(1e-30)
        vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), eps)
        rows = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), eps)
    scores = vecs @ rows.T
    ids = np.broadcast_to(np.asarray(ids, np.int64).reshape(1, -1), scores.shape)
    order = np.lexsort((ids, -scores), axis=-1)
    ids = np.take_along_axis(np.ascontiguousarray(ids), order, axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    k = min(k, scores.shape[1])
    return ids[:, :k], scores[:, :k].astype(np.float32)


def _assert_topk(got, ids, rows, vecs, k, metric):
    """Exact on dot; on cosine, scores within RTOL/ATOL and ids exact
    outside runs of oracle scores closer than that (a run crossing the k
    boundary may swap members with the run's ids past k)."""
    want_ids, want_scores = _oracle(ids, rows, vecs, k + 1, metric)
    kk = min(k, want_ids.shape[1])
    if metric == "dot":
        np.testing.assert_array_equal(got[0], want_ids[:, :kk])
        np.testing.assert_array_equal(got[1], want_scores[:, :kk])
        return
    np.testing.assert_allclose(got[1], want_scores[:, :kk], rtol=RTOL, atol=ATOL)
    for r in range(len(want_ids)):
        s = want_scores[r]
        close = np.abs(np.diff(s)) <= ATOL + RTOL * np.abs(s[1:])
        start = 0
        for j in range(len(s)):   # runs of near-equal neighbours
            if j and not close[j - 1]:
                start = j
            end = j
            while end + 1 < len(s) and close[end]:
                end += 1
            if j < kk:
                if start == end:
                    assert got[0][r, j] == want_ids[r, j], (r, j)
                else:
                    assert got[0][r, j] in set(want_ids[r, start:end + 1])
        assert len(set(got[0][r].tolist())) == kk


# -- units: request validation, merge algebra, the exact device top-k ---------

def test_check_request_normalizes_and_rejects():
    vecs, k, metric = check_request(([1.0, 2.0, 3.0], 4, "dot"))
    assert vecs.shape == (1, 3) and vecs.dtype == np.float32
    assert k == 4 and metric == "dot"
    with pytest.raises(ValueError, match="vecs, k, metric"):
        check_request("nope")
    with pytest.raises(ValueError, match="k must be >= 1"):
        check_request((np.ones((1, 3)), 0, "dot"))
    with pytest.raises(ValueError, match="metric"):
        check_request((np.ones((1, 3)), 2, "euclid"))
    with pytest.raises(ValueError, match="n_q, dim"):
        check_request((np.ones((2, 2, 2)), 2, "dot"))


def test_merge_topk_ragged_and_ties_as_jax():
    a = (np.array([[7]], np.int64), np.array([[5.0]], np.float32))
    b = (np.array([[2, 9, 4]], np.int64),
         np.array([[5.0, 1.0, 3.0]], np.float32))
    ids, scores = merge_topk([a, b], 3)
    np.testing.assert_array_equal(ids, [[2, 7, 4]])
    np.testing.assert_array_equal(scores, [[5.0, 5.0, 3.0]])
    for k in (1, 3, 99):
        got, want = merge_topk([a, b], k), jengine.merge_topk([a, b], k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert merge_topk([a, b], 99)[0].shape == (1, 4)


def test_order_rows_contract_matches_lexsort_and_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, size=(3, 12)).astype(np.int64)
    scores = rng.integers(-3, 4, size=(3, 12)).astype(np.float32)
    got_ids, got_scores = order_rows(ids.copy(), scores.copy())
    order = np.lexsort((ids, -scores), axis=-1)
    np.testing.assert_array_equal(got_ids, np.take_along_axis(ids, order, axis=1))
    np.testing.assert_array_equal(got_scores,
                                  np.take_along_axis(scores, order, axis=1))
    want = jengine.order_rows(ids.copy(), scores.copy())
    np.testing.assert_array_equal(got_ids, want[0])


@pytest.mark.parametrize("seed", range(6))
def test_device_topk_breaks_ties_toward_the_lower_index(seed):
    """Scores from a 3-value grid: nearly every k boundary falls inside a
    run of ties, which must resolve to the lowest indices."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 3, size=(5, 40)).astype(np.float32)
    idx = np.broadcast_to(np.arange(40), scores.shape)
    for k in (1, 2, 7, 13, 39, 40):
        got_i, got_s = device_topk(torch.from_numpy(scores), k)
        order = np.lexsort((idx, -scores), axis=-1)[:, :k]
        np.testing.assert_array_equal(got_i.numpy(), order)
        np.testing.assert_array_equal(got_s.numpy(),
                                      np.take_along_axis(scores, order, axis=1))


# -- per table kind, against the oracle and the JAX engine --------------------

def _matrix_pair(data):
    rows, cols = data.shape
    port_server = MatrixServer(rows, cols, np.float32)
    port_server.process_add((None, data, OPT))
    jax_table = mv.create_table("matrix", rows, cols, np.float32)
    jax_table.add(data)
    return port_server, jax_table._server_table


def test_matrix_query_matches_oracle_and_jax(both):
    rows, cols = 23, 6
    rng = np.random.default_rng(1)
    data = _int_block(rng, rows, cols)
    data[11] = data[3]  # planted tie: equal scores, ids 3 < 11
    server, jserver = _matrix_pair(data)
    vecs = _int_block(rng, 4, cols)
    for metric in ("dot", "cosine"):
        for k in (1, 5, rows + 10):  # k past num_row clamps to num_row
            got = query_table(server, (vecs, k, metric))
            _assert_topk(got, np.arange(rows), data, vecs, k, metric)
            want = jengine.query_table(jserver, (vecs, k, metric))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="dim"):
        query_table(server, (np.ones((1, cols + 1)), 2, "dot"))


def test_matrix_ties_across_the_k_boundary_resolve_to_lower_ids(port):
    """An integer grid of 3 distinct rows repeated: every k cuts a run of
    exact ties, and the kept ids must be the oracle's (lowest first)."""
    rng = np.random.default_rng(12)
    base = _int_block(rng, 3, 5)
    data = base[rng.integers(0, 3, 60)]
    server = MatrixServer(60, 5, np.float32)
    server.process_add((None, data, OPT))
    vecs = _int_block(rng, 6, 5)
    for k in (1, 4, 10, 21, 59):
        got = query_table(server, (vecs, k, "dot"))
        _assert_topk(got, np.arange(60), data, vecs, k, "dot")


def test_matrix_pads_and_sentinel_row_never_rank(port):
    """The port pads each row to 16-byte vectors and keeps a sentinel row
    past num_row: fill both with huge values and nothing changes."""
    rows, cols = 9, 5            # 5 float32 columns pad to 8
    rng = np.random.default_rng(3)
    data = _int_block(rng, rows, cols)
    server = MatrixServer(rows, cols, np.float32)
    server.process_add((None, data, OPT))
    assert server.data.shape == (rows + 1, 8)
    server.data[rows, :] = 1e6           # the sentinel row
    server.data[:, cols:] = 1e6          # the column pads
    vecs = np.abs(_int_block(rng, 3, cols)) + 1
    for metric in ("dot", "cosine"):
        got = query_table(server, (vecs, rows + 5, metric))
        assert got[0].shape == (3, rows) and got[0].max() < rows
        _assert_topk(got, np.arange(rows), data, vecs, rows, metric)


def test_matrix_query_cosine_finds_self(port):
    rows, cols = 16, 8
    rng = np.random.default_rng(2)
    data = rng.standard_normal((rows, cols)).astype(np.float32)
    server = MatrixServer(rows, cols, np.float32)
    server.process_add((None, data, OPT))
    probes = np.array([0, 7, 15])
    ids, scores = query_table(server, (3.0 * data[probes], 1, "cosine"))
    np.testing.assert_array_equal(ids[:, 0], probes)
    np.testing.assert_allclose(scores[:, 0], 1.0, atol=1e-5)


def test_sparse_query_matches_oracle_and_jax(both):
    rng = np.random.default_rng(3)
    keys = np.array([2, 5, 11, 40, 41, 97], np.int64)
    vals = _int_block(rng, len(keys), 4)
    vals[4] = vals[1]                   # a planted tie, ids 5 < 41
    server, jserver = SparseServer(100, 4), JSparseServer(100, 4)
    for srv in (server, jserver):
        srv.process_add((keys, vals, None))
    vecs = _int_block(rng, 3, 4)
    for metric in ("dot", "cosine"):
        for k in (2, 4, 10):
            got = query_table(server, (vecs, k, metric))
            _assert_topk(got, keys, vals, vecs, k, metric)
            want = jengine.query_table(jserver, (vecs, k, metric))
            np.testing.assert_array_equal(got[0], want[0])


def test_empty_and_unsupported_tables(port):
    empty = SparseServer(100, 4)
    ids, scores = query_table(empty, (np.ones((2, 4)), 3, "dot"))
    assert ids.shape == (2, 0) and scores.shape == (2, 0)
    with pytest.raises(TypeError, match="FTRL"):
        query_table(SparseFTRLServer(100, 4), (np.ones((1, 4)), 1, "dot"))
    array = mvt.create_table("array", 8, np.float32)
    with pytest.raises(TypeError, match="row-shaped"):
        array.query(np.ones((1, 8)), 1)
    kv = mvt.create_table("kv", np.float32, capacity=64)
    with pytest.raises(TypeError, match="row-shaped"):
        mvt.query(kv, np.ones((1, 1)), 1)


# -- tiered: scans that never promote -----------------------------------------

def _tiered_pair(tmp_path, key_space, width, cold_bits, resident_rows, rng,
                 plant=None):
    tiered = TieredSparseServer(key_space, width,
                                resident_bytes=resident_rows * width * 4,
                                cold_bits=cold_bits, tier_dir=str(tmp_path))
    plain = SparseServer(key_space, width)
    keys = np.arange(key_space, dtype=np.int64)
    vals = _int_block(rng, key_space, width)
    if plant is not None:
        vals[plant[0]] = plant[1]
    for start in range(0, key_space, 16):
        sl = slice(start, start + 16)
        tiered.process_add((keys[sl], vals[sl], None))
        plain.process_add((keys[sl], vals[sl], None))
    return tiered, plain, keys, vals


def test_tiered_lossless_query_matches_oracle_and_never_promotes(port,
                                                                 tmp_path):
    rng = np.random.default_rng(4)
    tiered, plain, keys, vals = _tiered_pair(tmp_path, key_space=96, width=4,
                                             cold_bits=0, resident_rows=8,
                                             rng=rng)
    try:
        stats = tiered.tier_stats()
        assert stats["cold_rows"] > 0, "tier never demoted"
        counters = ("TIER_PROMOTIONS", "TIER_HOT_HITS", "TIER_COLD_HITS")
        before = [Dashboard.counter_value(c) for c in counters]
        vecs = _int_block(rng, 3, 4)
        for metric in ("dot", "cosine"):
            got = query_table(tiered, (vecs, 7, metric))
            _assert_topk(got, keys, vals, vecs, 7, metric)
            plain_got = query_table(plain, (vecs, 7, metric))
            np.testing.assert_array_equal(got[0], plain_got[0])
            np.testing.assert_allclose(got[1], plain_got[1], rtol=RTOL,
                                       atol=ATOL)
        assert [Dashboard.counter_value(c) for c in counters] == before
        assert tiered.tier_stats() == stats
    finally:
        tiered._tier.close()


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_tiered_compressed_domain_scan(port, tmp_path, bits):
    """At >= 4 bits cold segments score as raw codes
    (QUERY_COMPRESSED_SEGMENTS moves), below that they decode; neither
    promotes, a planted dominant row ranks first, and the scores equal
    the JAX engine's on the same segments."""
    from multiverso_tpu.tables.sparse_table import \
        TieredSparseServer as JTiered
    rng = np.random.default_rng(5)
    tiered, _plain, keys, vals = _tiered_pair(
        tmp_path / "p", key_space=96, width=4, cold_bits=bits,
        resident_rows=8, rng=rng, plant=(17, np.full(4, 50.0, np.float32)))
    ref = JTiered(96, 4, resident_bytes=8 * 4 * 4, cold_bits=bits,
                  tier_dir=str(tmp_path / "j"))
    for start in range(0, 96, 16):
        sl = slice(start, start + 16)
        ref.process_add((keys[sl], vals[sl], None))
    try:
        comp0 = Dashboard.counter_value("QUERY_COMPRESSED_SEGMENTS")
        scan0 = Dashboard.counter_value("QUERY_COLD_SEGMENTS_SCANNED")
        promo0 = Dashboard.counter_value("TIER_PROMOTIONS")
        probe = np.ones((2, 4), np.float32)
        probe[1, 0] = -1.0
        for metric in ("dot", "cosine"):
            ids, scores = query_table(tiered, (probe, 5, metric))
            assert int(ids[0, 0]) == int(keys[17])
            want = jengine.query_table(ref, (probe, 5, metric))
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(scores, want[1])
        moved = Dashboard.counter_value("QUERY_COMPRESSED_SEGMENTS") - comp0
        assert (moved > 0) == (bits >= 4)
        assert Dashboard.counter_value("QUERY_COLD_SEGMENTS_SCANNED") > scan0
        assert Dashboard.counter_value("TIER_PROMOTIONS") == promo0
    finally:
        tiered._tier.close()
        ref._tier.close()


# -- the front door, through the dispatcher -----------------------------------

def test_worker_table_query_front_door(port):
    """mvt.query against a live table: one round trip through the
    dispatcher, after the Adds acknowledged before it; equal to the
    oracle. (A query is serving-lane traffic: drained together with
    queued Adds it is answered before them, as in the JAX package.)"""
    rows, cols = 24, 6
    rng = np.random.default_rng(8)
    data = _int_block(rng, rows, cols)
    table = mvt.create_table("matrix", rows, cols, np.float32)
    handles = [table.add_async(data[i:i + 6], row_ids=np.arange(i, i + 6))
               for i in range(0, rows, 6)]
    for h in handles:
        table.wait(h)
    vecs = _int_block(rng, 2, cols)
    ids, scores = mvt.query(table, vecs, 5)
    _assert_topk((ids, scores), np.arange(rows), data, vecs, 5, "dot")
    ids2, scores2 = table.query(vecs, 5, metric="dot")
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_array_equal(scores2, scores)
    assert Dashboard.histogram("SERVER_PROCESS_QUERY_MSG").count >= 2
    sparse = mvt.create_table("sparse", 1000, width=cols)
    sparse.add([3, 500, 999], data[:3])
    got = sparse.query(vecs, 2)
    _assert_topk(got, np.array([3, 500, 999]), data[:3], vecs, 2, "dot")
    with pytest.raises(ValueError, match="dim"):
        table.query(np.ones((1, cols + 1)), 2)


def _run(fn, timeout=30.0):
    out, errors = [], []

    def body():
        try:
            out.append(fn())
        except BaseException as exc:  # surface it to the test thread
            errors.append(exc)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "query did not return: held by a round gate"
    if errors:
        raise errors[0]
    return out[0]


@pytest.mark.parametrize("mode", ["sync", "ssp", "deterministic"])
def test_query_passes_the_round_gates(one_thread, mode):
    """Worker 0 opens round 1 with an Add; worker 1 has not. Its Get would
    wait for worker 1 (BSP; SSP at staleness 0), and the deterministic
    server holds its Add until worker 1's round-1 Add. A query from
    worker 0 is never clocked: it returns at once, over the state the
    dispatcher has applied."""
    flags = {"sync": dict(sync=True), "ssp": dict(ssp_staleness=0),
             "deterministic": dict(deterministic=True)}[mode]
    TORCH_FLAGS.reset()
    mvt.init(device="cpu", local_workers=2, **flags)
    try:
        table = mvt.create_table("matrix", 6, 4, np.float32)
        data = np.arange(24, dtype=np.float32).reshape(6, 4)
        with mvt.worker(0):
            table.add(data)
            ids, scores = _run(lambda: table.query(np.ones((1, 4)), 3))
        applied = mode != "deterministic"
        if applied:
            np.testing.assert_array_equal(ids, [[5, 4, 3]])
            np.testing.assert_array_equal(scores, [[86.0, 70.0, 54.0]])
        else:                                   # held for worker 1's round
            np.testing.assert_array_equal(ids, [[0, 1, 2]])
            np.testing.assert_array_equal(scores, [[0.0, 0.0, 0.0]])
        with mvt.worker(1):
            table.add(np.zeros((6, 4), np.float32))
            ids, _ = _run(lambda: mvt.query(table, np.ones((1, 4)), 1))
            assert ids[0, 0] == 5
        for slot in (0, 1):
            with mvt.worker(slot):
                table.finish_train()
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def test_query_keeps_tf32_off_and_restores_the_setting():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with engine._full_fp32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
