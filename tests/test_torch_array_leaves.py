"""The array table's whole-model leaf requests and the device worker views
of the port (``sync_leaves_async``, ``push_leaves_async``,
``get_leaves_async``; ``PytreeWorkerSync(device=True)``).

The device and leaf cases of ``tests/test_array_table.py`` run on the port
(``device="cpu"``) with the values the contract fixes, which are exact
(integer-valued floats). The leaf forms also take the same seeded leaves
as the JAX package's table and reply the same values (float32, rtol 1e-6).
Torch trains in place where JAX donated, so the port's own cases hold the
aliasing contract: a push is snapshotted when it is submitted (a caller
mutating its leaves under the deterministic server's deferred apply does
not change the applied delta), and every reply is a tensor set of its own."""

import threading

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.ext import PytreeParamManager as JaxPytreeParamManager

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.ext import PytreeParamManager
from multiverso_tpu_torch.runtime.zoo import Zoo as TZoo
from multiverso_tpu_torch.tables.base import WorkerTable

JOIN_S = 60
SHAPES = [(2, 3), (4,), (3, 1, 2)]          # 16 values in three leaves


@pytest.fixture(autouse=True)
def port_flags():
    """Each test starts the port from its default flags and leaves no
    runtime behind; the tiny tensors run on one intra-op thread."""
    TORCH_FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _full(shape, value):
    return torch.full(shape, float(value), dtype=torch.float32)


def _run_threads(n, fn):
    threads = [threading.Thread(target=fn, args=(s,), daemon=True)
               for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "worker thread wedged"


def _leaves(rng):
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def test_leaf_forms_match_jax():
    """The same seeded leaves through both packages' fused sync, pair sync,
    pair push and leaf Get give the same replies."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    init = np.concatenate([x.reshape(-1) for x in _leaves(rng)])
    delta, new, last, new2 = (_leaves(rng) for _ in range(4))
    replies = {}
    for pkg in (mv, mvt):
        if pkg is mvt:
            pkg.init(device="cpu")
            conv = torch.from_numpy
        else:
            pkg.init()
            conv = jnp.asarray
        t = pkg.create_table("array", init.size, np.float32, init_value=init)
        a = t.wait(t.sync_leaves_async([conv(x) for x in delta]))
        m, b = t.wait(t.sync_leaves_async([conv(x) for x in new],
                                          last_leaves=[conv(x) for x in last]))
        t.wait(t.push_leaves_async([conv(x) for x in new2],
                                   [conv(x) for x in last]))
        g = t.wait(t.get_leaves_async([conv(x) for x in delta]))
        replies[pkg] = [[np.asarray(x) for x in r] for r in (a, m, b, g)]
        pkg.shutdown()
    expect_a = [i.reshape(d.shape) + d
                for i, d in zip(np.split(init, [6, 10]), delta)]
    for got_j, got_t in zip(replies[mv], replies[mvt]):
        for x, y in zip(got_j, got_t):
            assert x.shape == y.shape
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6)
    for x, s, e in zip(replies[mvt][0], SHAPES, expect_a):
        np.testing.assert_allclose(x, e.reshape(s), rtol=1e-6)


def test_leaf_replies_are_distinct_buffers():
    """Mutating any returned tensor changes nothing else: not the table,
    not the other reply, not the caller's leaves."""
    mvt.init(device="cpu")
    t = mvt.create_table("array", 16, np.float32)
    new = [_full(s, 1) for s in SHAPES]
    last = [_full(s, 0) for s in SHAPES]
    merged, base = t.wait(t.sync_leaves_async(new, last_leaves=last))
    fused = t.wait(t.sync_leaves_async([_full(s, 0) for s in SHAPES]))
    got = t.wait(t.get_leaves_async([torch.empty(s, device="meta")
                                     for s in SHAPES]))
    replies = [merged, base, fused, got]
    ptrs = [x.data_ptr() for r in replies for x in r]
    assert len(set(ptrs)) == len(ptrs)
    for r in replies:
        for x in r:
            x.add_(100.0)
            for other in replies:
                for y in other:
                    if y is not x:
                        assert float(y.max()) < 100.0
            x.sub_(100.0)
    np.testing.assert_array_equal(t.get(), np.ones(16, np.float32))
    for x in new:
        assert torch.equal(x, torch.ones_like(x))
    for x in last:
        assert torch.equal(x, torch.zeros_like(x))


def test_push_is_snapshotted_under_deferred_apply():
    """Under the deterministic server worker 0's pair push waits for worker
    1's round; worker 0 mutates its leaves right after submitting, and the
    applied delta is still the submitted one."""
    mvt.init(deterministic=True, local_workers=2, device="cpu")
    t = mvt.create_table("array", 16, np.float32)
    zeros = [_full(s, 0) for s in SHAPES]
    pushed = threading.Event()

    def run(slot):
        with mvt.worker(slot):
            if slot == 1:
                assert pushed.wait(JOIN_S)
                t.wait(t.push_leaves_async([_full(s, 10) for s in SHAPES],
                                           zeros))
                return
            mine = [_full(s, 1) for s in SHAPES]
            t.wait(t.push_leaves_async(mine, zeros))
            for x in mine:      # the next training step, in place
                x.add_(1000.0)
            pushed.set()

    _run_threads(2, run)
    with TZoo.instance().admin():
        np.testing.assert_array_equal(t.get(), np.full(16, 11.0, np.float32))


def test_leaf_signature_must_total_table_size():
    mvt.init(device="cpu")
    t = mvt.create_table("array", 16, np.float32)
    with pytest.raises(mvt.log.FatalError, match="leaf signature"):
        t.sync_leaves_async([_full((3,), 1)])


def test_merge_add_requests_stops_at_leaf_requests():
    """The dispatcher's micro-batch merge sums plain whole-array Adds only:
    it stops at the first leaf request."""
    mvt.init(device="cpu")
    t = mvt.create_table("array", 16, np.float32)
    server = t._server_table
    key, flatten, _ = server.leaf_codec([_full(s, 1) for s in SHAPES])
    flat = flatten([_full(s, 1) for s in SHAPES])
    plain = (np.ones(16, np.float32), None)
    reqs = [plain, plain, ("leaves", flat, None, key), plain]
    merged, rows, consumed = server.merge_add_requests(reqs)
    assert consumed == 2 and rows == 16
    np.testing.assert_array_equal(merged[0], np.full(16, 2.0, np.float32))
    for req in (("leaves", flat, None, key),
                ("leaves_sync", flat, flat, None, key),
                ("leaves_push", flat, flat, None, key)):
        assert server.merge_add_requests([req, plain]) is None


def test_device_worker_view_matches_host_view():
    """The device view's values equal the host view's."""
    mvt.init(device="cpu")
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    pm = PytreeParamManager(tree)
    host = pm.worker_view(device=False)
    dev = pm.worker_view(device=True)
    t1 = {"a": _full((2, 3), 1.5), "b": torch.arange(4, dtype=torch.float32)}
    h = host.sync(t1)
    d = dev.sync({k: torch.zeros_like(v) for k, v in t1.items()})
    for k in tree:
        assert torch.equal(d[k], h[k])


def test_device_sync_baseline_survives_in_place_update():
    """The pair sync replies (merged, baseline) as distinct tensor sets: the
    caller trains on merged in place, and the baseline the view keeps is
    untouched, so a next value built from ``view.params`` pushes zero."""
    mvt.init(device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(8)})
    view = pm.worker_view(device=True)
    t = {"w": _full((8,), 1)}
    for _ in range(3):
        merged = view.sync(t)
        np.testing.assert_array_equal(merged["w"].numpy(), np.ones(8))
        t = view.params
        merged["w"].mul_(0)     # the caller's in-place step
    np.testing.assert_array_equal(pm.table.get(), np.ones(8, np.float32))


def test_device_sync_two_views_accumulate():
    mvt.init(device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(4)})
    va, vb = pm.worker_view(device=True), pm.worker_view(device=True)
    a = va.sync({"w": _full((4,), 1)})
    b = vb.sync({"w": _full((4,), 2)})
    np.testing.assert_array_equal(a["w"].numpy(), np.full(4, 1.0))
    np.testing.assert_array_equal(b["w"].numpy(), np.full(4, 3.0))
    a2 = va.sync({"w": a["w"].clone()})
    np.testing.assert_array_equal(a2["w"].numpy(), np.full(4, 3.0))


def test_device_sync_under_bsp():
    """Through the SyncServer the view pushes, then pulls with a gated Get:
    round-1 replies observe both round-1 adds."""
    workers = 2
    mvt.init(sync=True, local_workers=workers, device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(4)})
    views = [pm.worker_view(device=True) for _ in range(workers)]
    results = {}

    def run(slot):
        with mvt.worker(slot):
            m = views[slot].sync({"w": _full((4,), slot + 1)})
            results[slot] = m["w"].numpy().copy()

    _run_threads(workers, run)
    np.testing.assert_array_equal(results[0], np.full(4, 3.0))
    np.testing.assert_array_equal(results[1], np.full(4, 3.0))


def test_device_sync_deterministic_fallback():
    mvt.init(deterministic=True, local_workers=1, device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(4)})
    view = pm.worker_view(device=True)
    with mvt.worker(0):
        m = view.sync({"w": _full((4,), 2)})
        np.testing.assert_array_equal(m["w"].numpy(), np.full(4, 2.0))
        m = view.sync({"w": m["w"] + 1.0})
        np.testing.assert_array_equal(m["w"].numpy(), np.full(4, 3.0))


def test_pipelined_sync_accumulates_all_pushes():
    """k pushes of +1 land exactly k in the table: the two-baseline
    bookkeeping neither double-counts nor drops the in-flight push, while
    the caller steps the returned tree in place."""
    mvt.init(device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(6)})
    view = pm.worker_view(device=True)
    t = {"w": _full((6,), 1)}
    k = 5
    for i in range(k):
        ret = view.sync_pipelined(t)
        np.testing.assert_array_equal(ret["w"].numpy(),
                                      np.full(6, float(max(i - 1, 0) + (1 if i else 0))))
        ret["w"].add_(1)        # one more unit of local work, in place
        t = ret
    final = view.drain()
    np.testing.assert_array_equal(final["w"].numpy(), np.full(6, float(k)))
    np.testing.assert_array_equal(pm.table.get(), np.full(6, float(k)))


def test_pipelined_sync_two_workers():
    mvt.init(local_workers=2, device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(4)})
    views = [pm.worker_view(device=True) for _ in range(2)]
    rounds = 4

    def run(slot):
        with mvt.worker(slot):
            view = views[slot]
            t = {"w": _full((4,), 1)}
            for _ in range(rounds):
                ret = view.sync_pipelined(t)
                t = {"w": ret["w"] + 1}
            view.drain()

    _run_threads(2, run)
    np.testing.assert_array_equal(pm.table.get(), np.full(4, float(2 * rounds)))


def test_pipelined_then_blocking_sync_drains():
    mvt.init(device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(3)})
    view = pm.worker_view(device=True)
    ret = view.sync_pipelined({"w": _full((3,), 1)})
    merged = view.sync({"w": ret["w"] + 1.0})
    np.testing.assert_array_equal(merged["w"].numpy(), np.full(3, 2.0))
    view.sync_pipelined({"w": merged["w"]})
    with pytest.raises(mvt.log.FatalError, match="pipelined"):
        view.params     # a push is in flight: drain() first


def test_device_view_matches_jax_view():
    """A seeded tree through one device view of each package, three syncs
    with a peer's Add between them: the same trees back."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    steps = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    peer = rng.standard_normal(17).astype(np.float32)
    out = {}
    for pkg in (mv, mvt):
        if pkg is mvt:
            pkg.init(device="cpu")
            conv, manager = torch.from_numpy, PytreeParamManager
        else:
            pkg.init()
            conv, manager = jnp.asarray, JaxPytreeParamManager
        pm = manager({k: conv(v.copy()) for k, v in tree.items()})
        view = pm.worker_view(device=True)
        cur = view.params
        got = []
        for s in steps:
            cur = view.sync({k: cur[k] + conv(s[k]) for k in cur})
            got.append({k: np.asarray(v) for k, v in cur.items()})
            pm.table.add(peer)
        out[pkg] = got
        pkg.shutdown()
    for a, b in zip(out[mv], out[mvt]):
        for k in tree:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6)


def test_view_syncs_trees_stepped_in_place_rebound_or_cast():
    """A view hands out trees whose tensors are views of one flat tensor.
    Stepped in place, rebound (``.data``) or replaced by another dtype, the
    leaves handed back push the right delta."""
    mvt.init(device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(2, 3), "b": torch.zeros(4)})
    view = pm.worker_view(device=True)
    tree = view.params
    tree["w"].add_(1.0)                       # in place
    tree = view.sync(tree)
    np.testing.assert_array_equal(pm.table.get(),
                                  np.r_[np.zeros(4), np.ones(6)])
    tree["b"].data = torch.full((4,), 5.0)    # rebound
    tree = view.sync(tree)
    np.testing.assert_array_equal(pm.table.get(),
                                  np.r_[np.full(4, 5.0), np.ones(6)])
    tree["w"] = tree["w"].double() + 1        # another dtype, a new tensor
    tree = view.sync(tree)
    np.testing.assert_array_equal(pm.table.get(),
                                  np.r_[np.full(4, 5.0), np.full(6, 2.0)])


def test_wrong_size_flat_request_is_fatal():
    mvt.init(device="cpu")
    t = mvt.create_table("array", 16, np.float32)
    key, _, _ = t._server_table.leaf_codec([_full(s, 1) for s in SHAPES])
    with pytest.raises(mvt.log.FatalError, match="padded size"):
        t.wait(WorkerTable.add_async(t, ("leaves", torch.ones(15), None, key)))
