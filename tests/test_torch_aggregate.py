"""``mvt.aggregate`` (``MV_Aggregate``) against the JAX package's
``mv.aggregate``: the cases of ``tests/test_runtime.py`` (the sum across
workers, a server-only node, the unbound-thread fatal, ``ma=True``
disabling tables), then leaf lists on the host and tensor lists on the
device (here the CPU). The inputs are integer-valued floats, so the sums
are exact in any order: the port sums the slots in slot order, the JAX
package in the order the threads arrived. Each worker gets its own copy of
a device result (JAX shares one immutable buffer)."""

import threading

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.config import FLAGS as JAX_FLAGS

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS

JOIN_S = 60
LEAF_SHAPES = [(4, 3, 3, 3), (4,), (10, 4)]


@pytest.fixture(autouse=True)
def port_flags():
    TORCH_FLAGS.reset()
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
        JAX_FLAGS.reset()
        mv.init(**flags)


def _each_worker(pkg, n, fn):
    """``fn(slot)`` on n bound worker threads; their results by slot."""
    results, errors = {}, {}

    def run(slot):
        with pkg.worker(slot):
            try:
                results[slot] = fn(slot)
            except BaseException as exc:  # reported below
                errors[slot] = exc

    threads = [threading.Thread(target=run, args=(s,), daemon=True)
               for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "aggregate wedged"
    assert not errors, errors
    return results


def _slot_values(slot):
    rng = np.random.default_rng(slot)
    return [rng.integers(-8, 9, size=s).astype(np.float32) for s in LEAF_SHAPES]


@pytest.mark.parametrize("pkg", [mv, mvt], ids=["jax", "torch"])
def test_aggregate_sums_across_workers(pkg):
    _init(pkg, ma=True, local_workers=4)
    results = _each_worker(pkg, 4, lambda s: pkg.aggregate(
        np.ones(5, dtype=np.float32)))
    pkg.shutdown()
    for r in results.values():
        np.testing.assert_array_equal(r, np.full(5, 4.0, dtype=np.float32))


def test_aggregate_on_server_only_node():
    """Slots are keyed by the bound thread slot: on a ps_role=server node
    every thread's worker id is -1."""
    out = {}
    for pkg in (mv, mvt):
        _init(pkg, ps_role="server", local_workers=3)
        out[pkg] = _each_worker(pkg, 3, lambda s: pkg.aggregate(
            np.full(4, float(s + 1), dtype=np.float32)))
        pkg.shutdown()
    for r in list(out[mv].values()) + list(out[mvt].values()):
        np.testing.assert_array_equal(r, np.full(4, 6.0, dtype=np.float32))


def test_aggregate_unbound_thread_fails_loudly():
    mvt.init(ma=True, local_workers=2, device="cpu")
    errors = {}

    def run():
        try:
            mvt.aggregate(np.ones(2, dtype=np.float32))
        except mvt.log.FatalError as exc:
            errors["raised"] = str(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert "bind a worker slot" in errors.get("raised", "")


def test_ma_mode_disables_tables():
    mvt.init(ma=True, device="cpu")
    with pytest.raises(mvt.log.FatalError):
        mvt.create_table("array", 10)


def test_aggregate_host_leaf_lists_match_jax():
    out = {}
    for pkg in (mv, mvt):
        _init(pkg, ma=True, local_workers=3)
        out[pkg] = _each_worker(pkg, 3, lambda s: pkg.aggregate(_slot_values(s)))
        pkg.shutdown()
    want = [sum(_slot_values(s)[i] for s in range(3))
            for i in range(len(LEAF_SHAPES))]
    for pkg in (mv, mvt):
        for r in out[pkg].values():
            assert len(r) == len(want)
            for x, w in zip(r, want):
                assert isinstance(x, np.ndarray)
                np.testing.assert_array_equal(x, w)


def test_aggregate_device_tensor_lists():
    """Tensor lists sum on their device, equal to numpy's sum exactly, and
    each worker's result is its own set of buffers: mutating one worker's
    sum leaves the others and the inputs as they were."""
    mvt.init(ma=True, local_workers=4, device="cpu")
    inputs = {s: [torch.from_numpy(x) for x in _slot_values(s)]
              for s in range(4)}
    results = _each_worker(mvt, 4, lambda s: mvt.aggregate(inputs[s]))
    single = _each_worker(mvt, 4, lambda s: mvt.aggregate(inputs[s][0]))
    want = [sum(_slot_values(s)[i] for s in range(4))
            for i in range(len(LEAF_SHAPES))]
    for r in results.values():
        assert all(isinstance(x, torch.Tensor) for x in r)
        for x, w in zip(r, want):
            np.testing.assert_array_equal(x.numpy(), w)
    for r in single.values():
        np.testing.assert_array_equal(r.numpy(), want[0])
    ptrs = [x.data_ptr() for r in results.values() for x in r]
    assert len(set(ptrs)) == len(ptrs)
    for x in results[0]:
        x.add_(1000.0)
    for s in range(1, 4):
        for x, w in zip(results[s], want):
            np.testing.assert_array_equal(x.numpy(), w)
    for s in range(4):
        for x, w in zip(inputs[s], _slot_values(s)):
            np.testing.assert_array_equal(x.numpy(), w)


def test_aggregate_mixed_host_and_device_is_fatal():
    """Mixing host and device values in one round is fatal on the reducing
    slot, and its peers are released (the barrier is aborted), not
    wedged."""
    mvt.init(ma=True, local_workers=2, device="cpu")
    errors = {}

    def run(slot):
        with mvt.worker(slot):
            value = np.ones(3, np.float32) if slot else torch.ones(3)
            try:
                mvt.aggregate(value)
            except (mvt.log.FatalError, threading.BrokenBarrierError) as exc:
                errors[slot] = exc

    threads = [threading.Thread(target=run, args=(s,), daemon=True)
               for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert isinstance(errors.get(0), mvt.log.FatalError)
    assert "mixed host and device" in str(errors[0])
    assert isinstance(errors.get(1), threading.BrokenBarrierError)


def test_aggregate_across_processes_is_not_ported(monkeypatch):
    """The name is from before the cross-process leg was ported; it now
    holds that leg. In a multi-process world the reducer's local sum goes
    through the runtime's host allreduce (its real form is driven across
    processes in tests/test_torch_multihost_modes.py) and comes back in
    the caller's shape: host arrays, leaf lists, tensors on their device
    in their dtype."""
    mvt.init(ma=True, device="cpu")
    seen = []

    class Peer:  # the other rank contributes twice what this one does
        def allreduce_host(self, leaves):
            seen.append([np.array(x) for x in leaves])
            return [x + 2 * x for x in leaves]

    monkeypatch.setattr(mvt.Zoo.instance(), "multihost", Peer())
    np.testing.assert_array_equal(mvt.aggregate(np.ones(2, np.float32)),
                                  np.full(2, 3.0, np.float32))
    got = mvt.aggregate([np.ones(2, np.float32), np.full(3, 2.0, np.float32)])
    np.testing.assert_array_equal(got[1], np.full(3, 6.0, np.float32))
    t = mvt.aggregate(torch.arange(4, dtype=torch.float64))
    assert t.dtype == torch.float64 and t.device == torch.device("cpu")
    assert torch.equal(t, 3 * torch.arange(4, dtype=torch.float64))
    assert all(isinstance(x, np.ndarray) for leaves in seen for x in leaves)


def test_aggregate_single_worker_returns_a_copy():
    mvt.init(ma=True, device="cpu")
    x = torch.arange(4, dtype=torch.float32)
    y = mvt.aggregate(x)
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()
    h = np.arange(3, dtype=np.float32)
    g = mvt.aggregate(h)
    np.testing.assert_array_equal(g, h)
    assert not np.shares_memory(g, h)
