"""The port's binding-extension layer (``multiverso_tpu_torch.ext``): every
case of ``tests/test_ext.py`` on the port (``device="cpu"``), the values
the contract fixes exact. The pytree manager's twin manages dicts of
tensors; it flattens them in JAX's order (dict keys sorted), so the same
dict lands in the same table layout in both packages."""

import threading

import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.ext import PytreeParamManager as JaxPytreeParamManager

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import ext
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.ext import (MVCallback, PytreeParamManager,
                                      SharedArray, TorchParamManager,
                                      mv_shared, sync_all_shared_vars)
from multiverso_tpu_torch.ext.param_manager import tree_flatten, tree_unflatten


@pytest.fixture(autouse=True)
def port_env():
    """Fresh port flags, an empty shared-variable registry, no runtime left
    behind; tiny tensors on one intra-op thread."""
    TORCH_FLAGS.reset()
    ext.sharedvar.shared_vars.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        ext.sharedvar.shared_vars.clear()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


@pytest.fixture
def port_cpu():
    mvt.init(device="cpu")


def test_shared_array_init_and_sync(port_cpu):
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    sv = SharedArray(v)
    np.testing.assert_array_equal(sv.value, v)
    sv.value = sv.value + 1.0
    merged = sv.sync()
    np.testing.assert_array_equal(merged, v + 1.0)
    np.testing.assert_array_equal(sv.table.get().reshape(3, 4), v + 1.0)
    # another worker's add arrives: the next sync pulls it
    sv.table.add(np.ones(12, np.float32))
    sv.sync()
    np.testing.assert_array_equal(sv.value, v + 2.0)


def test_shared_array_delta_is_since_last_sync(port_cpu):
    sv = SharedArray(np.zeros(4, np.float32))
    sv.value = np.full(4, 3.0, np.float32)
    sv.sync()
    sv.value = sv.value + 2.0  # delta exactly +2, not +5
    sv.sync()
    np.testing.assert_array_equal(sv.table.get(), np.full(4, 5.0))


def test_shared_array_shape_mismatch_fatal(port_cpu):
    sv = SharedArray(np.zeros((2, 2), np.float32))
    with pytest.raises(mvt.log.FatalError, match="shape mismatch"):
        sv.value = np.zeros(4, np.float32)


def test_non_master_init_contributes_zeros():
    mvt.init(local_workers=2, device="cpu")
    with mvt.worker(1):
        assert not mvt.is_master_worker()
        sv = SharedArray(np.full(6, 7.0, np.float32))
    np.testing.assert_array_equal(sv.value, np.zeros(6))


def test_mv_shared_registry_and_sync_all(port_cpu):
    a = mv_shared(np.zeros(3, np.float32))
    b = mv_shared(np.ones(2, np.float32))
    a.value = a.value + 1.0
    b.value = b.value + 1.0
    sync_all_shared_vars()
    np.testing.assert_array_equal(a.table.get(), np.ones(3))
    np.testing.assert_array_equal(b.table.get(), np.full(2, 2.0))
    assert ext.sharedvar.shared_vars == [a, b]


def test_pytree_param_manager(port_cpu):
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3),
              "b": torch.zeros(3)}
    pm = PytreeParamManager(params)
    assert torch.equal(pm.params["w"], params["w"])
    stepped = {k: v + 1.0 for k, v in pm.params.items()}
    merged = pm.sync(stepped)
    assert isinstance(merged["w"], torch.Tensor)
    np.testing.assert_array_equal(merged["w"].numpy(), params["w"].numpy() + 1)
    np.testing.assert_array_equal(merged["b"].numpy(), np.ones(3))
    # a peer worker's delta lands in the shared table
    pm.table.add(np.ones(15, np.float32))
    merged = pm.sync()
    np.testing.assert_array_equal(merged["b"].numpy(), np.full(3, 2.0))


def test_pytree_table_layout_matches_jax():
    """A nested dict of seeded arrays lands in both packages' tables in the
    same order (keys sorted at every level), and the manager's tree comes
    back with the structure it was given."""
    rng = np.random.default_rng(0)
    tree = {"z": rng.standard_normal((2, 3)).astype(np.float32),
            "a": {"y": rng.standard_normal(4).astype(np.float32),
                  "b": [rng.standard_normal(2).astype(np.float32),
                        rng.standard_normal((1, 2)).astype(np.float32)]}}
    mv.init()
    jax_flat = JaxPytreeParamManager(tree).table.get()
    mv.shutdown()
    mvt.init(device="cpu")
    pm = PytreeParamManager({"a": {"b": [torch.from_numpy(x) for x in tree["a"]["b"]],
                                   "y": torch.from_numpy(tree["a"]["y"])},
                             "z": torch.from_numpy(tree["z"])})
    np.testing.assert_array_equal(pm.table.get(), jax_flat)
    out = pm.params
    assert isinstance(out["a"]["b"], list) and out["a"]["b"][1].shape == (1, 2)
    leaves, treedef = tree_flatten(out)
    assert tree_flatten(tree_unflatten(treedef, leaves))[1] == treedef


def test_pytree_structure_change_fatal(port_cpu):
    pm = PytreeParamManager({"w": torch.zeros(2)})
    with pytest.raises(mvt.log.FatalError):
        pm.sync({"w": torch.zeros(2), "extra": torch.zeros(1)})


def test_torch_param_manager(port_cpu):
    torch.manual_seed(0)
    module = torch.nn.Linear(3, 2)
    ref = [p.detach().clone() for p in module.parameters()]
    pm = TorchParamManager(module)
    with torch.no_grad():
        for p in module.parameters():
            p += 1.0
    pm.sync_all_param()
    for p, r in zip(module.parameters(), ref):
        np.testing.assert_allclose(p.detach().numpy(), r.numpy() + 1.0,
                                   rtol=1e-6)
    n = sum(int(p.numel()) for p in module.parameters())
    pm.table.add(np.ones(n, np.float32))
    pm.sync_all_param()
    for p, r in zip(module.parameters(), ref):
        np.testing.assert_allclose(p.detach().numpy(), r.numpy() + 2.0,
                                   rtol=1e-6)


def test_callback_sync_frequency(port_cpu):
    class CountingManager:
        def __init__(self):
            self.syncs = 0

        def sync_all_param(self):
            self.syncs += 1

    cm = CountingManager()
    cb = MVCallback(cm, freq=2)
    for b in range(4):
        cb.on_batch_end(b)
    assert cm.syncs == 2  # batches 0 and 2
    cb.on_epoch_end(0)
    assert cm.syncs == 3
    with pytest.raises(mvt.log.FatalError):
        MVCallback(cm, freq=0)


def test_shared_array_construction_under_bsp():
    """Seeding from an unbound thread is not charged to worker 0's round
    budget (it would wedge the BSP gate before any round starts)."""
    mvt.init(sync=True, local_workers=2, device="cpu")
    result = {}

    def build():
        sv = SharedArray(np.arange(6, dtype=np.float32).reshape(2, 3))
        result["value"] = np.asarray(sv.value)

    t = threading.Thread(target=build, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "SharedArray seeding wedged the BSP gate"
    np.testing.assert_array_equal(
        result["value"], np.arange(6, dtype=np.float32).reshape(2, 3))
