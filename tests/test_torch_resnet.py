"""The port's CIFAR ResNet and its ASGD trainer against the JAX package's
(``models/resnet.py`` in both).

One shape for the whole file: depth 8, width 8, 16x16x3 images, 4 classes,
float32 compute. A flax model's variables carried by ``convert`` give the
port's module the same logits, and one train step the same loss,
parameters, momentum and BatchNorm statistics, for both norms (rtol 1e-4,
atol 1e-5: XLA's and torch's CPU convolutions sum in other orders). A
1-worker ASGD run from the JAX trainer's carried table ends at the JAX
table after the layout carry (the same tolerance over 8 steps). The JAX
package's own ResNet tests (``tests/test_resnet.py``) run on the port at
their bars; a checkpoint resumes bitwise in the port and from a JAX
checkpoint through ``convert``. Under bf16 compute on the CPU the port's
logits follow the JAX bf16 logits within 1e-3 relative L2, its float32
ones do not."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.checkpoint import CheckpointDriver as JaxCheckpointDriver
from multiverso_tpu.models import resnet as jr

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import io as mvt_io
from multiverso_tpu_torch.checkpoint import CheckpointDriver, read_array
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.ext import PytreeParamManager
from multiverso_tpu_torch.models.resnet import (ASGDTrainer, ResNetConfig,
                                                evaluate, init_resnet, logits,
                                                make_train_step,
                                                synthetic_cifar, train_state)

SHAPE, CLASSES = (16, 16, 3), 4
SMALL = dict(depth=8, width=8, num_classes=CLASSES)
RTOL, ATOL = 1e-4, 1e-5
BF16_LOGITS_REL = 1e-3
JOIN_S = 300


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


def _configs(norm="group", **kw):
    return (jr.ResNetConfig(**SMALL, norm=norm, compute_dtype=jnp.float32, **kw),
            ResNetConfig(**SMALL, norm=norm, compute_dtype=torch.float32, **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_resnet32_parameter_count_matches_published():
    """lasagne ResNet-32, 464,154 params (binding/python/docs/BENCHMARK.md:57)."""
    _, variables = init_resnet(ResNetConfig(depth=32), 0, device="cpu")
    assert sum(p.numel() for p in variables["params"].values()) == 464_154
    assert "batch_stats" not in variables


def test_depth_must_be_6k_plus_2():
    with pytest.raises(mvt.log.FatalError):
        ResNetConfig(depth=10).blocks_per_stage
    with pytest.raises(mvt.log.FatalError):
        init_resnet(ResNetConfig(depth=10), 0, device="cpu")


def test_init_is_seeded_and_flax_scaled():
    """The flax-free init: a seed fixes every value; kernels follow
    lecun_normal (truncated at 2 std), so each conv's std is close to
    flax's."""
    jcfg, tcfg = _configs()
    _, a = init_resnet(tcfg, 0, (1,) + SHAPE, device="cpu")
    _, b = init_resnet(tcfg, torch.Generator().manual_seed(0), (1,) + SHAPE,
                       device="cpu")
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    _, fv = jr.init_resnet(jcfg, jax.random.PRNGKey(0), (1,) + SHAPE)
    carried = convert.resnet_variables(_np_tree(fv), tcfg, device="cpu")
    for k, p in a["params"].items():
        if p.dim() == 4 and p.numel() >= 500:
            assert abs(float(p.std()) / float(carried["params"][k].std()) - 1) < 0.15
        elif p.dim() == 1:
            assert torch.equal(p, carried["params"][k])


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_carried_flax_variables_give_the_same_logits(norm):
    jcfg, tcfg = _configs(norm)
    model, v = jr.init_resnet(jcfg, jax.random.PRNGKey(0), (1,) + SHAPE)
    tmodel, _ = init_resnet(tcfg, 0, (1,) + SHAPE, device="cpu")
    carried = convert.resnet_variables(_np_tree(v), tcfg, device="cpu")
    X, _ = synthetic_cifar(32, num_classes=CLASSES, shape=SHAPE)
    want = model.apply(v, jnp.asarray(X), train=False, mutable=False)
    _close(logits(tmodel, carried, X), want, "eval logits")
    if norm == "batch":
        want, _ = model.apply(v, jnp.asarray(X), train=True,
                              mutable=["batch_stats"])
        _close(logits(tmodel, carried, X, train=True), want, "train logits")


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_bfloat16_forward_follows_the_jax_precision_policy(norm):
    """On the CPU, under the default bf16 compute, the port's autocast
    forward keeps flax's policy (convolutions and activations in bfloat16,
    the norms' statistics in float32): its logits lie within
    BF16_LOGITS_REL (relative L2) of the JAX bf16 logits, and its float32
    logits do not. Seed 0 reads 3.3e-4 (group) and 1.5e-7 (batch) in bf16
    against 3.9e-3 and 3.3e-3 in float32. (On the card CUDA autocast
    returns GroupNorm's output in float32.)"""
    jcfg = jr.ResNetConfig(**SMALL, norm=norm)
    assert jcfg.compute_dtype == jnp.bfloat16
    model, v = jr.init_resnet(jcfg, jax.random.PRNGKey(0), (1,) + SHAPE)
    X, _ = synthetic_cifar(32, num_classes=CLASSES, shape=SHAPE)
    want = np.asarray(model.apply(v, jnp.asarray(X), train=False,
                                  mutable=False), np.float64)
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        tcfg = ResNetConfig(**SMALL, norm=norm, compute_dtype=dtype)
        tmodel, _ = init_resnet(tcfg, 0, (1,) + SHAPE, device="cpu")
        carried = convert.resnet_variables(_np_tree(v), tcfg, device="cpu")
        got = logits(tmodel, carried, X).double().numpy()
        err[dtype] = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err[torch.bfloat16] < BF16_LOGITS_REL < err[torch.float32], err


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_train_step_matches_jax(norm):
    """One step from carried variables: the loss, every parameter, every
    momentum buffer and (BatchNorm) every running statistic."""
    jcfg, tcfg = _configs(norm)
    model, v = jr.init_resnet(jcfg, jax.random.PRNGKey(0), (1,) + SHAPE)
    tmodel, _ = init_resnet(tcfg, 0, (1,) + SHAPE, device="cpu")
    X, y = synthetic_cifar(64, num_classes=CLASSES, shape=SHAPE)
    carried = convert.resnet_variables(_np_tree(v), tcfg, device="cpu")
    jstate, jloss = jr.make_train_step(model, jcfg)(   # donates v
        jr.train_state(model, jcfg, v), jnp.asarray(X), jnp.asarray(y), 0.05)
    tstate, tloss = make_train_step(tmodel, tcfg)(
        train_state(tmodel, tcfg, carried), X, y, 0.05)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    tree = {"params": jstate["params"]}
    if norm == "batch":
        tree["batch_stats"] = jstate["batch_stats"]
    want = convert.resnet_variables(_np_tree(tree), tcfg, device="cpu")
    mom = convert.resnet_variables(_np_tree({"params": jstate["opt_momentum"],
                                             **({"batch_stats": jstate["batch_stats"]}
                                                if norm == "batch" else {})}),
                                   tcfg, device="cpu")
    # the momentum after one step is the gradient (+ wd * p). Under
    # BatchNorm flax takes the batch variance as E[x^2] - E[x]^2, whose
    # gradient loses digits to cancellation (torch's is centred): there
    # the gradients agree to 1e-4 absolute, the parameters (0.05 of it)
    # to the file's tolerance
    mom_atol = 1e-4 if norm == "batch" else ATOL
    for k in want["params"]:
        _close(tstate["params"][k], want["params"][k], k)
        np.testing.assert_allclose(tstate["opt_momentum"][k].numpy(),
                                   mom["params"][k].numpy(), rtol=RTOL,
                                   atol=mom_atol, err_msg="momentum " + k)
    for k in want.get("batch_stats", {}):
        _close(tstate["batch_stats"][k], want["batch_stats"][k], k)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_train_step_learns_synthetic_task(norm):
    _, cfg = _configs(norm)
    model, variables = init_resnet(cfg, 0, (1,) + SHAPE, device="cpu")
    step = make_train_step(model, cfg)
    state = train_state(model, cfg, variables)
    X, y = synthetic_cifar(512, num_classes=CLASSES, shape=SHAPE)
    first = last = None
    for _ in range(6):
        losses = []
        for i in range(0, 512, 64):
            state, loss = step(state, X[i:i + 64], y[i:i + 64], 0.05)
            losses.append(float(loss))
        first = first if first is not None else np.mean(losses)
        last = np.mean(losses)
    assert last < first * 0.5, (first, last)
    assert evaluate(model, cfg, state, X, y) > 0.8


def test_bfloat16_compute_path_finite():
    """The default compute dtype is bfloat16 (autocast); logits stay
    float32 and training stays finite."""
    cfg = ResNetConfig(**SMALL)
    assert cfg.compute_dtype == torch.bfloat16
    model, variables = init_resnet(cfg, 0, (1,) + SHAPE, device="cpu")
    step = make_train_step(model, cfg)
    state = train_state(model, cfg, variables)
    X, y = synthetic_cifar(128, num_classes=CLASSES, shape=SHAPE)
    assert logits(model, state, X[:8]).dtype == torch.float32
    for i in range(0, 128, 64):
        state, loss = step(state, X[i:i + 64], y[i:i + 64], 0.05)
        assert np.isfinite(float(loss))


def _jax_table(trainer) -> np.ndarray:
    return np.asarray(trainer.manager.table.get())


def test_one_worker_asgd_matches_jax():
    """The same start (the JAX trainer's table carried into the port's),
    the same shard and shuffles, 8 steps: the port's table is the JAX
    table carried across, whether the port syncs after every batch or
    only at the end. The JAX trainer syncs only at the end here: with a
    sync after every batch it moves off its own step sequence (by 2.1e-5
    after 4 steps on this CPU, though each sync returns its input within
    5e-10), and the port does not."""
    jcfg, tcfg = _configs(lr=0.05)
    X, y = synthetic_cifar(256, num_classes=CLASSES, shape=SHAPE)
    mv.init(local_workers=1)
    jt = jr.ASGDTrainer(jcfg, workers=1, sync_freq=100, input_shape=SHAPE)
    start = convert.resnet_table_from_jax(_jax_table(jt), tcfg)
    jt.train(X, y, epochs=2, batch=64)
    want = convert.resnet_table_from_jax(_jax_table(jt), tcfg)
    mv.shutdown()
    mvt.init(local_workers=1, device="cpu")
    for sync_freq in (100, 1):
        pt = ASGDTrainer(tcfg, workers=1, sync_freq=sync_freq,
                         input_shape=SHAPE)
        convert.load_state(pt.manager.table, start, {})
        state = pt.train(X, y, epochs=2, batch=64, timeout=JOIN_S)
        np.testing.assert_allclose(pt.manager.table.get(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=f"sync_freq {sync_freq}")
        assert len(pt.sync_seconds) == (8 if sync_freq == 1 else 0)
        flat = torch.cat([state["params"][k].reshape(-1)
                          for k in sorted(state["params"])])
        np.testing.assert_array_equal(flat.numpy(), pt.manager.table.get())


def test_asgd_trainer_converges_and_merges():
    """4 workers on disjoint shards through ONE table: the merged model
    fits the FULL dataset (tests/test_resnet.py's bar, chance 0.25)."""
    mvt.init(local_workers=4, device="cpu")
    _, cfg = _configs(lr=0.02, momentum=0.5)
    trainer = ASGDTrainer(cfg, workers=4, sync_freq=1, input_shape=SHAPE)
    X, y = synthetic_cifar(1024, num_classes=CLASSES, shape=SHAPE)
    state = trainer.train(X, y, epochs=12, batch=64, timeout=JOIN_S)
    acc = evaluate(trainer.model, cfg, state, X, y)
    assert acc > 0.6, f"merged ASGD model failed to learn: {acc}"


def test_asgd_trainer_pipelined_converges():
    """pipeline=True (one-round-stale sync_pipelined): the merged model
    still fits the full dataset (tests/test_resnet.py's bar)."""
    mvt.init(local_workers=4, device="cpu")
    _, cfg = _configs(lr=0.02, momentum=0.5)
    trainer = ASGDTrainer(cfg, workers=4, sync_freq=1, pipeline=True,
                          input_shape=SHAPE)
    X, y = synthetic_cifar(1024, num_classes=CLASSES, shape=SHAPE)
    state = trainer.train(X, y, epochs=24, batch=64, timeout=JOIN_S)
    acc = evaluate(trainer.model, cfg, state, X, y)
    assert acc > 0.40, f"pipelined ASGD failed to learn: {acc}"


def test_worker_view_deltas_do_not_cancel():
    """Two workers pushing through private-view baselines ACCUMULATE."""
    mvt.init(local_workers=2, device="cpu")
    pm = PytreeParamManager({"w": torch.zeros(4)})
    va, vb = pm.worker_view(), pm.worker_view()
    a = va.sync({"w": torch.ones(4)})
    b = vb.sync({"w": torch.full((4,), 2.0)})
    np.testing.assert_array_equal(b["w"].numpy(), np.full(4, 3.0))
    a2 = va.sync(a)
    np.testing.assert_array_equal(a2["w"].numpy(), np.full(4, 3.0))


def test_asgd_model_checkpoints_and_resumes(tmp_path):
    """Snapshot the trained table, destroy the world, restore into a fresh
    manager: the parameters come back bitwise."""
    mvt.init(local_workers=1, device="cpu")
    _, cfg = _configs(lr=0.05)
    trainer = ASGDTrainer(cfg, workers=1, sync_freq=1, input_shape=SHAPE)
    X, y = synthetic_cifar(256, num_classes=CLASSES, shape=SHAPE)
    trained = trainer.train(X, y, epochs=2, batch=64, timeout=JOIN_S)["params"]
    CheckpointDriver([trainer.manager.table], str(tmp_path),
                     interval_steps=1).step()
    mvt.shutdown()
    mvt.init(local_workers=1, device="cpu")
    pm = PytreeParamManager({k: torch.zeros_like(v) for k, v in trained.items()})
    assert CheckpointDriver([pm.table], str(tmp_path)).restore()
    restored = pm.worker_view(device=True).params
    for k in trained:
        assert torch.equal(restored[k], trained[k]), k


def test_asgd_resumes_from_a_jax_checkpoint(tmp_path):
    """A JAX ASGD checkpoint (the table's flat vector, flax order, HWIO)
    restored into a port trainer through ``convert``: bitwise the JAX
    parameters; the port then trains on from there."""
    jcfg, tcfg = _configs(lr=0.05)
    X, y = synthetic_cifar(256, num_classes=CLASSES, shape=SHAPE)
    mv.init(local_workers=1)
    jt = jr.ASGDTrainer(jcfg, workers=1, sync_freq=1, input_shape=SHAPE)
    jparams = _np_tree(jt.train(X, y, epochs=1, batch=64)["params"])
    JaxCheckpointDriver([jt.manager.table], str(tmp_path),
                        interval_steps=1).step()
    mv.shutdown()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.mvckpt"))
    with mvt_io.get_stream(path, "r") as stream:
        flat = read_array(stream)
    mvt.init(local_workers=1, device="cpu")
    pt = ASGDTrainer(tcfg, workers=1, sync_freq=1, input_shape=SHAPE)
    convert.load_state(pt.manager.table,
                       convert.resnet_table_from_jax(flat, tcfg), {})
    want = convert.resnet_variables({"params": jparams}, tcfg, "cpu")["params"]
    got = pt.manager.worker_view(device=True).params
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(
        convert.resnet_table_to_jax(pt.manager.table.get(), tcfg), flat)
    state = pt.train(X, y, epochs=1, batch=64, timeout=JOIN_S)
    assert all(torch.isfinite(v).all() for v in state["params"].values())
    assert not np.array_equal(pt.manager.table.get(),
                              convert.resnet_table_from_jax(flat, tcfg))
