"""CIFAR ResNet family + ASGD training (port of
``multiverso_tpu/models/resnet.py``).

The deep-learning workload behind the reference's only published benchmark
numbers: torch/lasagne ResNet-32 on CIFAR-10, N processes each syncing its
parameters through Multiverso tables every batch
(``binding/lua/docs/BENCHMARK.md:37-39``,
``binding/python/docs/BENCHMARK.md:57-59``):

- He et al.'s CIFAR ResNet-n, n = 6k+2: a 3x3 stem, 3 stages of k
  BasicBlocks at ``width * {1, 2, 4}`` channels, option-A parameter-free
  shortcuts, global average pool, a float32 ``Linear`` (depth 32, width 16
  is the published 464,154-parameter ResNet-32);
- :func:`make_train_step`: SGD with momentum and coupled weight decay,
  ``m = mu*m + g + wd*p; p -= lr*m`` (``torch.optim.sgd.sgd``, which
  computes exactly that), the forward under bfloat16 autocast by default;
- :class:`ASGDTrainer`: worker threads with local replicas syncing their
  deltas through ONE ArrayTable every ``sync_freq`` batches, through the
  model-agnostic trainer of ``ext/asgd.py``.

The model's layers are the flax model's: convolutions 3x3 without bias,
GroupNorm (8 groups, epsilon 1e-6) or BatchNorm (flax's momentum 0.9 and
epsilon 1e-5, running variance from the BIASED batch variance), so
``convert.resnet_variables`` carries a flax model's variables across and
the logits agree. Images arrive NHWC (``synthetic_cifar``'s layout, as in
the JAX package) and are permuted once a batch to an NCHW view in
channels-last memory. The training state is a dict of name -> tensor dicts
(``params``, ``opt_momentum``, ``batch_stats``) that the step updates in
place, where the JAX step donated its input; a module replica per worker
thread runs the forward through ``torch.func.functional_call``.

Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.optim.sgd import sgd

from multiverso_tpu_torch import log
from multiverso_tpu_torch.ext import asgd
from multiverso_tpu_torch.parallel import mesh as mesh_lib


@dataclass
class ResNetConfig:
    depth: int = 32          # 6k+2: 20, 32, 44, 56...
    num_classes: int = 10
    width: int = 16          # channels of stage 1 (paper/benchmark: 16)
    norm: str = "group"      # "group" | "batch"
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16   # autocast around the forward

    @property
    def blocks_per_stage(self) -> int:
        if (self.depth - 2) % 6 != 0:
            log.fatal("ResNet depth must be 6k+2, got %d", self.depth)
        return (self.depth - 2) // 6


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9)``: batch statistics in training (the
    biased variance normalises and enters the running variance), running
    ``mean``/``var`` buffers in evaluation."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9) -> None:
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm(num_groups=8)``, epsilon 1e-6 (torch's default is
    1e-5)."""

    def __init__(self, channels: int) -> None:
        super().__init__(8, channels, eps=1e-6)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return super().forward(x)


def _norm(config: ResNetConfig, channels: int) -> nn.Module:
    if config.norm == "batch":
        return BatchNorm(channels)
    if config.norm != "group":
        log.fatal("ResNet norm must be 'group' or 'batch', got %r", config.norm)
    return GroupNorm(channels)


def _conv(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    """3x3+3x3 residual block with the option-A shortcut (stride-2
    subsample + zero channel padding — parameter-free, the CIFAR-paper and
    benchmark variant)."""

    def __init__(self, config: ResNetConfig, cin: int, channels: int,
                 stride: int = 1) -> None:
        super().__init__()
        self.stride, self.channels = stride, channels
        self.conv1 = _conv(cin, channels, stride)
        self.norm1 = _norm(config, channels)
        self.conv2 = _conv(channels, channels)
        self.norm2 = _norm(config, channels)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x), train))
        y = self.norm2(self.conv2(y), train)
        if x.shape[1] != self.channels or self.stride != 1:
            x = x[:, :, ::self.stride, ::self.stride]
            x = F.pad(x, (0, 0, 0, 0, 0, self.channels - x.shape[1]))
        return F.relu(y + x)


class CifarResNet(nn.Module):
    """Takes NHWC images, returns float32 logits. ``blocks`` holds the 3
    stages' ``3 * blocks_per_stage`` blocks in order (flax's
    ``BasicBlock_<i>``)."""

    def __init__(self, config: ResNetConfig, in_channels: int = 3) -> None:
        super().__init__()
        c = config
        self.config = config
        self.conv = _conv(in_channels, c.width)
        self.norm = _norm(c, c.width)
        blocks, cin = [], c.width
        for stage, mult in enumerate((1, 2, 4)):
            for block in range(c.blocks_per_stage):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(BasicBlock(c, cin, c.width * mult, stride))
                cin = c.width * mult
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, c.num_classes)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        c = self.config
        # NHWC -> an NCHW view in channels-last memory: no copy
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(x.device.type, dtype=c.compute_dtype,
                            enabled=c.compute_dtype != torch.float32):
            x = F.relu(self.norm(self.conv(x), train))
            for block in self.blocks:
                x = block(x, train)
            x = x.mean(dim=(2, 3))                     # global average pool
        with torch.autocast(x.device.type, enabled=False):
            return self.fc(x.float())                  # float32 logits


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init (``lecun_normal``): a normal truncated at
    two standard deviations, scaled so the variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_resnet(config: ResNetConfig, rng: Any = 0,
                input_shape: Tuple[int, ...] = (1, 32, 32, 3),
                device: Any = "cuda") -> Tuple[CifarResNet, dict]:
    """Returns (model, variables) on ``device`` (``cuda`` unless the caller
    asks for the CPU). ``variables`` holds ``params`` and, for
    norm="batch", ``batch_stats``: dicts of name -> tensor, copies of the
    model's own. ``rng`` is a seed or a ``torch.Generator``; the draws are
    taken on the CPU, so every device gets the same values. Kernels take
    flax's ``lecun_normal``, biases 0, norm scales 1."""
    device = mesh_lib.build_device(str(device))
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    model = CifarResNet(config, in_channels=int(input_shape[-1]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 4:                         # conv, OIHW
                _lecun_normal_(p, p.shape[1] * p.shape[2] * p.shape[3], gen)
            elif p.dim() == 2:                         # linear, (out, in)
                _lecun_normal_(p, p.shape[1], gen)
            else:
                p.fill_(1.0)
    model = model.to(device, config.param_dtype)
    variables = {"params": {n: p.detach().clone()
                            for n, p in model.named_parameters()}}
    if config.norm == "batch":
        variables["batch_stats"] = {n: b.detach().clone()
                                    for n, b in model.named_buffers()}
    return model, variables


def _images(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def make_train_step(model: CifarResNet, config: ResNetConfig) -> Callable:
    """``step(variables, images, labels, lr) -> (variables, loss)``: SGD +
    momentum + coupled weight decay, the published benchmark config
    (``binding/python/docs/BENCHMARK.md:57``: batch 128, lr 0.1). The
    momentum rides in ``variables['opt_momentum']``. The step updates the
    tensors of ``variables`` in place and returns the same dict (the JAX
    step donated its input), and the loss as a 0-d tensor.

    ``model`` runs the forward through ``functional_call``, which swaps
    tensors into the module while it runs: give each thread its own
    module."""
    has_bn = config.norm == "batch"

    def step(variables: dict, images: Any, labels: Any, lr: float):
        params = variables["params"]
        names = list(params)
        device = params[names[0]].device
        leaves = [params[n].detach().requires_grad_() for n in names]
        tensors = dict(zip(names, leaves))
        if has_bn:
            tensors.update(variables["batch_stats"])
        logits = functional_call(model, tensors, (_images(images, device),))
        loss = F.cross_entropy(logits, torch.as_tensor(labels, device=device)
                               .long())
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            sgd([params[n] for n in names], list(grads),
                [variables["opt_momentum"][n] for n in names],
                weight_decay=config.weight_decay, momentum=config.momentum,
                lr=float(lr), dampening=0.0, nesterov=False, maximize=False)
        return variables, loss.detach()

    return step


def train_state(model: CifarResNet, config: ResNetConfig, variables) -> dict:
    """Wrap init variables into the train-step state (zero momentum)."""
    out = {"params": variables["params"],
           "opt_momentum": {n: torch.zeros_like(p)
                            for n, p in variables["params"].items()}}
    if config.norm == "batch":
        out["batch_stats"] = variables["batch_stats"]
    return out


def logits(model: CifarResNet, variables: dict, images: Any,
           train: bool = False) -> torch.Tensor:
    """The model's logits under ``variables`` (running BatchNorm
    statistics unless ``train``)."""
    tensors = dict(variables["params"])
    tensors.update(variables.get("batch_stats", {}))
    device = next(iter(variables["params"].values())).device
    with torch.no_grad():
        return functional_call(model, tensors, (_images(images, device),),
                               {"train": train})


def evaluate(model: CifarResNet, config: ResNetConfig, variables, images,
             labels, batch: int = 256) -> float:
    """Top-1 accuracy; BatchNorm uses its running statistics."""
    correct = 0
    for i in range(0, len(images), batch):
        lg = logits(model, variables, images[i:i + batch])
        correct += int((lg.argmax(-1).cpu().numpy()
                        == np.asarray(labels[i:i + batch])).sum())
    return correct / len(images)


class ASGDTrainer(asgd.ASGDTrainer):
    """N worker threads, each with a local replica, syncing through ONE
    ArrayTable (``ext/asgd.py``) — the reference benchmark's topology
    (``binding/lua/docs/BENCHMARK.md:39``: 8 processes, sync per batch)
    with threads instead of MPI ranks.

    Only ``params`` crosses the table: momentum is worker-local (the
    reference's torch optimizers were per-process too), and BatchNorm
    running statistics, if any, stay local as well. The model lives on the
    runtime's device (``mvt.init(device=...)``). ``sync_seconds`` holds the
    worker-side seconds of every sync of the last :meth:`train`, all
    workers together."""

    def __init__(self, config: ResNetConfig, workers: int = 4,
                 sync_freq: int = 1, input_shape=(32, 32, 3),
                 pipeline: bool = False) -> None:
        from multiverso_tpu_torch.runtime.zoo import Zoo
        self.device = Zoo.instance().device
        self.config = config
        self.model, variables = init_resnet(
            config, 0, (1,) + tuple(input_shape), self.device)
        self._state0 = train_state(self.model, config, variables)
        self.final_state = None
        super().__init__(self._state0["params"], workers, sync_freq,
                         pipeline)

    def train(self, images: np.ndarray, labels: np.ndarray, epochs: int = 1,
              batch: int = 128, lr: Optional[float] = None,
              timeout: Optional[float] = None) -> dict:
        """Shard the data across workers, run ASGD, return the final state
        with the merged global params from the table. ``timeout``: seconds
        to wait for the workers; one still running then is fatal (a
        wedged round fails instead of hanging)."""
        cfg = self.config
        lr = cfg.lr if lr is None else lr
        shard = len(images) // self.workers
        dev = self.device

        def make_step(slot: int):
            step = make_train_step(copy.deepcopy(self.model), cfg)
            return lambda state, b: step(state, b[0], b[1], lr)

        def batches(slot: int):
            lo = slot * shard
            # the shard goes to the device once; batches index it there
            xs = _images(images[lo:lo + shard], dev)
            ys = torch.from_numpy(
                np.asarray(labels[lo:lo + shard], np.int64)).to(dev)
            order = np.arange(len(xs))
            rng = np.random.default_rng(slot)
            for _ in range(epochs):
                rng.shuffle(order)
                for i in range(0, len(xs) - batch + 1, batch):
                    idx = torch.from_numpy(order[i:i + batch]).to(dev)
                    yield xs[idx], ys[idx]

        def local_state(slot: int) -> dict:
            return {k: {n: t.clone() for n, t in v.items()}
                    for k, v in self._state0.items() if k != "params"}

        results = self.run(make_step, batches, local_state, timeout)
        self.final_state = dict(results[0])
        # worker 0's last pull may predate peers' final pushes; re-read the
        # settled global value
        self.final_state["params"] = self.global_params()
        return self.final_state


def synthetic_cifar(n: int, num_classes: int = 10, seed: int = 0,
                    shape=(32, 32, 3)) -> Tuple[np.ndarray, np.ndarray]:
    """Learnable CIFAR-shaped task: each class is a fixed random spatial
    template plus noise — linearly separable in principle but requiring a
    real forward pass to fit. Used by tests and the bench."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(num_classes,) + shape).astype(np.float32)
    labels = rng.integers(0, num_classes, n)
    images = (0.6 * templates[labels]
              + rng.normal(size=(n,) + shape).astype(np.float32))
    return images.astype(np.float32), labels.astype(np.int32)
