#!/usr/bin/env python
"""ResNet ASGD through the parameter server on the port (twin of
``examples/resnet_asgd.py``): the reference's published benchmark protocol
(``binding/lua/docs/BENCHMARK.md:37-39``: torch ResNet-32 on CIFAR-10, N
workers syncing through Multiverso tables per batch), scaled to run in
about a minute on synthetic CIFAR-shaped data.

Prints the same three rows the reference's table reports: single-worker
baseline, single-worker WITH sync (the PS overhead row), and N-worker ASGD.

Run:  python multiverso_tpu_torch/examples/resnet_asgd.py [workers] [depth] [device]

``device`` is ``cuda`` unless ``cpu`` is given.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.models.resnet import (ASGDTrainer, ResNetConfig,
                                                evaluate, init_resnet,
                                                make_train_step,
                                                synthetic_cifar, train_state)

WORKERS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
DEPTH = int(sys.argv[2]) if len(sys.argv) > 2 else 8
DEVICE = sys.argv[3] if len(sys.argv) > 3 else "cuda"
SHAPE, CLASSES, N, BATCH, EPOCHS = (16, 16, 3), 4, 1024, 64, 3


def _force(state):
    """Wait for the device before reading the clock."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def baseline(X, y, sync_through_table: bool):
    """1 worker, optionally pushing every batch through the table — the
    reference's '1P1G with Multiverso' overhead row."""
    cfg = ResNetConfig(depth=DEPTH, width=8, norm="group", num_classes=CLASSES,
                       compute_dtype=torch.float32, lr=0.05, momentum=0.5)
    if sync_through_table:
        trainer = ASGDTrainer(cfg, workers=1, sync_freq=1, input_shape=SHAPE)
        t0 = time.time()
        state = trainer.train(X, y, epochs=EPOCHS, batch=BATCH)
        _force(state)
        dt = time.time() - t0
        model = trainer.model
    else:
        model, variables = init_resnet(cfg, 0, (1,) + SHAPE, device=DEVICE)
        step = make_train_step(model, cfg)
        state = train_state(model, cfg, variables)
        t0 = time.time()
        for _ in range(EPOCHS):
            for i in range(0, len(X) - BATCH + 1, BATCH):
                state, _ = step(state, X[i:i + BATCH], y[i:i + BATCH], cfg.lr)
        _force(state)
        dt = time.time() - t0
    return dt / EPOCHS, evaluate(model, cfg, state, X, y)


def main():
    X, y = synthetic_cifar(N, num_classes=CLASSES, shape=SHAPE)

    mvt.init(local_workers=1, device=DEVICE)
    t_plain, acc_plain = baseline(X, y, sync_through_table=False)
    mvt.shutdown()
    print(f"1 worker, no PS    : {t_plain:6.2f} s/epoch  acc {acc_plain:.3f}")

    mvt.init(local_workers=1, device=DEVICE)
    t_ps, acc_ps = baseline(X, y, sync_through_table=True)
    mvt.shutdown()
    over = 100.0 * (t_ps - t_plain) / t_plain
    print(f"1 worker, PS sync  : {t_ps:6.2f} s/epoch  acc {acc_ps:.3f}  "
          f"(overhead {over:+.1f}% — reference row: +10.8%)")

    mvt.init(local_workers=WORKERS, device=DEVICE)
    cfg = ResNetConfig(depth=DEPTH, width=8, norm="group", num_classes=CLASSES,
                       compute_dtype=torch.float32, lr=0.02, momentum=0.5)
    trainer = ASGDTrainer(cfg, workers=WORKERS, sync_freq=1, input_shape=SHAPE)
    t0 = time.time()
    state = trainer.train(X, y, epochs=EPOCHS, batch=BATCH)
    _force(state)
    t_asgd = (time.time() - t0) / EPOCHS
    acc = evaluate(trainer.model, cfg, state, X, y)
    mvt.shutdown()
    print(f"{WORKERS} workers ASGD    : {t_asgd:6.2f} s/epoch  acc {acc:.3f}")


if __name__ == "__main__":
    main()
