#!/usr/bin/env python
"""Multi-worker ASGD on one model through the port's parameter server,
using PytreeParamManager over a dict of tensors (twin of
``examples/asgd_param_manager.py``), scaled to run in seconds.

Each worker thread trains on its own data shard and syncs its delta through
a shared ArrayTable every SYNC_FREQ batches; the merged model converges on
the full dataset.

Run:  python multiverso_tpu_torch/examples/asgd_param_manager.py [device]

``device`` holds the table and the model: ``cuda`` unless ``cpu`` is given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import threading

import numpy as np
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.ext import PytreeParamManager

WORKERS, STEPS, SYNC_FREQ = 4, 200, 5
DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def loss_fn(p, X, y):
    return torch.mean((X @ p["w"] + p["b"] - y) ** 2)


def main():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, 16)).astype(np.float32)
    true_w = rng.normal(size=(16,)).astype(np.float32)
    y = X @ true_w + 0.01 * rng.normal(size=2048).astype(np.float32)

    mvt.init(local_workers=WORKERS, device=DEVICE)
    dev = mvt.Zoo.instance().device
    params = {"w": torch.zeros(16, device=dev), "b": torch.zeros((), device=dev)}
    pm = PytreeParamManager(params)     # ONE table for the whole model
    Xt, yt = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    shards = np.array_split(np.arange(2048), WORKERS)
    lock = threading.Lock()  # pm instance is shared; serialize sync sections

    def run(slot):
        with mvt.worker(slot):
            idx = torch.from_numpy(shards[slot]).to(dev)
            Xs, ys = Xt[idx], yt[idx]
            with lock:
                p = pm.params
            for step in range(STEPS):
                leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
                grads = torch.autograd.grad(loss_fn(leaves, Xs, ys),
                                            list(leaves.values()))
                p = {k: v - 0.05 * g for (k, v), g in zip(p.items(), grads)}
                if step % SYNC_FREQ == 0:
                    with lock:
                        p = pm.sync(p)   # push delta, pull merged

    threads = [threading.Thread(target=run, args=(s,)) for s in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    merged = pm.params
    final = float(loss_fn(merged, Xt, yt))
    print(f"final loss on FULL dataset: {final:.5f}")
    print(f"w error: {np.abs(merged['w'].cpu().numpy() - true_w).max():.4f}")
    mvt.shutdown()


if __name__ == "__main__":
    main()
