#!/usr/bin/env python
"""Torch module synced through the port's parameter server (twin of
``examples/torch_asgd.py``: the Torch-Lua binding's usage shape, via
TorchParamManager).

Run:  python multiverso_tpu_torch/examples/torch_asgd.py [device]

``device`` holds the table: ``cuda`` unless ``cpu`` is given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.ext import MVCallback, TorchParamManager

DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def main():
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(1024, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 1)).astype(np.float32))
    y = X @ w

    mvt.init(device=DEVICE)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 1))
    pm = TorchParamManager(net)
    cb = MVCallback(pm, freq=10)
    opt = torch.optim.SGD(net.parameters(), lr=0.05)

    for step in range(300):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(net(X), y)
        loss.backward()
        opt.step()
        cb.on_batch_end(step)      # sync every 10 batches
    cb.on_epoch_end(0)

    print(f"final loss: {loss.item():.5f}")
    # the table now holds the merged model other workers would pull
    n = sum(int(p.numel()) for p in net.parameters())
    print(f"table holds {n} params; first 3: {pm.table.get()[:3]}")
    mvt.shutdown()


if __name__ == "__main__":
    main()
