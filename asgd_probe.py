#!/usr/bin/env python3
"""ASGD diagnostics on one CUDA card: the readings that ``chip_smoke.py``'s
ASGD phase sets its bars and limits from.

    python3 asgd_probe.py                     # every part, on cuda
    python3 asgd_probe.py lr cadence          # some of them
    python3 asgd_probe.py --device cpu        # a rehearsal at depth 8

ResNet-32 (width 16, batch 128, bf16 unless a line says float32) on
``synthetic_cifar(10_240)``, 2 epochs a row, through ``chip_smoke.py``'s
own row functions:

* ``lr``: training-set accuracy at several (lr, momentum): one worker
  without the PS and through a 1-worker ``ASGDTrainer``, and 4 workers,
  blocking and pipelined;
* ``epochs``: 4 workers (blocking) at several (lr, momentum) for more
  epochs than a row's 2;
* ``cadence``: 4 workers' shards run by ONE thread in turns, with the
  trainer's cadence (step, then sync: each step on parameters pulled
  before the 3 peers pushed) and with a pull right before each step,
  beside the threaded trainer;
* ``fault``: rows 3 and 4 in a copy of the port in a temporary directory
  (the checkout is not touched) whose array table acknowledges its 10th
  whole-model push without applying it: the conservation reading that a
  lost push gives;
* ``bf16``: one step on the card against the CPU's float32 and bf16
  steps (``chip_smoke.asgd_bf16_step``);
* ``norm``: row 1's images/s with the port's GroupNorm (autocast's:
  float32 out on the card) and with flax's precision policy (float32
  statistics, the activations' bf16 out), in turns (A B B A).

Prints one JSON line per result (also to ``--out FILE``). Exits 1 without
a card unless ``--device cpu``. About 5 minutes on an H100.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

PARTS = ("lr", "epochs", "cadence", "fault", "bf16", "norm")
LOST_PUSH = 10
# (lr, momentum, float32 compute)
PLAIN = [(0.1, 0.9, False), (0.1, 0.9, True), (0.02, 0.9, False),
         (0.01, 0.9, False), (0.02, 0.5, False)]
PS_ONE = [(0.1, 0.9), (0.02, 0.9), (0.01, 0.9), (0.02, 0.5)]
# (lr, momentum, pipeline)
FOUR = [(0.02, 0.5, False), (0.01, 0.5, False), (0.005, 0.5, False),
        (0.0025, 0.9, False), (0.02, 0.5, True)]
CADENCE = [(0.0025, 0.9), (0.01, 0.5), (0.02, 0.5)]
# (lr, momentum, epochs)
LONG = [(0.02, 0.5, 4), (0.02, 0.5, 8), (0.01, 0.5, 8), (0.005, 0.9, 8),
        (0.02, 0.5, 8)]


def emit(out, **line) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(text + "\n")


def config(resnet, depth, lr, momentum, float32=False):
    return resnet.ResNetConfig(depth=depth, lr=lr, momentum=momentum,
                               **({"compute_dtype": torch.float32}
                                  if float32 else {}))


def in_turns(mvt, resnet, device, cfg, X, y, pull_first: bool,
             workers: int = cs.WORKERS, epochs: int = cs.ASGD_EPOCHS,
             batch: int = cs.ASGD_BATCH) -> float:
    """The 4-worker trainer's shards, shuffles and views, run by one thread
    in turns; returns the merged model's training-set accuracy."""
    from multiverso_tpu_torch.ext import PytreeParamManager
    mvt.init(local_workers=1, device=device)
    try:
        model, v = resnet.init_resnet(cfg, 0, (1,) + X.shape[1:],
                                      device=device)
        pm = PytreeParamManager(v["params"])
        shard = len(X) // workers
        ws = []
        for s in range(workers):
            view = pm.worker_view(device=True)
            lo = s * shard
            ws.append({
                "view": view,
                "state": resnet.train_state(model, cfg, {"params": view.params}),
                "step": resnet.make_train_step(copy.deepcopy(model), cfg),
                "xs": torch.from_numpy(X[lo:lo + shard]).to(device),
                "ys": torch.from_numpy(y[lo:lo + shard].astype(np.int64)).to(device),
                "order": np.arange(shard), "rng": np.random.default_rng(s)})
        for _ in range(epochs):
            for w in ws:
                w["rng"].shuffle(w["order"])
            for i in range(0, shard - batch + 1, batch):
                for w in ws:
                    st = w["state"]
                    if pull_first:
                        st["params"] = w["view"].sync(st["params"])
                    idx = torch.from_numpy(w["order"][i:i + batch]).to(device)
                    st, _ = w["step"](st, w["xs"][idx], w["ys"][idx], cfg.lr)
                    st["params"] = w["view"].sync(st["params"])
                    w["state"] = st
        final = {"params": pm.worker_view(device=True).params}
        return resnet.evaluate(model, cfg, final, X, y)
    finally:
        cs.stop_runtime(mvt)


def plant_lost_push(root: str) -> None:
    path = os.path.join(root, "multiverso_tpu_torch", "tables", "array_table.py")
    with open(path) as f:
        text = f.read()
    apply = "            self._update(self.data, self.states, delta, worker, scalars)\n"
    if text.count(apply) != 1:
        raise SystemExit("asgd_probe: the leaf apply to plant the fault in "
                         "was not found")
    with open(path, "w") as f:
        f.write(text.replace(apply, (
            "            self._pushes = getattr(self, '_pushes', 0) + 1\n"
            f"            if self._pushes != {LOST_PUSH}:\n    " + apply)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("parts", nargs="*", choices=PARTS + ("fault-rows",))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("asgd_probe: torch finds no CUDA device", file=sys.stderr)
        return 1
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models import resnet
    dev, out = args.device, args.out
    depth, n = (32, cs.ASGD_N) if dev == "cuda" else (8, 1024)
    X, y = resnet.synthetic_cifar(n, 10, seed=0, shape=(32, 32, 3))
    parts = args.parts or PARTS
    if dev == "cuda":
        emit(out, card=cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]).splitlines()[0])
    if "fault-rows" in parts:      # inside the copy with the planted fault
        cs.ASGD_CONSERVATION_ATOL = math.inf
        for pipeline in (False, True):
            r = cs.asgd_row(mvt, resnet, dev, config(resnet, depth, 0.02, 0.5),
                            X, y, cs.WORKERS, pipeline=pipeline)
            emit(out, part="fault", lost_push=LOST_PUSH, pipeline=pipeline,
                 pushes=r["pushes"], conservation_max_abs=r["conservation_max_abs"])
        return 0
    # warm-up: the convolutions' first calls at this shape
    cs.asgd_plain_row(resnet, dev, config(resnet, depth, 0.01, 0.9),
                      X[:512], y[:512], epochs=1)
    if "bf16" in parts:
        for ref in (torch.float32, torch.bfloat16):
            emit(out, part="bf16", cpu_reference=str(ref), **cs.asgd_bf16_step(
                resnet, dev, X, y, depth, 16, cs.ASGD_BATCH, ref_dtype=ref))
    if "lr" in parts:
        for lr, mom, f32 in PLAIN:
            r = cs.asgd_plain_row(resnet, dev, config(resnet, depth, lr, mom, f32),
                                  X, y)
            emit(out, part="lr", row="no_ps", lr=lr, momentum=mom, float32=f32,
                 accuracy=r["accuracy"])
        for lr, mom in PS_ONE:
            r = cs.asgd_row(mvt, resnet, dev, config(resnet, depth, lr, mom), X, y, 1)
            emit(out, part="lr", row="ps_1_worker", lr=lr, momentum=mom,
                 accuracy=r["accuracy"])
        for lr, mom, pipeline in FOUR:
            r = cs.asgd_row(mvt, resnet, dev, config(resnet, depth, lr, mom), X, y,
                            cs.WORKERS, pipeline=pipeline)
            emit(out, part="lr", row="4_workers", lr=lr, momentum=mom,
                 pipeline=pipeline, accuracy=r["accuracy"])
    if "epochs" in parts:
        for lr, mom, epochs in LONG:
            r = cs.asgd_row(mvt, resnet, dev, config(resnet, depth, lr, mom), X, y,
                            cs.WORKERS, epochs=epochs)
            emit(out, part="epochs", lr=lr, momentum=mom, epochs=epochs,
                 accuracy=r["accuracy"], s_per_epoch=r["s_per_epoch"])
    if "cadence" in parts:
        for lr, mom in CADENCE:
            cfg = config(resnet, depth, lr, mom)
            line = {f"in_turns_pull_first_{p}": in_turns(mvt, resnet, dev, cfg,
                                                          X, y, p)
                    for p in (False, True)}
            line["threads"] = cs.asgd_row(mvt, resnet, dev, cfg, X, y,
                                          cs.WORKERS)["accuracy"]
            emit(out, part="cadence", lr=lr, momentum=mom, **line)
    if "norm" in parts:
        port_forward = resnet.GroupNorm.forward

        def flax_forward(self, x, train=True):
            with torch.autocast(x.device.type, enabled=False):
                return torch.nn.GroupNorm.forward(self, x.float()).to(x.dtype)

        cfg = config(resnet, depth, **cs.ASGD_ROW12)
        try:
            for name, forward in (("port", port_forward),
                                  ("flax", flax_forward),
                                  ("flax", flax_forward),
                                  ("port", port_forward)):
                resnet.GroupNorm.forward = forward
                r = cs.asgd_plain_row(resnet, dev, cfg, X, y)
                emit(out, part="norm", group_norm=name,
                     images_per_s=r["images_per_s"], accuracy=r["accuracy"])
        finally:
            resnet.GroupNorm.forward = port_forward
    if "fault" in parts:
        here = os.path.dirname(os.path.abspath(__file__))
        with tempfile.TemporaryDirectory(prefix="asgd_probe_") as root:
            shutil.copytree(os.path.join(here, "multiverso_tpu_torch"),
                            os.path.join(root, "multiverso_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            for name in ("chip_smoke.py", "asgd_probe.py"):
                shutil.copy(os.path.join(here, name), root)
            plant_lost_push(root)
            cmd = [sys.executable, os.path.join(root, "asgd_probe.py"),
                   "fault-rows", "--device", dev]
            if out is not None:
                cmd += ["--out", os.path.abspath(out)]
            subprocess.run(cmd, cwd=root, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
