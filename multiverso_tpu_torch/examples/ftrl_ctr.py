#!/usr/bin/env python
"""Streaming CTR prediction with the FTRL table — the reference's
``Applications/LogisticRegression`` FTRL mode as a runnable demo, and
the chargeback plane's two-tenant demo (twin of ``examples/ftrl_ctr.py``).

A click-through stream with a few informative features among many noise
ones is fed through a logistic model whose weights live server-side in
an FTRL table (multiverso_tpu_torch/tables/ftrl_table.py): workers ship raw
gradients, the server runs the FTRL-proximal update, and ``get``
materializes weights from the (z, n) accumulators on demand. The l1
term drives noise-feature weights to EXACT zero — the model that comes
back is sparse, which is the whole point of FTRL for CTR.

The run doubles as the chargeback demo: alongside the local FTRL loop,
the trainer publishes each refreshed weight vector over the wire to a
publish table under tenant ``trainer`` while a concurrent model-server
thread read-floods a serving table under tenant ``serving`` (the
``tenant_quota_spec`` flag labels the tables), so the run ends with an
``mvt.chargeback`` table splitting the fleet's time, bytes and admitted
requests between the two (docs/observability.md §Chargeback).

Run:  python multiverso_tpu_torch/examples/ftrl_ctr.py [device]

``device`` holds the tables: ``cuda`` unless ``cpu`` is given.
"""

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.tables.ftrl_table import FTRLWorker

DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _logloss(p, y):
    p = np.clip(p, 1e-7, 1.0 - 1e-7)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def make_ctr_stream(n, d, informative, rng):
    """Synthetic CTR data: ``informative`` features carry signal, the
    rest are noise the l1 penalty should zero out."""
    true_w = np.zeros(d, np.float32)
    idx = rng.choice(d, informative, replace=False)
    true_w[idx] = rng.normal(0, 2.0, informative).astype(np.float32)
    X = (rng.random((n, d)) < 0.1).astype(np.float32)  # sparse binary events
    y = (rng.random(n) < _sigmoid(X @ true_w)).astype(np.float32)
    return X, y, true_w


def main(d=400, informative=16, n=12_000, batch=64, alpha=0.5, beta=1.0,
         lambda1=0.5, lambda2=1.0, verbose=True, device=DEVICE):
    rng = np.random.default_rng(0)
    X, y, _ = make_ctr_stream(n, d, informative, rng)
    Xte, yte = X[-2000:], y[-2000:]
    X, y = X[:-2000], y[:-2000]

    # two tenant labels for the wire traffic (generous quotas — this is
    # labeling, not enforcement): the trainer's weight-publish stream
    # owns table 1, the model-server read flood owns table 2
    mvt.set_flag("tenant_quota_spec",
                "trainer:tables=1,qps=1e6,burst=1e6;"
                "serving:tables=2,qps=1e6,burst=1e6")
    mvt.init(remote_workers=1, device=device)
    mvt.register_table_type("ftrl", FTRLWorker)
    table = mvt.create_table("ftrl", d, alpha=alpha, beta=beta,
                            lambda1=lambda1, lambda2=lambda2)
    mvt.create_table("array", d, np.float32)  # table 1: published weights
    mvt.create_table("array", d, np.float32)  # table 2: serving features
    endpoint = mvt.serve("127.0.0.1:0")
    client = mvt.remote_connect(endpoint)
    publish = client.table(1)
    serving = client.table(2)

    stop = threading.Event()

    def read_flood():
        # tenant "serving": a model-server polling its feature table
        while not stop.is_set():
            serving.get()
            time.sleep(0.002)

    flood = threading.Thread(target=read_flood, daemon=True,
                             name="ctr-read-flood")
    flood.start()

    baseline = _logloss(_sigmoid(Xte @ table.get()), yte)
    w_published = np.zeros(d, np.float32)
    for start in range(0, len(X), batch):
        xb, yb = X[start:start + batch], y[start:start + batch]
        w = table.get()
        p = _sigmoid(xb @ w)
        table.add((xb.T @ (p - yb)) / len(yb))
        # tenant "trainer": push the refreshed model to the publish table
        publish.add(np.asarray(w - w_published, np.float32))
        w_published = w
        if verbose and start % (batch * 50) == 0:
            print(f"samples {start}: streaming logloss "
                  f"{_logloss(p, yb):.4f}")
    stop.set()
    flood.join(timeout=5)
    w = table.get()
    final = _logloss(_sigmoid(Xte @ w), yte)
    sparsity = float((w == 0.0).mean())
    if verbose:
        # who bought which fraction of the machine this run
        mvt.chargeback([endpoint]).display()
    client.close()
    mvt.shutdown()
    mvt.set_flag("tenant_quota_spec", "")
    if verbose:
        print(f"held-out logloss: {baseline:.4f} -> {final:.4f}")
        print(f"final logloss: {final:.4f}")
        print(f"weight sparsity: {sparsity:.3f}")
    return final, sparsity


if __name__ == "__main__":
    main()
