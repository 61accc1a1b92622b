#!/usr/bin/env python
"""Long-context language model trained with RING ATTENTION over a
sequence split across processes (twin of ``examples/long_context_lm.py``),
tied to the parameter server.

The task is a *delayed echo*: the label at position ``t`` is the input
token at ``t - lag``, with ``lag`` spanning several sequence shards, so
the model cannot solve it without attention flowing across ranks, which
is what the ring (``parallel/ring.py``) provides. One attention layer with
a T5-style per-head relative-position bias learns the lookup.

Topology: ``world`` ranks (4 by default), each holding ``seq / world``
positions of every sequence. They form a lockstep world of the port
(``mvt.init_distributed`` + ``mvt.init(multihost_endpoint=...)``), so the
model lives in ONE shared ArrayTable through ``PytreeParamManager``,
seeded by rank 0 (whose dispatcher runs the PS) and read back by every
rank. The ring, the gradient all-reduce and the parameter broadcast run on
a gloo group of their own, never on the world group whose order the
lockstep table collectives own. Parameters are replicated: every rank
computes its shard's cross-entropy sum over the GLOBAL token count, runs
the backward through the ring, and the gradients are summed over the
ranks, which is the JAX example's ``value_and_grad`` of its shard-mapped
loss. Each rank steps the same ``torch.optim.Adam`` (optax's defaults) on
the same sums, so the replicas stay equal. At the end rank 0 syncs the
trained model into the table (``sync_all_param``).

The JAX example draws its initial weights with ``jax.random``; this one
with a seeded ``torch.Generator`` (``convert.long_context_params_from_jax``
carries a JAX parameter dict in through ``params=``).

Run:  python multiverso_tpu_torch/examples/long_context_lm.py [--device DEV]

It self-launches the ranks on this machine; ``DEV`` holds each rank's
model and table shard: ``cuda`` (the default; with one card every rank
shares it) or ``cpu``.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np

NAMES = ("emb", "rel", "qkv", "proj", "mlp_in", "mlp_out")


def make_batch(rng, batch, seq, vocab, lag):
    x = rng.integers(2, vocab, size=(batch, seq)).astype(np.int32)
    y = np.roll(x, lag, axis=1)
    y[:, :lag] = 1  # BOS-ish filler where no source exists
    return x, y


def default_lag(seq, world):
    """More than half the shards: the lookup needs cross-rank attention."""
    t_local = seq // world
    return (world // 2) * t_local + 3 if world > 1 else seq // 2 + 3


def init_params(seed, seq, dim, heads, vocab):
    """The JAX example's shapes and scales (``rel`` starts at zero)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    s = 0.02

    def normal(*shape):
        return s * torch.randn(*shape, generator=g)

    return {"emb": normal(vocab, dim),
            "rel": torch.zeros(heads, 2 * seq - 1),
            "qkv": normal(dim, 3 * dim), "proj": normal(dim, dim),
            "mlp_in": normal(dim, 4 * dim), "mlp_out": normal(4 * dim, dim)}


def forward_local(p, x_blk, seq, heads, group):
    """Per-rank forward: everything local except the ring hops inside
    attention. ``x_blk`` is (B, T_local) int64."""
    import torch
    from multiverso_tpu_torch.parallel.ring import ring_attention

    B, t_local = x_blk.shape
    dim = p["emb"].shape[1]
    h = p["emb"][x_blk]
    g = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)
    q, k, v = (g @ p["qkv"]).split(dim, dim=-1)
    shp = (B, t_local, heads, dim // heads)

    def bias_fn(q_pos, kv_pos):
        # looked up per ring block from global positions: no (T, T) bias
        d = q_pos[:, None] - kv_pos[None, :] + seq - 1
        return p["rel"][:, d][None]  # (1, H, Tq, Tk)

    att = ring_attention(q.reshape(shp), k.reshape(shp), v.reshape(shp),
                         group, causal=False, bias_fn=bias_fn)
    h = h + att.reshape(B, t_local, dim) @ p["proj"]
    g = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-6)
    h = h + torch.relu(g @ p["mlp_in"]) @ p["mlp_out"]
    return h @ p["emb"].T  # tied unembedding -> (B, T_local, vocab)


def rank_main(rank, world, coord, ctl, outdir, cfg, device):
    """One rank of the world; writes ``<outdir>/rank<r>.json``."""
    import resource

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.ext import PytreeParamManager

    if device == "cpu":
        torch.set_num_threads(1)
    seq, dim, heads = cfg["seq"], cfg["dim"], cfg["heads"]
    vocab, batch, lag = cfg["vocab"], cfg["batch"], cfg["lag"]
    t_local = seq // world
    lo = rank * t_local
    mvt.init_distributed(f"127.0.0.1:{coord}", world, rank)
    # the ring's own group, created on every rank in the same order
    group = dist.new_group(backend="gloo")
    mvt.init(local_workers=1, multihost_endpoint=f"127.0.0.1:{ctl}",
             device=device)
    dev = mvt.Zoo.instance().device

    def replicate(tree):
        """Rank 0's tensors on every rank (over the ring's group)."""
        for name in NAMES:
            dist.broadcast(tree[name], src=0, group=group)
        return tree

    if cfg.get("params_file"):
        with np.load(cfg["params_file"]) as f:
            params = {n: torch.from_numpy(f[n].copy()) for n in NAMES}
    else:
        params = init_params(cfg["seed"], seq, dim, heads, vocab)
    params = replicate({n: t.to(dev).contiguous() for n, t in params.items()})
    pm = PytreeParamManager(params)  # the model lives in ONE table
    p = {n: t.clone().requires_grad_(True) for n, t in pm.params.items()}
    opt = torch.optim.Adam([p[n] for n in NAMES], lr=cfg["lr"])
    flat = [p[n] for n in NAMES]

    def shard(a):
        return torch.from_numpy(a[:, lo:lo + t_local]).to(dev, torch.int64)

    def accuracy(params, x, y):
        """Mean over LIVE positions only (t >= lag), summed over ranks."""
        with torch.no_grad():
            pred = forward_local(params, shard(x), seq, heads,
                                 group).argmax(-1)
        live = (torch.arange(lo, lo + t_local, device=dev) >= lag)[None]
        counts = torch.stack([(live & (pred == shard(y))).sum(),
                              live.sum() * pred.shape[0]]).to(torch.float64)
        dist.all_reduce(counts, group=group)
        return float(counts[0] / torch.clamp(counts[1], min=1))

    rng = np.random.default_rng(cfg["seed"])  # the same batches everywhere
    losses = []
    t0 = time.perf_counter()
    for i in range(cfg["steps"]):
        x, y = make_batch(rng, batch, seq, vocab, lag)
        logits = forward_local(p, shard(x), seq, heads, group)
        # mean over the GLOBAL sequence: this shard's sum over all tokens
        loss = F.cross_entropy(logits.reshape(-1, vocab),
                               shard(y).reshape(-1),
                               reduction="sum") / (batch * seq)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        # the replicated parameters' gradient: the sum over the shards
        grads = torch.cat([t.grad.reshape(-1) for t in flat]
                          + [loss.detach().reshape(1)])
        dist.all_reduce(grads, group=group)
        n = 0
        for t in flat:
            t.grad.copy_(grads[n:n + t.numel()].view_as(t))
            n += t.numel()
        losses.append(float(grads[-1]))
        opt.step()
        if cfg["verbose"] and (i + 1) % 50 == 0:
            acc = accuracy(p, x, y)  # the same collectives on every rank
            if rank == 0:
                print(f"step {i + 1}: loss={losses[-1]:.4f} acc={acc:.3f}",
                      flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    # settle the trained model into the shared table (delta sync), from
    # rank 0; the other ranks' replay threads apply it meanwhile
    trained = {n: t.detach().clone() for n, t in p.items()}
    table_gap = None
    if rank == 0:
        pm.params = trained
        with mvt.worker(0):
            pm.sync_all_param()
            table = pm.table.get()
        # the table's flat layout: the leaves in sorted-key order
        want = np.concatenate([trained[n].cpu().numpy().reshape(-1)
                               for n in sorted(NAMES)])
        table_gap = float(np.abs(table - want).max())
    mvt.process_barrier()
    final = replicate({n: t.to(dev).contiguous()
                       for n, t in pm.params.items()})
    x, y = make_batch(rng, batch, seq, vocab, lag)
    acc = accuracy(final, x, y)
    peak_mb = (torch.cuda.max_memory_allocated(dev) / 2**20
               if dev.type == "cuda" else
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "acc": acc, "losses": losses,
                   "table_gap": table_gap, "train_s": train_s,
                   "steps_per_s": cfg["steps"] / train_s,
                   "device": str(dev), "peak_mb": peak_mb}, f)
    mvt.shutdown()
    dist.destroy_process_group()


def run(seq=256, lag=None, dim=64, heads=4, vocab=32, batch=8, steps=300,
        lr=1e-2, seed=0, verbose=True, device="cuda", world=4, params=None,
        timeout=1200.0):
    """Self-launch ``world`` ranks and return rank 0's report (``acc``,
    ``losses``, ``table_gap``, ``steps_per_s``) with every rank's peak
    memory (``peak_mb``). ``params`` (a dict of arrays or tensors) replaces
    the seeded initial weights."""

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    assert seq % world == 0, f"seq {seq} must divide over {world} ranks"
    if lag is None:
        lag = default_lag(seq, world)
    with tempfile.TemporaryDirectory(prefix="long_context_lm_") as outdir:
        cfg = dict(seq=seq, lag=lag, dim=dim, heads=heads, vocab=vocab,
                   batch=batch, steps=steps, lr=lr, seed=seed,
                   verbose=verbose)
        if params is not None:
            cfg["params_file"] = os.path.join(outdir, "params.npz")
            np.savez(cfg["params_file"],
                     **{n: np.asarray(params[n].cpu() if hasattr(
                         params[n], "cpu") else params[n], np.float32)
                        for n in NAMES})
        coord, ctl = free_port(), free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--coord", str(coord), "--ctl", str(ctl),
             "--outdir", outdir, "--config", json.dumps(cfg),
             "--device", device], env=env) for r in range(world)]
        rcs = []
        try:
            # a hung rank is diagnosed (and its siblings killed) here
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for r, p in enumerate(procs):
                if p.poll() is None:
                    print(f"killing hung rank {r}", flush=True)
                    p.kill()
                    p.wait()
        if any(rcs) or len(rcs) != len(procs):
            raise SystemExit(f"rank processes failed: rcs={rcs}")
        ranks = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    report = dict(ranks[0], lag=lag, world=world,
                  peak_mb=[x["peak_mb"] for x in ranks],
                  accs=[x["acc"] for x in ranks])
    if verbose:
        t_local = seq // world
        print(f"final echo accuracy over {world}-rank ring (lag {lag} spans "
              f"{lag // t_local} shard boundaries): {report['acc']:.3f}")
    return report


def main(seq=256, lag=None, dim=64, heads=4, vocab=32, batch=8, steps=300,
         lr=1e-2, seed=0, verbose=True, device="cuda", world=4, params=None):
    """The JAX example's ``main``: train, sync, and return the final echo
    accuracy."""
    return run(seq=seq, lag=lag, dim=dim, heads=heads, vocab=vocab,
               batch=batch, steps=steps, lr=lr, seed=seed, verbose=verbose,
               device=device, world=world, params=params)["acc"]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--coord")
    parser.add_argument("--ctl")
    parser.add_argument("--outdir")
    parser.add_argument("--config")
    args = parser.parse_args()
    if args.rank is None:
        main(device=args.device, world=args.world)
    else:
        rank_main(args.rank, args.world, args.coord, args.ctl, args.outdir,
                  json.loads(args.config), args.device)
