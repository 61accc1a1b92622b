#!/usr/bin/env python
"""Multi-process parameter server: one table pair split over TWO ranks
(twin of ``examples/multihost_ps.py``; the reference's add-MPI-ranks
scaling story, ``src/zoo.cpp:73-145``).

Run:  python multiverso_tpu_torch/examples/multihost_ps.py [--device DEV]

It self-launches a two-rank ``torch.distributed`` world (gloo) on this
machine. ``DEV`` holds each rank's rows: ``cuda`` (the default; with one
card both ranks share it) or ``cpu``. On several hosts, replace the
self-launch with your per-host launcher and real coordinates: every rank
calls ``mvt.init_distributed(coordinator, world, rank)`` and then
``mvt.init(multihost_endpoint=...)`` with the same flags.

Each rank hosts one worker; both train word2vec shards against ONE
embedding-table pair whose rows are split over the ranks, through the
lockstep dispatcher on rank 0.
"""

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def worker_main(rank: int, world: int, coord: str, ctl: str,
                device: str) -> None:
    """One rank of the world."""
    import numpy as np
    import torch

    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.models.vocab import Dictionary
    from multiverso_tpu_torch.models.word2vec import PSTrainer, Word2VecConfig

    if device == "cpu":
        torch.set_num_threads(1)
    mvt.init_distributed(f"127.0.0.1:{coord}", world, rank)
    mvt.init(local_workers=1, multihost_endpoint=f"127.0.0.1:{ctl}",
             device=device)
    server = mvt.Zoo.instance().device
    print(f"[rank {rank}] world of {mvt.size()} ranks; this rank's rows on "
          f"{server}", flush=True)

    vocab = 500
    rng = np.random.default_rng(0)  # same corpus plan everywhere
    corpus = rng.integers(0, vocab, size=20000).astype(np.int32)
    d = Dictionary()
    d.words = [f"w{i}" for i in range(vocab)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum(np.bincount(corpus, minlength=vocab), 1)

    config = Word2VecConfig(vocab_size=vocab, dim=32, window=3, negatives=4,
                            batch_pairs=1024, sample=0.0)
    trainer = PSTrainer(config, d)  # collective: same tables, same order
    held = trainer.input_table._server_table
    lo, hi = held.row_lo, held.row_hi
    shard = corpus[rank::world]     # this rank's corpus shard
    blocks = [shard[i:i + 2000] for i in range(0, len(shard), 2000)]
    with mvt.worker(0):
        trainer.train(blocks, epochs=2, group=2)
    mvt.process_barrier()
    with mvt.worker(0):
        emb = trainer.embeddings()
        total = trainer.count_table.get(0)
    print(f"[rank {rank}] trained; holds input rows [{lo}, {hi}); the "
          f"shared word-count table saw {total} words across ALL ranks; "
          f"embeddings {emb.shape}", flush=True)
    assert total == len(corpus) * 2  # both ranks' epochs landed
    assert np.isfinite(emb).all()
    mvt.shutdown()
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"MULTIHOST_EXAMPLE_OK rank={rank}", flush=True)


def main(device: str) -> None:
    """Local self-launch so the example runs with one command."""

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    coord, ctl = free_port(), free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--rank", str(rank), "--world", "2",
                          "--coord", str(coord), "--ctl", str(ctl),
                          "--device", device], env=env)
        for rank in range(2)
    ]
    rcs = []
    try:
        # a hung rank is diagnosed (and its sibling killed) here rather
        # than both being orphaned by an outer kill
        rcs = [p.wait(timeout=540) for p in procs]
    finally:
        for rank, p in enumerate(procs):
            if p.poll() is None:
                print(f"killing hung worker rank {rank}", flush=True)
                p.kill()
                p.wait()
    if any(rcs) or len(rcs) != len(procs):
        raise SystemExit(f"worker processes failed: rcs={rcs}")
    print("multihost example finished: one table pair, two ranks")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--coord")
    parser.add_argument("--ctl")
    args = parser.parse_args()
    if args.rank is None:
        main(args.device)
    else:
        worker_main(args.rank, args.world, args.coord, args.ctl, args.device)
