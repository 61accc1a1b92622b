"""The port's multi-process lockstep PS running the apps: PS word2vec
through the named block transaction across row-split tables, the pytree
ASGD sync, and the multihost example's twin.

``w2vturns`` runs in a JAX two-process world and a port two-process world:
the ranks train the same blocks in turn (a barrier after each), the port
starts from the JAX world's initial tables (restored from the JAX
package's snapshot files through the lockstep restore) and its trainers
draw JAX's device draws (``draw_hook``, replaying the JAX trainer's key
chain), which the port's descriptor carries as host draws. The final
tables agree within rtol 1e-4, atol 1e-6 (a few hundred fp32 steps summed
in another order, as ``test_torch_word2vec.py``'s trainer parity) and the
losses within the same. The other scenarios hold the contracts of
``tests/multihost_child.py``."""

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-6


def _corpus_and_config(mv_pkg, vocab=120, n=4000):
    if mv_pkg == "jax":
        from multiverso_tpu.models.vocab import Dictionary
        from multiverso_tpu.models.word2vec import PSTrainer, Word2VecConfig
    else:
        from multiverso_tpu_torch.models.vocab import Dictionary
        from multiverso_tpu_torch.models.word2vec import (PSTrainer,
                                                          Word2VecConfig)
    rng = np.random.default_rng(0)  # same corpus plan on every rank
    corpus = rng.integers(0, vocab, size=n).astype(np.int32)
    d = Dictionary()
    d.words = [f"w{i}" for i in range(vocab)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum(np.bincount(corpus, minlength=vocab), 1)
    config = Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=3,
                            batch_pairs=512, sample=0.0)
    return corpus, d, config, PSTrainer


def run_w2v(mv, rank, world, ctx):
    """Each rank's PSTrainer trains its corpus shard against ONE pair of
    row-split tables through the named fused transaction; the shared
    word-count table saw every rank's words."""
    corpus, d, config, PSTrainer = _corpus_and_config(ctx["pkg"])
    trainer = PSTrainer(config, d)  # collective table creation
    assert trainer._can_transact(), "named-txn path not engaged"
    shard = corpus[rank::world]
    losses = []
    with mv.worker(0):
        for i in range(0, len(shard), 500):
            pend = trainer.submit_block(shard[i:i + 500])
            assert pend is None or "txn" in pend, sorted(pend)
            losses.append(trainer.finish_block(pend))
            assert np.isfinite(losses[-1]), losses
    mv.process_barrier()
    with mv.worker(0):
        emb = trainer.embeddings()
        total = trainer.count_table.get(0)
    assert emb.shape == (config.vocab_size, config.dim)
    assert np.isfinite(emb).all()
    assert total == len(corpus), (total, len(corpus))
    mv.process_barrier()


def run_w2vturns(mv, rank, world, ctx):
    """The parity scenario (module docstring): blocks in turn, starting
    from the JAX world's initial tables, with JAX's draws."""
    corpus, d, config, PSTrainer = _corpus_and_config(ctx["pkg"])
    out = ctx["outdir"]
    trainer = PSTrainer(config, d)
    tables = (trainer.input_table, trainer.output_table)
    paths = [os.path.join(out, f"init_{i}.mvckpt") for i in range(2)]
    if ctx["pkg"] == "jax":
        from multiverso_tpu.checkpoint import store_table
        if rank == 0:
            for table, path in zip(tables, paths):
                store_table(table, path)
    else:
        from multiverso_tpu_torch.checkpoint import load_table
        from test_torch_word2vec import JaxFastDraws
        if rank == 0:
            for table, path in zip(tables, paths):
                load_table(table, path)
        trainer.draw_hook = JaxFastDraws(config)
    mv.process_barrier()
    losses = []
    blocks = [corpus[i:i + 500] for i in range(0, len(corpus), 500)]
    for i, block in enumerate(blocks):
        if i % world == rank:
            with mv.worker(0):
                losses.append(trainer.train_block(block))
        mv.process_barrier()
    with mv.worker(0):
        w_in, w_out = trainer.input_table.get(), trainer.output_table.get()
    np.save(os.path.join(out, f"{ctx['pkg']}_loss_{rank}.npy"),
            np.asarray(losses, np.float64))
    if rank == 0:
        np.savez(os.path.join(out, f"{ctx['pkg']}_w2v.npz"), w_in=w_in,
                 w_out=w_out)
    mv.process_barrier()


def run_asgd(mv, rank, world, ctx):
    """The pytree ASGD sync across processes: each rank's view pushes
    deltas into ONE row-split ArrayTable (the device view falls back to
    the host path in a multi-process world) and pulls the merged model;
    both ranks' steps land exactly."""
    import torch
    from multiverso_tpu_torch.ext import PytreeParamManager
    params = {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}
    pm = PytreeParamManager(params)  # collective table creation
    view = pm.worker_view(device=True)
    assert not view._device  # host path under multihost
    # every view captures its zero baseline BEFORE any rank pushes
    mv.process_barrier()
    with mv.worker(0):
        for _ in range(3):
            params = view.sync({"w": params["w"] + (rank + 1.0),
                                "b": params["b"] + 0.5})
    mv.process_barrier()
    with mv.worker(0):
        merged = view.sync(params)  # no-op delta: pull the global state
    np.testing.assert_array_equal(merged["w"].numpy(),
                                  np.full((4, 3), 3.0 * sum(range(1,
                                                                  world + 1))))
    np.testing.assert_array_equal(merged["b"].numpy(),
                                  np.full(3, 0.5 * 3 * world))
    mv.process_barrier()


SCENARIOS = {"w2v": run_w2v, "w2vturns": run_w2vturns, "asgd": run_asgd}


# -- the tests ----------------------------------------------------------------

from test_torch_multihost import jax_world, port_world  # noqa: E402


def test_multihost_ps_word2vec_matches_jax(tmp_path):
    """Two ranks train word2vec blocks in turn through the named block
    transaction: the port's final tables and losses match the JAX
    package's two-process world fed the same inputs and draws."""
    jax_world("w2vturns", outdir=str(tmp_path))
    port_world("w2vturns", outdir=str(tmp_path))
    want = np.load(tmp_path / "jax_w2v.npz")
    got = np.load(tmp_path / "torch_w2v.npz")
    for name in ("w_in", "w_out"):
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(got["w_out"]).max() > 0  # trained: w_out starts at zero
    for r in range(2):
        losses = np.load(tmp_path / f"torch_loss_{r}.npy")
        assert len(losses) == 4 and (losses > 0).all()
        np.testing.assert_allclose(losses,
                                   np.load(tmp_path / f"jax_loss_{r}.npy"),
                                   rtol=RTOL)


def test_multihost_ps_word2vec_app():
    """The app across processes: two PSTrainers train corpus shards at
    once against one row-split table pair; the shared word-count table
    proves both ranks' traffic landed."""
    port_world("w2v")


def test_multihost_four_process_w2v_app():
    """The app on a 4-process world: corpus split 4 ways."""
    port_world("w2v", world=4)


def test_multihost_pytree_asgd_sync():
    """The pytree ASGD sync through one shared table across two
    processes: both ranks' deltas land in the merged model exactly."""
    port_world("asgd")


def test_multihost_ps_example_runs():
    """The example twin self-launches a 2-rank world on the CPU and trains
    PS word2vec shards against one row-split table pair."""
    script = os.path.join(REPO, "multiverso_tpu_torch", "examples",
                          "multihost_ps.py")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, script, "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST_EXAMPLE_OK rank=0" in out.stdout
    assert "MULTIHOST_EXAMPLE_OK rank=1" in out.stdout
