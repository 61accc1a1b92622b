"""The port's ring attention and Ulysses reshard against the JAX package's.

The same numpy inputs go through ``multiverso_tpu.parallel.ring`` under
``shard_map`` on the virtual CPU mesh (8 devices; 4 for Ulysses) and
through ``multiverso_tpu_torch.parallel.ring`` in a gloo world of 8 (4)
CPU processes, one torch thread each. Each world is spawned once for the
module; this file's ``__main__`` block is its rank program (argv: rank,
world, rendezvous port, control port, ``ring:<suite>:<outdir>``), which
writes each rank's output blocks to ``<outdir>/rank<r>.npz``.

Tolerances are the JAX tests' (``tests/test_ring.py``): 2e-5, and 3e-5 for
the long sequence. The gradients (dq, dk, dv and the relative-bias table)
are held to 1e-4 absolute and relative: they sum a ring's worth of
float32 block products in another order than XLA's single contraction.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

RUNNER = str(Path(__file__).resolve())
TOL = 2e-5
LONG_TOL = 3e-5
GRAD_TOL = 1e-4


def _qkv(rng, B=2, T=64, H=4, D=16):
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, H, D)).astype(np.float32)
    v = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v


def _grad_inputs():
    rng = np.random.default_rng(5)
    T, H = 64, 4
    q, k, v = _qkv(rng, T=T, H=H)
    rel = rng.normal(size=(H, 2 * T - 1)).astype(np.float32)
    w = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, rel, w


# -- the rank program ----------------------------------------------------------

def _rel_bias(rel, T):
    def bias_fn(q_pos, kv_pos):
        d = q_pos[:, None] - kv_pos[None, :] + T - 1
        return rel[:, d][None]
    return bias_fn


def _blocks(arrays, rank, world):
    import torch
    t = arrays[0].shape[1] // world
    return [torch.from_numpy(a[:, rank * t:(rank + 1) * t].copy())
            for a in arrays]


def ring_suite(rank, world, group, out):
    import torch
    from multiverso_tpu_torch.parallel import ring
    import torch.distributed as dist

    qkv = _qkv(np.random.default_rng(0))
    q, k, v = _blocks(qkv, rank, world)
    for causal in (False, True):
        out[f"full_{causal}"] = ring.ring_attention(
            q, k, v, group, causal=causal).numpy()

    # one rank: the ring IS full attention (a group of rank 0 alone)
    solo = dist.new_group([0], backend="gloo")
    if rank == 0:
        q1, k1, v1 = (torch.from_numpy(a) for a in
                      _qkv(np.random.default_rng(1), T=32))
        out["single"] = ring.ring_attention(q1, k1, v1, solo,
                                            causal=True).numpy()

    q, k, v = _blocks(_qkv(np.random.default_rng(3), B=1, T=512, H=2, D=8),
                      rank, world)
    out["long"] = ring.ring_attention(q, k, v, group).numpy()

    rng = np.random.default_rng(4)
    qkv = _qkv(rng, T=64, H=4)
    rel = torch.from_numpy(rng.normal(size=(4, 127)).astype(np.float32))
    q, k, v = _blocks(qkv, rank, world)
    out["rel"] = ring.ring_attention(q, k, v, group, causal=True,
                                     bias_fn=_rel_bias(rel, 64)).numpy()

    # the backward: d sum(out * w) through the ring
    gq, gk, gv, grel, gw = _grad_inputs()
    q, k, v, w = _blocks((gq, gk, gv, gw), rank, world)
    for t in (q, k, v):
        t.requires_grad_(True)
    rel = torch.from_numpy(grel).requires_grad_(True)
    o = ring.ring_attention(q, k, v, group, causal=True,
                            bias_fn=_rel_bias(rel, 64))
    (o * w).sum().backward()
    out["dq"], out["dk"], out["dv"] = (t.grad.numpy() for t in (q, k, v))
    out["drel"] = rel.grad.numpy()  # this rank's share; the test sums them


def ulysses_suite(rank, world, group, out):
    from multiverso_tpu_torch.parallel import ring

    q, k, v = _blocks(_qkv(np.random.default_rng(2), T=32, H=8), rank, world)
    qh, kh, vh = (ring.ulysses_all_to_all(t, group, to_heads=True)
                  for t in (q, k, v))
    out["heads_shape"] = np.array(qh.shape)
    oh = ring.reference_attention(qh, kh, vh)
    out["ulysses"] = ring.ulysses_all_to_all(oh, group,
                                             to_heads=False).numpy()
    out["roundtrip_equal"] = np.array(bool(
        (ring.ulysses_all_to_all(qh, group, to_heads=False) == q).all()))
    try:
        ring.ulysses_all_to_all(q[:, :, :6], group, to_heads=True)
    except ValueError as e:  # the case under test: the message is checked
        out["h_error"] = np.array(str(e))


def main() -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    _, suite, outdir = sys.argv[5].split(":", 2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[3]}",
                            world_size=world, rank=rank)
    group = dist.new_group(backend="gloo")
    out = {}
    (ring_suite if suite == "ring" else ulysses_suite)(rank, world, group, out)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.barrier(group)
    dist.destroy_process_group()
    print(f"MULTIHOST_CHILD_OK rank={rank}", flush=True)
    return 0


# -- the tests -------------------------------------------------------------------

def _run_world(tmp_path_factory, suite, world):
    from multiverso_tpu_torch.runtime.multihost import spawn_lockstep_world
    outdir = tmp_path_factory.mktemp(f"ring_{suite}")
    spawn_lockstep_world(RUNNER, f"ring:{suite}:{outdir}", world=world,
                         timeout=240, env={"OMP_NUM_THREADS": "1"})
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    return _run_world(tmp_path_factory, "ring", 8)


@pytest.fixture(scope="module")
def ulysses_world(tmp_path_factory):
    return _run_world(tmp_path_factory, "ulysses", 4)


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _jax_ring(n, fn, *arrays):
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp", None, None)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                             out_specs=spec))(*arrays)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ring_world, causal):
    from multiverso_tpu.parallel.ring import ring_attention
    q, k, v = _qkv(np.random.default_rng(0))
    want = _jax_ring(8, lambda q, k, v: ring_attention(q, k, v, "sp",
                                                       causal=causal), q, k, v)
    np.testing.assert_allclose(_cat(ring_world, f"full_{causal}"),
                               np.asarray(want), rtol=TOL, atol=TOL)


def test_ring_attention_single_shard_degenerates(ring_world):
    from multiverso_tpu.parallel.ring import reference_attention
    q, k, v = _qkv(np.random.default_rng(1), T=32)
    want = reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(ring_world[0]["single"], np.asarray(want),
                               rtol=TOL, atol=TOL)
    assert all("single" not in r for r in ring_world[1:])


def test_ulysses_roundtrip_and_attention_matches_jax(ulysses_world):
    from multiverso_tpu.parallel.ring import (reference_attention,
                                              ulysses_all_to_all)
    q, k, v = _qkv(np.random.default_rng(2), T=32, H=8)

    def ulysses_attn(q, k, v):
        qh, kh, vh = (ulysses_all_to_all(t, "sp", to_heads=True)
                      for t in (q, k, v))
        return ulysses_all_to_all(reference_attention(qh, kh, vh), "sp",
                                  to_heads=False)

    want = _jax_ring(4, ulysses_attn, q, k, v)
    np.testing.assert_allclose(_cat(ulysses_world, "ulysses"),
                               np.asarray(want), rtol=TOL, atol=TOL)
    for r in ulysses_world:
        assert tuple(r["heads_shape"]) == (2, 32, 2, 16)
        assert bool(r["roundtrip_equal"])


def test_ulysses_rejects_a_head_count_the_group_does_not_divide(ulysses_world):
    for r in ulysses_world:
        msg = str(r["h_error"])
        assert "axis size 4 must divide the head count 6" in msg
        assert "each shard takes H/4 heads" in msg


def test_ring_attention_long_sequence_matches_jax(ring_world):
    from multiverso_tpu.parallel.ring import ring_attention
    q, k, v = _qkv(np.random.default_rng(3), B=1, T=512, H=2, D=8)
    want = _jax_ring(8, lambda q, k, v: ring_attention(q, k, v, "sp"),
                     q, k, v)
    np.testing.assert_allclose(_cat(ring_world, "long"), np.asarray(want),
                               rtol=LONG_TOL, atol=LONG_TOL)


def test_ring_attention_relative_bias_matches_jax(ring_world):
    import jax.numpy as jnp
    from multiverso_tpu.parallel.ring import ring_attention
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, T=64, H=4)
    rel = jnp.asarray(rng.normal(size=(4, 127)).astype(np.float32))
    want = _jax_ring(8, lambda q, k, v: ring_attention(
        q, k, v, "sp", causal=True, bias_fn=_rel_bias(rel, 64)), q, k, v)
    np.testing.assert_allclose(_cat(ring_world, "rel"), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_ring_attention_gradients_match_jax_grad(ring_world):
    """dq, dk, dv and d(rel) of sum(out * w), causal with a relative bias:
    the port's backward (the inverse hops carry dk and dv home) against
    ``jax.grad`` through ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from multiverso_tpu.parallel.ring import ring_attention

    q, k, v, rel, w = _grad_inputs()
    mesh = Mesh(np.array(jax.devices()[:8]), ("sp",))
    spec = P(None, "sp", None, None)

    def loss(q, k, v, rel):
        out = shard_map(
            lambda q, k, v, rel: ring_attention(
                q, k, v, "sp", causal=True, bias_fn=_rel_bias(rel, 64)),
            mesh=mesh, in_specs=(spec, spec, spec, P()), out_specs=spec)(
                q, k, v, rel)
        return jnp.sum(out * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(q, k, v, rel)
    got = [_cat(ring_world, "dq"), _cat(ring_world, "dk"),
           _cat(ring_world, "dv"), sum(r["drel"] for r in ring_world)]
    for name, g, wnt in zip(("dq", "dk", "dv", "drel"), got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
        assert np.isfinite(g).all()


def _load_lm():
    import importlib.util
    path = (Path(__file__).resolve().parent.parent / "multiverso_tpu_torch"
            / "examples" / "long_context_lm.py")
    spec = importlib.util.spec_from_file_location("port_long_context_lm",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_long_context_lm_example_learns():
    """The twin of ``tests/test_examples.py``'s long-context case at its
    config, on a 4-rank CPU world: the delayed-echo lag (67) spans two
    shard boundaries, so success needs attention across ranks; after the
    final sync the table holds the trained model."""
    report = _load_lm().run(seq=128, dim=48, heads=4, batch=8, steps=250,
                            verbose=False, device="cpu")
    assert report["acc"] > 0.9, f"long-context LM failed to learn: {report}"
    assert report["accs"] == [report["acc"]] * 4
    assert report["lag"] == 67
    losses = report["losses"]
    assert np.mean(losses[-25:]) < np.mean(losses[:25])
    # init + (trained - init) in float32: within an ulp of the model
    assert report["table_gap"] <= 1e-6


def test_long_context_lm_trains_from_the_jax_examples_params():
    """The JAX example's initial parameter dict (its ``init_params``:
    ``jax.random`` draws at scale 0.02, ``rel`` zero) crosses as float32
    tensors of the same shapes and values, and the twin, started from
    them through ``params=``, learns the echo at the test config."""
    import jax
    import jax.numpy as jnp
    import torch
    from multiverso_tpu_torch import convert

    vocab, dim, heads, seq = 32, 48, 4, 128
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    jp = {"emb": 0.02 * jax.random.normal(k[0], (vocab, dim)),
          "rel": jnp.zeros((heads, 2 * seq - 1)),
          "qkv": 0.02 * jax.random.normal(k[2], (dim, 3 * dim)),
          "proj": 0.02 * jax.random.normal(k[3], (dim, dim)),
          "mlp_in": 0.02 * jax.random.normal(k[4], (dim, 4 * dim)),
          "mlp_out": 0.02 * jax.random.normal(k[5], (4 * dim, dim))}
    got = convert.long_context_params_from_jax(
        {n: np.asarray(v) for n, v in jp.items()})
    want = _load_lm().init_params(0, seq, dim, heads, vocab)
    assert set(got) == set(want)
    for n, t in got.items():
        assert t.dtype == torch.float32 and t.shape == want[n].shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(jp[n]))
    report = _load_lm().run(seq=seq, dim=dim, heads=heads, batch=8,
                            steps=250, verbose=False, device="cpu",
                            params=got)
    # the first step's loss is the uniform prediction's, ln(vocab)
    assert abs(report["losses"][0] - np.log(vocab)) < 0.01
    assert report["acc"] > 0.9, report["acc"]


if __name__ == "__main__":
    sys.exit(main())
