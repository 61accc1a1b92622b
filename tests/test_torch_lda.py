"""The port's LDA (``models/lda.py``) against the JAX package's.

The same seeded numpy inputs and JAX's uniform draws go through JAX's
jitted ``_make_sweep`` and the port's torch sweep. ``z_new`` must agree
except where JAX's two best scores lie within ``TIE`` of each other (XLA's
and torch's ``log`` may differ in the last bit there); every such position
is counted and printed. The count deltas, the topic totals' delta and the
move count are then exact against what the port's own ``z_new`` implies,
and equal to JAX's where ``z_new`` agrees: they are integer-valued float32
sums. Whole runs (JAX's draws pushed through the port's ``draw_hook``)
end with equal assignments and bitwise-equal tables. The twins of
``tests/test_lda.py`` run on the port at the reference's bars."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as mv
from multiverso_tpu.models import lda as jl

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import lda as tl

TIE = 1e-5
JOIN_S = 120
# one corpus shape for the parity cases: JAX compiles once
VOCAB, TOPICS, DOCS, DOC_LEN = 60, 3, 24, 20


@pytest.fixture
def port():
    TORCH_FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _jax_scores(cfg, wt_rows, nk, slots, z, u):
    """JAX's ``logp + g`` of ``multiverso_tpu/models/lda.py:56-69``, for the
    near-tie rule."""
    K = cfg.num_topics
    live = slots >= 0
    zoh = jax.nn.one_hot(z, K, dtype=jnp.float32) * live[..., None]
    n_dk_excl = zoh.sum(axis=1, keepdims=True) - zoh
    wt = wt_rows[jnp.maximum(slots, 0)]
    logp = (jnp.log(n_dk_excl + cfg.alpha) + jnp.log(wt + cfg.beta)
            - jnp.log(nk + cfg.vocab_size * cfg.beta))
    return np.asarray(logp - jnp.log(-jnp.log(u)))


def _top_gap(scores):
    top2 = np.sort(scores, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _mismatches(z_port, z_jax, scores, what):
    """Positions where the assignments differ; each must be a near-tie."""
    bad = np.argwhere(z_port != z_jax)
    gaps = _top_gap(scores)
    print(f"{what}: {len(bad)} z mismatch(es) "
          f"{[(tuple(b), float(gaps[tuple(b)])) for b in bad]}")
    for b in bad:
        assert gaps[tuple(b)] < TIE, (what, tuple(b), gaps[tuple(b)])
    return len(bad)


def _implied_deltas(slots, z_old, z_new, rows, k):
    live = slots >= 0
    d = np.zeros((rows, k), np.float32)
    np.add.at(d, (slots[live], z_new[live]), 1.0)
    np.add.at(d, (slots[live], z_old[live]), -1.0)
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_matches_jax_given_jax_draws(seed):
    rng = np.random.default_rng(seed)
    cfg = jl.LDAConfig(VOCAB, TOPICS, alpha=0.5, beta=0.1, seed=seed)
    rows = 32
    wt_rows = rng.integers(0, 9, size=(rows, TOPICS)).astype(np.float32)
    nk = wt_rows.sum(axis=0) + rng.integers(0, 5, TOPICS).astype(np.float32)
    slots = rng.integers(0, rows, size=(DOCS, DOC_LEN)).astype(np.int32)
    slots[:, DOC_LEN - 3:] = -1  # pads
    z = rng.integers(0, TOPICS, size=(DOCS, DOC_LEN)).astype(np.int32)
    z[slots < 0] = 0
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (DOCS, DOC_LEN, TOPICS), minval=1e-10,
                           maxval=1.0)

    jz, jd_wt, jd_nk, jmoved = jl._make_sweep(cfg)(
        jnp.asarray(wt_rows), jnp.asarray(nk), jnp.asarray(slots),
        jnp.asarray(z), key)
    jz, jd_wt, jd_nk = map(np.asarray, (jz, jd_wt, jd_nk))

    tcfg = tl.LDAConfig(VOCAB, TOPICS, alpha=0.5, beta=0.1, seed=seed)
    tz, td_wt, td_nk, tmoved = tl._make_sweep(tcfg, "cpu")(
        torch.from_numpy(wt_rows), torch.from_numpy(nk),
        torch.from_numpy(slots), torch.from_numpy(z),
        uniform=torch.from_numpy(np.array(u)))
    tz, td_wt, td_nk = tz.numpy(), td_wt.numpy(), td_nk.numpy()

    n_bad = _mismatches(tz, jz, _jax_scores(
        cfg, jnp.asarray(wt_rows), jnp.asarray(nk), jnp.asarray(slots),
        jnp.asarray(z), u), f"sweep seed {seed}")
    assert tz.dtype == np.int32 and tz.shape == z.shape
    want = _implied_deltas(slots, z, tz, rows, TOPICS)
    np.testing.assert_array_equal(td_wt, want)
    np.testing.assert_array_equal(td_nk, want.sum(axis=0))
    assert int(tmoved) == int(((slots >= 0) & (tz != z)).sum())
    if n_bad == 0:
        np.testing.assert_array_equal(td_wt, jd_wt)
        np.testing.assert_array_equal(td_nk, jd_nk)
        assert int(tmoved) == int(jmoved)


def test_sweep_draws_come_from_the_generator_by_seed():
    cfg = tl.LDAConfig(VOCAB, TOPICS, seed=3)
    sweep = tl._make_sweep(cfg, "cpu")
    rng = np.random.default_rng(3)
    args = (torch.ones((8, TOPICS)), torch.full((TOPICS,), 8.0),
            torch.from_numpy(rng.integers(0, 8, (4, 6)).astype(np.int32)),
            torch.zeros((4, 6), dtype=torch.int32))
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        runs.append(sweep(*args, generator=g)[0])
    assert torch.equal(runs[0], runs[1])
    u = tl.uniform_draws((1000,), torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    assert float(u.min()) >= tl.U_MIN and float(u.max()) < 1.0


def _jax_draws(seed):
    """JAX PSGibbsLDA's key chain (``lda.py:125-126, :149``), as a hook."""
    state = {"key": jax.random.PRNGKey(seed), "next": 0}

    def hook(i, shape):
        assert i == state["next"]
        state["key"], sub = jax.random.split(state["key"])
        state["next"] += 1
        return np.asarray(jax.random.uniform(sub, shape, minval=1e-10,
                                             maxval=1.0))
    return hook


def _skip_jax_sweeps(hook, n, shape):
    for i in range(n):
        hook(i, shape)


def test_whole_run_matches_jax_with_jax_draws(port, mv_env):
    docs, _ = jl.synthetic_corpus(VOCAB, TOPICS, DOCS, DOC_LEN, seed=7)
    jlda = jl.PSGibbsLDA(jl.LDAConfig(VOCAB, TOPICS, seed=7), docs)
    mvt.init(device="cpu")
    tlda = tl.PSGibbsLDA(tl.LDAConfig(VOCAB, TOPICS, seed=7), docs)
    np.testing.assert_array_equal(tlda.z, jlda.z)
    np.testing.assert_array_equal(tlda.word_topic_counts(),
                                  jlda.word_topic_counts())
    tlda.draw_hook = _jax_draws(7)
    for i in range(3):
        jmoved = jlda.sweep()
        tmoved = tlda.sweep()
        assert _mismatches(tlda.z, jlda.z, np.zeros(jlda.z.shape + (2,)),
                           f"run sweep {i}") == 0
        assert tmoved == jmoved
    np.testing.assert_array_equal(tlda.word_topic_counts(),
                                  jlda.word_topic_counts())
    np.testing.assert_array_equal(tlda.topic_counts.get()[:TOPICS],
                                  np.asarray(jlda.topic_counts.get())[:TOPICS])


def test_lda_state_from_jax_resumes_a_run(port, mv_env):
    docs, _ = jl.synthetic_corpus(VOCAB, TOPICS, DOCS, DOC_LEN, seed=8)
    jlda = jl.PSGibbsLDA(jl.LDAConfig(VOCAB, TOPICS, seed=8), docs)
    jlda.sweep()
    state = convert.lda_state_from_jax(jlda)
    assert state["z"] is not jlda.z
    assert state["word_topic"].shape == (VOCAB, TOPICS)
    np.testing.assert_array_equal(state["topic_counts"],
                                  state["word_topic"].sum(axis=0))
    mvt.init(device="cpu")
    resumed = [row[row >= 0] for row in state["tokens"]]
    tlda = tl.PSGibbsLDA(tl.LDAConfig(VOCAB, TOPICS, seed=8), resumed,
                         pad_to=state["tokens"].shape[1], z=state["z"])
    np.testing.assert_array_equal(tlda.tokens, state["tokens"])
    np.testing.assert_array_equal(tlda.word_topic_counts(),
                                  state["word_topic"])
    np.testing.assert_array_equal(tlda.topic_counts.get()[:TOPICS],
                                  state["topic_counts"])
    hook = _jax_draws(8)
    _skip_jax_sweeps(hook, 1, (DOCS, DOC_LEN, TOPICS))
    tlda.draw_hook = lambda i, shape: hook(i + 1, shape)
    for i in range(2):
        jlda.sweep()
        tlda.sweep()
        assert _mismatches(tlda.z, jlda.z, np.zeros(jlda.z.shape + (2,)),
                           f"resumed sweep {i}") == 0
    np.testing.assert_array_equal(tlda.word_topic_counts(),
                                  jlda.word_topic_counts())


def test_z_given_must_match_the_tokens(port):
    mvt.init(device="cpu")
    docs, _ = tl.synthetic_corpus(VOCAB, TOPICS, 4, 5, seed=0)
    with pytest.raises(RuntimeError, match="z of shape"):
        tl.PSGibbsLDA(tl.LDAConfig(VOCAB, TOPICS), docs,
                      z=np.zeros((3, 5), np.int32))


def test_without_a_device_the_lda_raises_on_a_host_without_cuda(port):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl._make_sweep(tl.LDAConfig(VOCAB, TOPICS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mvt.init()


def test_over_remote_tables_the_device_is_asked_for(port):
    """Tables served by another process have no device here: an instance
    without ``device`` takes ``cuda`` and raises on a host without one;
    with ``device="cpu"`` it pulls and pushes host arrays (the
    reference's path for tables without device IO), counts exact."""
    mvt.init(device="cpu", remote_workers=1, heartbeat_seconds=0)
    mvt.create_table("matrix", VOCAB, TOPICS, np.float32)
    mvt.create_table("array", TOPICS, np.float32)
    client = mvt.remote_connect(mvt.serve("127.0.0.1:0"))
    try:
        tables = (client.table(0), client.table(1))
        docs, _ = tl.synthetic_corpus(VOCAB, TOPICS, DOCS, DOC_LEN, seed=9)
        cfg = tl.LDAConfig(VOCAB, TOPICS, seed=9)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tl.PSGibbsLDA(cfg, docs, tables=tables)
            assert not tables[0].get().any()   # nothing seeded
        lda = tl.PSGibbsLDA(cfg, docs, tables=tables, device="cpu")
        assert not lda._device_io
        pulled = lda.word_topic.rows_pulled
        for _ in range(2):
            lda.sweep()
        assert lda.word_topic.rows_pulled - pulled == 2 * len(
            np.unique(lda.tokens[lda.tokens >= 0]))
        live = lda.tokens >= 0
        implied = np.zeros((VOCAB, TOPICS), np.float32)
        np.add.at(implied, (lda.tokens[live], lda.z[live]), 1.0)
        np.testing.assert_array_equal(lda.word_topic_counts(), implied)
    finally:
        client.close()


# -- twins of tests/test_lda.py ------------------------------------------------

def test_lda_recovers_planted_topics(port):
    mvt.init(device="cpu")
    vocab, topics = 60, 3
    docs, labels = tl.synthetic_corpus(vocab, topics, docs=60, doc_len=40,
                                       seed=1)
    cfg = tl.LDAConfig(vocab, topics, alpha=0.5, beta=0.1, seed=1)
    lda = tl.PSGibbsLDA(cfg, docs)
    lda.run(sweeps=20)
    purity = tl.purity(lda.doc_topics(), labels, topics)
    assert purity > 0.9, f"planted topics not recovered: purity={purity}"
    wt = lda.word_topic_counts()
    per = vocab // topics
    word_top = wt.argmax(axis=1)
    word_purity = np.mean([
        np.bincount(word_top[c * per:(c + 1) * per], minlength=topics).max()
        / per for c in range(topics)])
    assert word_purity > 0.8, f"word clusters not separated: {word_purity}"


def test_lda_count_invariants(port):
    mvt.init(device="cpu")
    vocab, topics = 40, 4
    docs, _ = tl.synthetic_corpus(vocab, topics, docs=30, doc_len=25, seed=2)
    lda = tl.PSGibbsLDA(tl.LDAConfig(vocab, topics, seed=2), docs)
    n_live = int(sum(len(d) for d in docs))
    for _ in range(3):
        lda.sweep()
        wt = lda.word_topic_counts()
        nk = lda.topic_counts.get()[: topics]
        np.testing.assert_allclose(wt.sum(axis=0), nk, atol=1e-3)
        assert abs(wt.sum() - n_live) < 1e-3
        live = lda.tokens >= 0
        implied = np.zeros_like(wt)
        np.add.at(implied, (lda.tokens[live], lda.z[live]), 1.0)
        np.testing.assert_allclose(wt, implied, atol=1e-3)
        # integer-valued counts: exact, not just close
        np.testing.assert_array_equal(wt, implied)


def test_lda_pulls_candidate_rows_only(port):
    mvt.init(device="cpu")
    vocab, topics = 10_000, 3
    docs, _ = tl.synthetic_corpus(90, topics, docs=20, doc_len=30, seed=3)
    lda = tl.PSGibbsLDA(tl.LDAConfig(vocab, topics, seed=3), docs)
    before = lda.word_topic.rows_pulled
    lda.sweep()
    distinct = len(np.unique(lda.tokens[lda.tokens >= 0]))
    assert lda.word_topic.rows_pulled - before == distinct
    assert distinct <= 90


def test_lda_two_workers_shared_tables(port):
    vocab, topics = 60, 3
    docs, labels = tl.synthetic_corpus(vocab, topics, docs=60, doc_len=40,
                                       seed=4)
    mvt.init(local_workers=2, device="cpu")
    shard0 = tl.PSGibbsLDA(tl.LDAConfig(vocab, topics, seed=4), docs[:30])
    tables = (shard0.word_topic, shard0.topic_counts)
    shard1 = tl.PSGibbsLDA(tl.LDAConfig(vocab, topics, seed=5), docs[30:],
                           tables=tables)
    shards = [shard0, shard1]
    errors = []

    def run(slot):
        try:
            with mvt.worker(slot):
                shards[slot].run(sweeps=20)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert not errors, errors
    wt = shard0.word_topic_counts()
    implied = np.zeros_like(wt)
    for s in shards:
        live = s.tokens >= 0
        np.add.at(implied, (s.tokens[live], s.z[live]), 1.0)
    np.testing.assert_allclose(wt, implied, atol=1e-3)
    pred = np.concatenate([shard0.doc_topics(), shard1.doc_topics()])
    purity = tl.purity(pred, labels, topics)
    assert purity > 0.85, f"joint topics not recovered: {purity}"
