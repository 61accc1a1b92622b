"""The port's word2vec app against the JAX package.

Function level: the block step (both negative modes, both combine modes,
negative sharing), the pair step and ``_sgns_core`` get the same inputs,
made with numpy, and JAX's own random draws are injected into the port
(``draws=``). They agree within rtol 1e-5, atol 1e-6: float32 sums taken
in another order.

Trainer level: two ``PSTrainer`` submissions (sg+ns, the fused
transaction) from the same tables, carried across by ``convert``, with the
same host seed and JAX's device draws injected through ``draw_hook``
(rtol 1e-4: a few hundred steps of fp32 in another order). The learning
scenarios of ``test_word2vec.py`` run on the port alone. Small shapes: a
few hundred words, dim 16, blocks of a few hundred tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiverso_tpu.models import word2vec as jw
from multiverso_tpu.models.vocab import Dictionary as JDictionary
from multiverso_tpu.ops import sampling as jsampling

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import word2vec as tw
from multiverso_tpu_torch.models.vocab import Dictionary, HuffmanEncoder
from multiverso_tpu_torch.ops import rows, sampling

RTOL, ATOL = 1e-5, 1e-6          # one step, fp32 sums in another order
TRAINER_RTOL = 1e-4              # whole submissions


@pytest.fixture
def port():
    """The port's runtime on the CPU (tests/conftest.py stops only the JAX
    one)."""
    TORCH_FLAGS.reset()
    mvt.init(device="cpu")
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def _dictionary(cls, counts):
    d = cls()
    d.words = [f"w{i}" for i in range(len(counts))]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.asarray(counts, np.int64)
    return d


def _zipf_counts(vocab):
    return np.maximum((1000 / np.arange(1, vocab + 1)).astype(np.int64), 5)


def _configs(**kw):
    return jw.Word2VecConfig(**kw), tw.Word2VecConfig(**kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- sampling and vocab ---------------------------------------------------------

def test_alias_table_and_host_sampler_match_jax():
    counts = _zipf_counts(257)
    p = counts.astype(np.float64) ** 0.75
    for got, want in zip(sampling.build_alias_table(p),
                         jsampling.build_alias_table(p)):
        np.testing.assert_array_equal(got, want)
    draw_t = tw.host_negative_sampler(counts)
    draw_j = jw.host_negative_sampler(counts)
    np.testing.assert_array_equal(draw_t(np.random.default_rng(4), (100, 3)),
                                  draw_j(np.random.default_rng(4), (100, 3)))


def test_device_sampler_picks_like_jax():
    """Given JAX's bucket indices and uniforms, the torch alias sampler
    picks the same ids; its own draws follow counts^0.75."""
    counts = _zipf_counts(50)
    key = jax.random.PRNGKey(9)
    want = jsampling.unigram_negative_sampler(counts)(key, (40, 5))
    k1, k2 = jax.random.split(key)
    idx = np.array(jax.random.randint(k1, (40, 5), 0, 50))
    u = np.array(jax.random.uniform(k2, (40, 5)))
    sampler = sampling.unigram_negative_sampler(counts, device="cpu")
    got = sampler.pick(torch.from_numpy(idx), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    draws = sampler((200_000,), gen).numpy()
    freq = np.bincount(draws, minlength=50) / len(draws)
    p = counts ** 0.75 / (counts ** 0.75).sum()
    np.testing.assert_allclose(freq, p, atol=3e-3)


def test_vocab_and_huffman_match_jax():
    toks = ["a"] * 10 + ["b"] * 5 + ["c"] * 2 + ["d"] * 5
    from multiverso_tpu.models.vocab import HuffmanEncoder as JHuffman
    d, jd = Dictionary.build(toks, min_count=2), JDictionary.build(toks, min_count=2)
    assert (d.words, d.word2id) == (jd.words, jd.word2id)
    np.testing.assert_array_equal(d.counts, jd.counts)
    np.testing.assert_array_equal(d.encode(["b", "x", "a"]), jd.encode(["b", "x", "a"]))
    np.testing.assert_array_equal(d.unigram_cdf(), jd.unigram_cdf())
    np.testing.assert_array_equal(d.keep_probs(1e-1), jd.keep_probs(1e-1))
    counts = _zipf_counts(37)
    h, jh = HuffmanEncoder(counts, 8), JHuffman(counts, 8)
    for name in ("codes", "points", "code_lengths"):
        np.testing.assert_array_equal(getattr(h, name), getattr(jh, name))
    np.testing.assert_array_equal(h.mask(), jh.mask())


def test_init_params_match_jax():
    jcfg, tcfg = _configs(vocab_size=40, dim=8, objective="hs", seed=3)
    want = jw.init_params(jcfg)
    got = tw.init_params(tcfg, device="cpu")
    for name in ("w_in", "w_out"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    carried = convert.word2vec_params(np.asarray(want["w_in"]),
                                      np.asarray(want["w_out"]), device="cpu")
    np.testing.assert_array_equal(carried["w_in"].numpy(), np.asarray(want["w_in"]))
    with pytest.raises(ValueError, match="widths"):
        convert.word2vec_params(np.zeros((3, 4)), np.zeros((3, 5)), "cpu")


# -- steps ------------------------------------------------------------------------

def _tables(rng, rows_in, rows_out, dim):
    w_in = (rng.standard_normal((rows_in, dim)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((rows_out, dim)) * 0.3).astype(np.float32)
    w_in[-1] = w_out[-1] = 0.0  # sentinel rows
    return w_in, w_out


def _jax_block_draws(key, t, tg, window, negatives, pool=None, sampler=None):
    """The draws JAX's block step makes from ``key``."""
    k_win, k_neg = jax.random.split(key)
    win = jax.random.randint(k_win, (t,), 1, window + 1)
    if pool is not None:
        neg = jax.random.randint(k_neg, (tg, negatives), 0, pool)
    else:
        neg = sampler(k_neg, (tg, negatives))
    return {"win": np.asarray(win), "neg": np.asarray(neg)}


@pytest.mark.parametrize("neg_table,combine,G", [
    (True, "sum", 1), (True, "sum", 4), (True, "mean", 4), (False, "sum", 2)])
def test_block_step_matches_jax(neg_table, combine, G):
    T, vocab, dim, window, k = 256, 300, 16, 3, 4
    jcfg, tcfg = _configs(vocab_size=vocab, dim=dim, window=window,
                          negatives=k, block_tokens=T, neg_sharing=G,
                          grad_combine=combine, lr=0.2, sample=0.0)
    counts = _zipf_counts(vocab)
    rng = np.random.default_rng(11)
    rows_n = 200 if neg_table else vocab + 1  # compact space or vocabulary
    w_in, w_out = _tables(rng, rows_n, rows_n, dim)
    block = rng.integers(0, rows_n - 1, T).astype(np.int32)
    block[5:9] = -1     # masked tokens inside the block
    block[-20:] = -1    # and a padded tail
    slots = rng.integers(0, rows_n - 1, 512).astype(np.int32)
    key = jax.random.PRNGKey(5)
    lr = 0.2

    jstep = jw.make_block_train_step(jcfg, _dictionary(JDictionary, counts),
                                     jit=False, neg_table=neg_table)
    jparams, jloss, jpairs = jstep(
        {"w_in": jnp.asarray(w_in), "w_out": jnp.asarray(w_out)}, key,
        jnp.asarray(block), lr, jnp.asarray(slots) if neg_table else None,
        with_pairs=True)
    draws = _jax_block_draws(
        key, T, T // G, window, k, pool=len(slots) if neg_table else None,
        sampler=None if neg_table else jsampling.unigram_negative_sampler(counts))

    tstep = tw.make_block_train_step(tcfg, _dictionary(Dictionary, counts),
                                     neg_table=neg_table, device="cpu")
    params = {"w_in": torch.from_numpy(w_in.copy()),
              "w_out": torch.from_numpy(w_out.copy())}
    tparams, tloss, tpairs = tstep(
        params, None, torch.from_numpy(block), lr,
        torch.from_numpy(slots) if neg_table else None, with_pairs=True,
        draws=draws)
    assert tparams["w_in"] is params["w_in"]  # updated in place
    for name in ("w_in", "w_out"):
        _close(tparams[name].numpy(), jparams[name])
    assert float(tpairs) == float(jpairs) > 0
    _close(float(tloss), float(jloss))


def test_block_step_draws_from_its_generator():
    """Without injected draws the step draws from the generator it is
    given: the same seed gives the same update, another seed another."""
    cfg = tw.Word2VecConfig(vocab_size=50, dim=8, window=2, negatives=3,
                            block_tokens=64, sample=0.0)
    step = tw.make_block_train_step(cfg, _dictionary(Dictionary, _zipf_counts(50)),
                                    device="cpu")
    block = torch.from_numpy(np.random.default_rng(0).integers(0, 50, 64).astype(np.int32))

    def run(seed):
        params = tw.init_params(cfg, device="cpu")
        params["w_out"].normal_(generator=torch.Generator().manual_seed(1))
        _, loss = step(params, torch.Generator().manual_seed(seed), block, 0.1)
        assert np.isfinite(float(loss))
        return params["w_in"].numpy()

    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_sgns_core_matches_jax(combine):
    rng = np.random.default_rng(2)
    b, c, t, rows_n, dim = 64, 3, 5, 40, 16
    w_in, w_out = _tables(rng, rows_n, rows_n, dim)
    in_ids = rng.integers(0, rows_n, (b, c)).astype(np.int32)  # duplicates
    in_w = rng.random((b, c)).astype(np.float32)
    in_w[rng.random((b, c)) < 0.2] = 0.0
    out_ids = rng.integers(0, rows_n, (b, t)).astype(np.int32)
    labels = (rng.random((b, t)) < 0.3).astype(np.float32)
    mask = (rng.random((b, t)) < 0.9).astype(np.float32)
    lr = 0.4  # hot rows hit the max_row_step clamp
    jin, jout, jloss = jw._sgns_core(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(in_ids),
        jnp.asarray(in_w), jnp.asarray(out_ids), jnp.asarray(labels),
        jnp.asarray(mask), lr, combine)
    tin, tout, tloss = tw._sgns_core(
        torch.from_numpy(w_in), torch.from_numpy(w_out),
        torch.from_numpy(in_ids), torch.from_numpy(in_w),
        torch.from_numpy(out_ids), torch.from_numpy(labels),
        torch.from_numpy(mask), lr, combine)
    _close(tin.numpy(), jin)
    _close(tout.numpy(), jout)
    _close(float(tloss), float(jloss))


@pytest.mark.parametrize("mode,objective", [("sg", "ns"), ("cbow", "hs")])
def test_pair_step_matches_jax(mode, objective):
    vocab, dim, window, k, b = 60, 16, 2, 3, 128
    jcfg, tcfg = _configs(vocab_size=vocab, dim=dim, window=window,
                          negatives=k, mode=mode, objective=objective,
                          lr=0.1, sample=0.0)
    counts = _zipf_counts(vocab)
    rng = np.random.default_rng(6)
    out_rows = vocab + 1 if objective == "ns" else vocab
    w_in, w_out = _tables(rng, vocab + 1, out_rows, dim)
    centers = rng.integers(0, vocab, b).astype(np.int32)
    if mode == "sg":
        batch = {"centers": centers,
                 "contexts": rng.integers(0, vocab, b).astype(np.int32)}
    else:
        ctx = rng.integers(0, vocab, (b, 2 * window)).astype(np.int32)
        ctx[rng.random(ctx.shape) < 0.3] = -1
        batch = {"centers": centers, "context_block": ctx}
    batch["pair_mask"] = (np.arange(b) < b - 10).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jstep = jw.make_train_step(jcfg, _dictionary(JDictionary, counts))
    jparams, jloss = jstep({"w_in": jnp.asarray(w_in), "w_out": jnp.asarray(w_out)},
                           key, {n: jnp.asarray(v) for n, v in batch.items()}, 0.1)
    draws = None
    if objective == "ns":
        draws = {"neg": np.asarray(
            jsampling.unigram_negative_sampler(counts)(key, (b, k)))}
    tstep = tw.make_train_step(tcfg, _dictionary(Dictionary, counts), device="cpu")
    tparams, tloss = tstep(
        {"w_in": torch.from_numpy(w_in), "w_out": torch.from_numpy(w_out)},
        None, {n: torch.from_numpy(v) for n, v in batch.items()}, 0.1,
        draws=draws)
    for name in ("w_in", "w_out"):
        _close(tparams[name].numpy(), jparams[name])
    _close(float(tloss), float(jloss))


# -- trainers ---------------------------------------------------------------------

class JaxFastDraws:
    """The device draws of the JAX PSTrainer's fast path, step by step:
    keys split 65 at a time from PRNGKey(seed + 1) and popped from the end,
    one per submission; inside it one split per chunk, then the block
    step's own split into window and negative keys."""

    def __init__(self, config):
        self.config = config
        self.fast_key = jax.random.PRNGKey(config.seed + 1)
        self.queue = []
        self.key = None

    def __call__(self, step, t, tg, pool):
        if step == 0:
            if not self.queue:
                keys = jax.random.split(self.fast_key, 65)
                self.fast_key = keys[0]
                self.queue = list(keys[1:])
            self.key = self.queue.pop()
        self.key, sub = jax.random.split(self.key)
        return _jax_block_draws(sub, t, tg, self.config.window,
                                self.config.negatives, pool=pool)


def _logical(server):
    return np.asarray(server.data)[: server.num_row, : server.num_col]


def test_ps_trainer_two_submissions_match_jax(mv_env, port):
    """sg+ns through the fused transaction, two submissions: the same
    tables, losses and pull accounting as the JAX PSTrainer."""
    vocab = 300
    jcfg, tcfg = _configs(vocab_size=vocab, dim=16, window=2, negatives=3,
                          batch_pairs=512, sample=0.0, neg_sharing=2,
                          lr=0.1, seed=5)
    counts = _zipf_counts(vocab)
    p = counts / counts.sum()
    rng = np.random.default_rng(8)
    blocks = [np.searchsorted(np.cumsum(p), rng.random(600)).astype(np.int32)
              for _ in range(2)]

    jtr = jw.PSTrainer(jcfg, _dictionary(JDictionary, counts))
    ttr = tw.PSTrainer(tcfg, _dictionary(Dictionary, counts))
    convert.load_state(ttr.input_table, _logical(jtr.input_table._server_table), {})
    convert.load_state(ttr.output_table, _logical(jtr.output_table._server_table), {})
    ttr.draw_hook = JaxFastDraws(tcfg)
    for block in blocks:
        jloss = jtr.train_block(block)
        tloss = ttr.train_block(block)
        _close(tloss, jloss, rtol=TRAINER_RTOL)
        assert ttr.last_block_stats == jtr.last_block_stats
    _close(ttr.input_table.get(), jtr.input_table.get(), rtol=TRAINER_RTOL)
    _close(ttr.output_table.get(), jtr.output_table.get(), rtol=TRAINER_RTOL)
    assert ttr.count_table.get(0) == jtr.count_table.get(0) == 1200


def test_device_trainer_block_matches_jax():
    """DeviceTrainer's block path (sampler negatives) from the same
    init_params, with JAX's draws injected through the hook."""
    vocab = 200
    kw = dict(vocab_size=vocab, dim=16, window=2, negatives=3, lr=0.2,
              block_tokens=256, sample=0.0, seed=4)
    jcfg, tcfg = _configs(**kw)
    counts = _zipf_counts(vocab)
    block = np.random.default_rng(1).integers(0, vocab, 400).astype(np.int32)
    jtr = jw.DeviceTrainer(jcfg, _dictionary(JDictionary, counts))
    ttr = tw.DeviceTrainer(tcfg, _dictionary(Dictionary, counts), device="cpu")
    sampler = jsampling.unigram_negative_sampler(counts)
    key = [jax.random.PRNGKey(jcfg.seed)]

    def hook(step, t, tg, pool):
        key[0], sub = jax.random.split(key[0])
        return _jax_block_draws(sub, t, tg, 2, 3, sampler=sampler)

    ttr.draw_hook = hook
    for _ in range(2):
        _close(ttr.train_block(block), jtr.train_block(block), rtol=TRAINER_RTOL)
    _close(ttr.embeddings(), jtr.embeddings(), rtol=TRAINER_RTOL)


def test_device_trainer_refuses_missing_card():
    """A DeviceTrainer runs on cuda unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tw.Word2VecConfig(vocab_size=10, dim=8)
    with pytest.raises(mvt.log.FatalError, match="CUDA"):
        tw.DeviceTrainer(cfg, _dictionary(Dictionary, _zipf_counts(10)))


@pytest.mark.parametrize("entry", [
    lambda cfg, d: tw.init_params(cfg),
    lambda cfg, d: tw.make_train_step(cfg, d),
    lambda cfg, d: tw.make_block_train_step(cfg, d, neg_table=True),
    lambda cfg, d: tw.make_corpus_train_step(cfg, d),
    lambda cfg, d: sampling.unigram_negative_sampler(d.counts),
    lambda cfg, d: convert.word2vec_params(np.zeros((11, 8)), np.zeros((11, 8))),
], ids=["init_params", "make_train_step", "make_block_train_step",
        "make_corpus_train_step", "unigram_negative_sampler",
        "word2vec_params"])
def test_entry_points_refuse_missing_card(entry):
    """The tables, steps and samplers go to cuda unless the CPU is asked
    for; without a card they raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tw.Word2VecConfig(vocab_size=10, dim=8, block_tokens=64)
    with pytest.raises(mvt.log.FatalError, match="CUDA"):
        entry(cfg, _dictionary(Dictionary, _zipf_counts(10)))


def test_corpus_step_matches_block_steps():
    cfg = tw.Word2VecConfig(vocab_size=80, dim=8, window=2, negatives=3,
                            block_tokens=64, sample=0.0, neg_sharing=2)
    d = _dictionary(Dictionary, _zipf_counts(80))
    blocks = torch.from_numpy(
        np.random.default_rng(2).integers(0, 80, (3, 64)).astype(np.int32))
    corpus = tw.make_corpus_train_step(cfg, d, device="cpu")
    block_step = tw.make_block_train_step(cfg, d, device="cpu")
    a, b = tw.init_params(cfg, "cpu"), tw.init_params(cfg, "cpu")
    a, loss = corpus(a, torch.Generator().manual_seed(1), blocks, 0.1)
    gen = torch.Generator().manual_seed(1)
    losses = [block_step(b, gen, blk, 0.1)[1] for blk in blocks]
    np.testing.assert_array_equal(a["w_in"].numpy(), b["w_in"].numpy())
    assert float(loss) == pytest.approx(float(torch.stack(losses).mean()))


# -- learning scenarios of test_word2vec.py, on the port alone ------------------------

def _synthetic_corpus(rng, vocab=30, n=6000):
    """Even ids co-occur with even, odd with odd."""
    half = vocab // 2
    blocks = []
    for _ in range(n // 20):
        parity = rng.integers(0, 2)
        blocks.append(parity + 2 * rng.integers(0, half, size=20))
    return np.concatenate(blocks).astype(np.int32)


def _cluster_score(emb, vocab):
    """Mean within-parity cosine sim minus cross-parity sim."""
    norm = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
    sim = norm @ norm.T
    even = np.arange(0, vocab, 2)
    odd = np.arange(1, vocab, 2)
    within = (sim[np.ix_(even, even)].mean() + sim[np.ix_(odd, odd)].mean()) / 2
    return within - sim[np.ix_(even, odd)].mean()


def _toy_dictionary(corpus, vocab):
    counts = np.bincount(corpus, minlength=vocab).astype(np.int64)
    return _dictionary(Dictionary, np.maximum(counts, 1))


@pytest.mark.parametrize("mode,objective,lr,epochs",
                         [("sg", "ns", 0.3, 10), ("cbow", "ns", 0.5, 20),
                          ("sg", "hs", 0.3, 12), ("cbow", "hs", 0.5, 25)])
def test_ps_trainer_all_modes_learn(port, mode, objective, lr, epochs):
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(1), vocab, n=4000)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               mode=mode, objective=objective, lr=lr,
                               batch_pairs=512, sample=0.0)
    trainer = tw.PSTrainer(config, _toy_dictionary(corpus, vocab))
    for _ in range(epochs):
        for i in range(0, len(corpus), 1000):
            trainer.train_block(corpus[i:i + 1000])
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.2, f"PS trainer failed to learn: {score}"
    assert trainer.count_table.get(0) == trainer.words_trained


@pytest.mark.parametrize("neg_sharing", [1, 8])
def test_ps_trainer_grouped_pipelined_learns(port, neg_sharing):
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(4), vocab, n=4000)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               lr=0.3, batch_pairs=512, sample=0.0,
                               neg_sharing=neg_sharing)
    trainer = tw.PSTrainer(config, _toy_dictionary(corpus, vocab))
    blocks = [corpus[i:i + 500] for i in range(0, len(corpus), 500)]
    trainer.train(blocks, epochs=10, group=4)
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.2, f"grouped PS trainer failed to learn: {score}"
    assert trainer.words_trained == len(corpus) * 10
    assert trainer.count_table.get(0) == trainer.words_trained


def test_ps_trainer_adagrad_server_side(port):
    from multiverso_tpu_torch.updaters import AdaGradUpdater
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(2), vocab, n=4000)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               lr=0.5, batch_pairs=512, sample=0.0)
    trainer = tw.PSTrainer(config, _toy_dictionary(corpus, vocab), use_adagrad=True)
    assert isinstance(trainer.input_table._server_table.updater, AdaGradUpdater)
    for _ in range(15):
        for i in range(0, len(corpus), 1000):
            trainer.train_block(corpus[i:i + 1000])
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.15, f"adagrad PS trainer failed to learn: {score}"
    g = trainer.input_table._server_table.states["g_sqr"]
    assert float(g.abs().sum()) > 0.0


@pytest.mark.parametrize("objective", ["ns", "hs"])
def test_ps_trainer_pulls_only_candidate_rows(port, objective):
    vocab = 10_000
    rng = np.random.default_rng(3)
    corpus = rng.integers(0, 500, size=600).astype(np.int32)
    d = _dictionary(Dictionary, np.maximum(
        np.bincount(corpus, minlength=vocab).astype(np.int64), 1))
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=2,
                               objective=objective, batch_pairs=512, sample=0.0)
    trainer = tw.PSTrainer(config, d)
    loss = trainer.train_block(corpus)
    assert np.isfinite(loss)
    stats = trainer.last_block_stats
    assert trainer.input_table.rows_pulled == stats["in_rows"]
    assert trainer.output_table.rows_pulled == stats["out_rows"]
    assert stats["in_rows"] <= 500
    assert stats["out_rows"] < vocab // 2
    assert trainer.embeddings().shape == (vocab, 16)


def test_ps_pipelined_train_matches_serial_volume(port):
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(3), vocab, n=4000)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               lr=0.1, batch_pairs=512, sample=0.0)
    trainer = tw.PSTrainer(config, _toy_dictionary(corpus, vocab))
    blocks = [corpus[i:i + 1000] for i in range(0, len(corpus), 1000)]
    trainer.train(blocks, epochs=3, log_every_s=1e9)
    assert trainer.words_trained == 3 * len(corpus)
    assert trainer.count_table.get(0) == trainer.words_trained
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.2, f"pipelined PS train failed to learn: {score}"


def test_ps_device_io_used_in_process(port):
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(4), vocab, n=2000)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               batch_pairs=512, sample=0.0)
    trainer = tw.PSTrainer(config, _toy_dictionary(corpus, vocab))
    pend = trainer.submit_block(corpus[:1000])
    assert pend is not None and "txn" in pend  # fused transaction path
    loss = trainer.finish_block(pend)
    assert pend["stats"] is not None
    assert np.isfinite(loss)
    assert trainer.input_table.rows_pulled == pend["n_in"]


def _train_port(config, d, corpus, force_staged=False):
    trainer = tw.PSTrainer(config, d)
    if force_staged:
        trainer._can_transact = lambda: False
    for lo in range(0, 3000, 1000):
        trainer.train_block(corpus[lo:lo + 1000])
    return trainer.embeddings(), trainer.output_table.get()


def test_ps_txn_matches_staged_path(port):
    """The fused transaction trains the same model as the staged
    pull/step/push path: the same draws, steps and updates."""
    vocab = 200
    corpus = _synthetic_corpus(np.random.default_rng(7), vocab, n=3000)
    d = _toy_dictionary(corpus, vocab)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=3,
                               batch_pairs=512, sample=0.0, seed=11)
    fused = _train_port(config, d, corpus)
    staged = _train_port(config, d, corpus, force_staged=True)
    for f, s in zip(fused, staged):
        np.testing.assert_allclose(f, s, rtol=2e-4, atol=2e-5)


def test_ps_coalesced_push_routes_and_matches(port, monkeypatch):
    """With rows.COALESCE set, both pushes of the transaction go through
    scatter_add_rows_coalesced; on the CPU its plain version is the same
    index_add_, so the model is bit-identical to the simple scatter's."""
    vocab = 200
    corpus = _synthetic_corpus(np.random.default_rng(7), vocab, n=3000)
    d = _toy_dictionary(corpus, vocab)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=3,
                               batch_pairs=512, sample=0.0, seed=11)
    simple = _train_port(config, d, corpus)
    calls = []
    plain = rows.scatter_add_rows_coalesced_plain
    monkeypatch.setattr(rows, "scatter_add_rows_coalesced_plain",
                        lambda *a: calls.append(a[1].shape[0]) or plain(*a))
    monkeypatch.setattr(rows, "COALESCE", True)
    coalesced = _train_port(config, d, corpus)
    assert len(calls) == 6  # two pushes for each of three blocks
    for c, s in zip(coalesced, simple):
        np.testing.assert_array_equal(c, s)


@pytest.mark.parametrize("mode,objective,lr,epochs",
                         [("sg", "ns", 0.3, 10), ("cbow", "ns", 0.5, 20),
                          ("sg", "hs", 0.3, 10)])
def test_device_trainer_separates_clusters(mode, objective, lr, epochs):
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(0), vocab)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               mode=mode, objective=objective, lr=lr,
                               batch_pairs=512, sample=0.0)
    trainer = tw.DeviceTrainer(config, _toy_dictionary(corpus, vocab), device="cpu")
    trainer.train([corpus[i:i + 1000] for i in range(0, len(corpus), 1000)],
                  epochs=epochs)
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.2, f"clusters not separated: {score}"


def test_device_trainer_neg_sharing_learns():
    vocab = 30
    corpus = _synthetic_corpus(np.random.default_rng(0), vocab)
    config = tw.Word2VecConfig(vocab_size=vocab, dim=16, window=2, negatives=4,
                               lr=0.3, batch_pairs=512, sample=0.0,
                               block_tokens=1000, neg_sharing=8)
    trainer = tw.DeviceTrainer(config, _toy_dictionary(corpus, vocab), device="cpu")
    trainer.train([corpus[i:i + 1000] for i in range(0, len(corpus), 1000)],
                  epochs=10)
    score = _cluster_score(trainer.embeddings(), vocab)
    assert score > 0.3, f"neg_sharing=8 failed to learn: {score}"


@pytest.mark.parametrize("mode,objective", [("cbow", "ns"), ("sg", "hs"),
                                            ("cbow", "hs")])
def test_small_blocks_still_train_pair_mode(mode, objective):
    cfg = tw.Word2VecConfig(vocab_size=30, dim=8, window=2, negatives=3,
                            lr=0.1, sample=0.0, mode=mode, objective=objective,
                            batch_pairs=4096, seed=1)
    t = tw.DeviceTrainer(cfg, _dictionary(Dictionary, _zipf_counts(30)), device="cpu")
    init = t.embeddings().copy()
    block = np.random.default_rng(0).integers(0, 30, 200).astype(np.int32)
    loss = t.train_block(block)
    assert np.isfinite(loss) and loss > 0.0
    t.train_block(block)  # w_out starts at zeros: w_in moves from step 2
    assert np.abs(t.embeddings() - init).max() > 1e-6


# -- host helpers -------------------------------------------------------------------

@pytest.mark.parametrize("binary", [False, True])
def test_save_load_embeddings_roundtrip(tmp_path, binary):
    """word2vec interchange format, byte-identical to the JAX package's."""
    d = _dictionary(Dictionary, [5, 4, 3])
    d.words = ["alpha", "beta", "gamma"]
    emb = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    path, jpath = str(tmp_path / "emb"), str(tmp_path / "jemb")
    tw.save_embeddings(d, emb, path, binary=binary)
    jw.save_embeddings(d, emb, jpath, binary=binary)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    words, mat = tw.load_embeddings("file://" + path, binary=binary)
    assert words == d.words
    if binary:
        np.testing.assert_array_equal(mat, emb)
    else:
        np.testing.assert_allclose(mat, emb, rtol=1e-5)  # %g text round trip
    with pytest.raises(mvt.log.FatalError, match="protocol"):
        tw.load_embeddings("hdfs://x/emb")


def test_pair_generation_matches_jax():
    block = np.arange(50, dtype=np.int32)
    for fn in ("generate_sg_pairs", "generate_cbow_batches"):
        got = getattr(tw, fn)(block, 3, np.random.default_rng(0))
        want = getattr(jw, fn)(block, 3, np.random.default_rng(0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_lr_decays_linearly_over_training():
    assert tw._decayed_lr(0.025, 0, 1000) == pytest.approx(0.025, rel=1e-3)
    assert tw._decayed_lr(0.025, 500, 1000) == pytest.approx(0.0125, rel=1e-2)
    assert tw._decayed_lr(0.025, 10_000, 1000) == pytest.approx(0.025e-4)


def test_lr_decay_reaches_floor_despite_subsampling():
    class Spy:
        class config:
            lr = 0.1
        words_trained = 0
        lrs = []

        def train_block(self, block, lr=None):
            self.lrs.append(lr)
            self.words_trained += len(block) // 3

    spy = Spy()
    tw._train_loop(spy, [np.zeros(90, np.int32)] * 10, epochs=1,
                   log_every_s=1e9, label="")
    assert spy.lrs[-1] == pytest.approx(0.1 * (1 - 810 / 901.0), rel=1e-2)
    assert spy.lrs[0] == pytest.approx(0.1, rel=1e-3)


def test_train_loop_streams_blocks_per_epoch():
    calls = []

    def source():
        calls.append(1)
        return iter([np.zeros(10, np.int32)] * 2)

    class Spy:
        class config:
            lr = 0.1
        words_trained = 0
        seen = []

        def train_block(self, block, lr=None):
            self.seen.append(lr)

    spy = Spy()
    tw._train_loop(spy, source, epochs=3, log_every_s=1e9, label="",
                   total_words=60)
    assert len(calls) == 3
    assert len(spy.seen) == 6
    assert spy.seen[0] > spy.seen[-1]
    with pytest.raises(mvt.log.FatalError, match="total_words"):
        tw._train_loop(spy, source, epochs=1, log_every_s=1e9, label="")
