"""word2vec under a deterministic server: the step's duplicate-row adds in
a fixed order.

On CUDA ``index_add_`` sums a step's duplicate rows with atomics in an
order that changes from run to run, which breaks the deterministic
server's promise of bitwise-identical tables. Under the ``deterministic``
flag the steps add rows with ``index_put_(accumulate=True)``, which sums
each id's rows in index order with no atomics (sort-based on CUDA; a
serial loop on the CPU, where ``index_add_`` is one too). These tests
hold that order on the CPU: the ordered add equals a plain Python loop
in index order bit for bit, the steps route through it exactly when the
flag is set, two deterministic runs are bitwise equal, and the step
stays within the JAX step's existing tolerance (rtol 1e-5, atol 1e-6:
float32 sums in another order). Whether the card keeps the order is
``chip_smoke.py``'s staged phase, which asserts the two deterministic
runs bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import word2vec as jw
from multiverso_tpu.models.vocab import Dictionary as JDictionary
import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import word2vec as tw
from multiverso_tpu_torch.models.vocab import Dictionary

RTOL, ATOL = 1e-5, 1e-6
T, VOCAB, DIM, WINDOW, NEG = 256, 300, 16, 3, 4


@pytest.fixture
def flags():
    """Fresh port flags; one intra-op thread (worker threads and the
    dispatcher hand torch ops over in turns, which a loaded machine's
    intra-op pool can stall, as in tests/test_torch_sync.py)."""
    TORCH_FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _dictionary(cls, counts):
    d = cls()
    d.words = [f"w{i}" for i in range(len(counts))]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.asarray(counts, np.int64)
    return d


def _counts():
    return np.maximum((1000 / np.arange(1, VOCAB + 1)).astype(np.int64), 5)


def test_ordered_row_add_is_the_index_order_loop():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 7)).astype(np.float32)
    ids = rng.integers(0, 50, 400)          # heavy duplicates
    deltas = (rng.normal(size=(400, 7)) * 10.0 ** rng.integers(
        -6, 3, (400, 1))).astype(np.float32)
    want = table.copy()
    for i, row in enumerate(ids):
        want[row] = want[row] + deltas[i]   # float32, in index order
    got = torch.from_numpy(table.copy())
    tw._add_rows(got, torch.from_numpy(ids), torch.from_numpy(deltas), True)
    np.testing.assert_array_equal(got.numpy(), want)
    other = torch.from_numpy(table.copy())
    tw._add_rows(other, torch.from_numpy(ids), torch.from_numpy(deltas), False)
    np.testing.assert_array_equal(other.numpy(), want)  # CPU: the same loop


def _block_inputs():
    rng = np.random.default_rng(11)
    rows_n = 200
    w_in = (rng.standard_normal((rows_n, DIM)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((rows_n, DIM)) * 0.3).astype(np.float32)
    w_in[-1] = w_out[-1] = 0.0
    block = rng.integers(0, 40, T).astype(np.int32)  # few words: duplicates
    block[-20:] = -1
    slots = rng.integers(0, rows_n - 1, 512).astype(np.int32)
    return w_in, w_out, block, slots


def test_deterministic_block_step_repeats_bitwise_and_matches_jax(flags):
    cfg = dict(vocab_size=VOCAB, dim=DIM, window=WINDOW, negatives=NEG,
               block_tokens=T, neg_sharing=4, lr=0.2, sample=0.0)
    w_in, w_out, block, slots = _block_inputs()
    key = jax.random.PRNGKey(5)
    jstep = jw.make_block_train_step(jw.Word2VecConfig(**cfg),
                                     _dictionary(JDictionary, _counts()),
                                     jit=False, neg_table=True)
    jparams, jloss = jstep({"w_in": jnp.asarray(w_in),
                            "w_out": jnp.asarray(w_out)}, key,
                           jnp.asarray(block), 0.2, jnp.asarray(slots))
    k_win, k_neg = jax.random.split(key)
    draws = {"win": np.asarray(jax.random.randint(k_win, (T,), 1, WINDOW + 1)),
             "neg": np.asarray(jax.random.randint(k_neg, (T // 4, NEG), 0,
                                                  len(slots)))}
    mvt.set_flag("deterministic", True)     # read when the step is built
    step = tw.make_block_train_step(tw.Word2VecConfig(**cfg),
                                    _dictionary(Dictionary, _counts()),
                                    neg_table=True, device="cpu")

    def run():
        params = {"w_in": torch.from_numpy(w_in.copy()),
                  "w_out": torch.from_numpy(w_out.copy())}
        params, loss = step(params, None, torch.from_numpy(block), 0.2,
                            torch.from_numpy(slots), draws=draws)
        return params["w_in"].numpy(), params["w_out"].numpy(), float(loss)

    first, second = run(), run()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(first[0], np.asarray(jparams["w_in"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(first[1], np.asarray(jparams["w_out"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(first[2], float(jloss), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flag", [False, True])
def test_steps_route_through_the_ordered_add_under_the_flag(
        flags, monkeypatch, flag):
    seen = []
    real = tw._add_rows
    monkeypatch.setattr(tw, "_add_rows", lambda t, i, d, ordered: (
        seen.append(ordered), real(t, i, d, ordered))[1])
    mvt.set_flag("deterministic", flag)
    cfg = tw.Word2VecConfig(vocab_size=50, dim=8, window=2, negatives=3,
                            block_tokens=64, sample=0.0)
    d = _dictionary(Dictionary, np.maximum(np.arange(50, 0, -1), 5))
    params = tw.init_params(cfg, device="cpu")
    block = torch.from_numpy(np.arange(64, dtype=np.int32) % 50)
    tw.make_block_train_step(cfg, d, device="cpu")(
        params, torch.Generator().manual_seed(0), block, 0.1)
    pair = tw.make_train_step(cfg, d, device="cpu")
    pair(params, torch.Generator().manual_seed(0),
         {"centers": torch.arange(8), "contexts": torch.arange(8, 16)}, 0.1)
    delta = tw.make_candidate_delta_step(cfg)
    n = 4
    batches = {"in_ids": torch.zeros((1, n, 1), dtype=torch.long),
               "in_weights": torch.ones((1, n, 1)),
               "out_ids": torch.ones((1, n, 2), dtype=torch.long),
               "labels": torch.ones((1, n, 2), dtype=torch.uint8),
               "mask": torch.ones((1, n, 2), dtype=torch.uint8)}
    delta(torch.zeros((4, 8)), torch.zeros((4, 8)), batches, 0.1, 1.0)
    assert len(seen) == 3 + 2 + 2 and set(seen) == {flag}


def test_staged_word2vec_under_the_deterministic_server_repeats_bitwise(
        flags):
    """Two ``PSTrainer`` runs on the staged path under ``-deterministic``
    (the trainer built after ``init``, so its step reads the flag): the
    final tables are bitwise equal. One worker, as in ``chip_smoke.py``:
    Gets stay async under the deterministic server, so with several
    workers what each one reads, and so its deltas, depends on timing."""
    import threading
    cfg = tw.Word2VecConfig(vocab_size=120, dim=8, window=2, negatives=3,
                            block_tokens=128, sample=0.0, batch_pairs=512)
    d = _dictionary(Dictionary, np.maximum(np.arange(120, 0, -1), 5))
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 30, 128).astype(np.int32) for _ in range(4)]

    def run():
        TORCH_FLAGS.reset()
        mvt.init(device="cpu", local_workers=1, deterministic=True)
        try:
            tr = tw.PSTrainer(cfg, d)
            assert not tr._can_transact()

            def work(slot):
                with mvt.worker(slot):
                    for b in blocks:
                        tr.train_block(b)
                    tr.input_table.finish_train()
                    tr.output_table.finish_train()

            threads = [threading.Thread(target=work, args=(0,), daemon=True)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
                assert not t.is_alive()
            with mvt.Zoo.instance().admin():
                return tr.input_table.get(), tr.output_table.get()
        finally:
            mvt.shutdown()

    a, b = run(), run()
    for x, y in zip(a, b):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, y)
