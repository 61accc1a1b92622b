"""The port's example twins (``multiverso_tpu_torch/examples/``) run and
learn at the JAX examples' bars; the addition RNN's flax parameters carry
into the port's module through ``convert.addition_rnn_from_jax``.

``lda_topics``, ``word2vec_train``, ``logreg_train`` and ``word2vec_query``
run as ``python multiverso_tpu_torch/examples/x.py cpu`` subprocesses, so
an argv or import slip in the script itself fails here. ``addition_rnn``
(the reference test's configuration: digits 2, hidden 128, n 10,000, 25
epochs) and ``ftrl_ctr`` (the example's defaults) run in process. The
carried flax model gives the port's module the same logits, and one Adam
step the same loss and parameters, within rtol 1e-5 and atol 1e-5 (XLA's
and torch's CPU matmuls sum in other orders)."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "multiverso_tpu_torch" / "examples"
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def port():
    import multiverso_tpu_torch as mvt
    TORCH_FLAGS.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield mvt
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _load(name):
    """The example script as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(name, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}.py"), "cpu", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert result.returncode == 0, (
        f"{name} exited {result.returncode}:\n"
        f"{(result.stdout + result.stderr)[-2000:]}")
    return result.stdout


def test_lda_topics_example_runs_and_recovers_topics():
    out = _run("lda_topics")
    purity = float(out.split("purity vs planted labels =")[1].split()[0])
    assert purity > 0.8, f"LDA example purity too low: {purity}"


def test_word2vec_train_example_separates_the_parity_classes():
    out = _run("word2vec_train")
    within = float(out.split("within-cluster cosine =")[1].split()[0])
    cross = float(out.split("cross-cluster cosine  =")[1].split()[0])
    assert within - cross > 0.2, (within, cross)
    assert "learned structure!" in out


def test_word2vec_train_example_trains_from_a_file_on_the_ps(tmp_path):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(
        " ".join(rng.choice(words, 20)) for _ in range(200)) + "\n")
    vectors = tmp_path / "vectors.txt"
    out = _run("word2vec_train", "-train_file", str(corpus), "-output",
               str(vectors), "-size", "8", "-use_ps", "1", "-min_count", "1",
               "-block", "512")
    assert "vocab: 40 words" in out
    lines = vectors.read_text().splitlines()
    assert lines[0].split() == ["40", "8"]
    assert len(lines) == 41
    assert all(np.isfinite(np.array(line.split()[1:], float)).all()
               for line in lines[1:])


def test_logreg_train_example_learns_locally_and_on_the_ps():
    out = _run("logreg_train")
    local = float(out.split("local  sigmoid accuracy:")[1].split()[0])
    ps = float(out.split("PS     sigmoid accuracy:")[1].split()[0])
    assert local > 0.9 and ps > 0.9, (local, ps)


def test_word2vec_query_example_answers_bit_identically_over_the_wire():
    out = _run("word2vec_query")
    assert "bit-identical to local" in out
    assert "neighbor drill passed!" in out


def test_addition_rnn_example_learns(port):
    acc = _load("addition_rnn").main(digits=2, hidden=128, n=10000,
                                     epochs=25, batch=128, verbose=False,
                                     device="cpu")
    assert acc > 0.7, f"addition RNN failed to learn: {acc}"


def test_ftrl_ctr_example_learns_sparse_model(port):
    logloss, sparsity = _load("ftrl_ctr").main(verbose=False, device="cpu")
    assert logloss < 0.65, f"FTRL CTR example did not learn: {logloss}"
    assert sparsity > 0.5, f"l1 produced a dense model: {sparsity}"


def test_addition_rnn_from_jax_gives_the_same_logits_and_adam_step():
    import jax
    import jax.numpy as jnp
    import optax

    from examples.addition_rnn import build_model, make_dataset

    hidden = 16
    X, Y = make_dataset(64, 2, np.random.default_rng(0))
    flax_model = build_model(hidden, Y.shape[1])
    params = flax_model.init(jax.random.PRNGKey(0),
                             jnp.asarray(X[:2]))["params"]
    rnn = _load("addition_rnn")
    model = rnn.AdditionRNN(hidden, Y.shape[1])
    model.load_state_dict(convert.addition_rnn_from_jax(params))

    want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(X)))
    with torch.no_grad():
        got = model(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def loss_fn(p):
        logits = flax_model.apply({"params": p}, jnp.asarray(X))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(Y)).mean()

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = opt.update(grads, opt_state)
    stepped = optax.apply_updates(params, updates)

    topt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                            lr=1e-3)
    tloss = rnn.loss_fn(model, torch.from_numpy(X), torch.from_numpy(Y))
    tloss.backward()
    topt.step()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    carried = convert.addition_rnn_from_jax(stepped)
    state = model.state_dict()
    assert set(carried) == set(state)
    for name, value in carried.items():
        # bias_ih is frozen at zero, as flax's input Denses have no bias
        np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
