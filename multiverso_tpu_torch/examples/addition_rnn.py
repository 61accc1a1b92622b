#!/usr/bin/env python
"""Sequence-to-sequence addition RNN synced through the parameter server
(twin of ``examples/addition_rnn.py``, the analog of the reference's keras
example ``binding/python/examples/theano/keras/addition_rnn.py``): learn to
map the character string "123+58" to "181" with an LSTM encoder/decoder,
and keep the model's parameters in ONE shared ArrayTable via
``PytreeParamManager`` + ``MVCallback`` (sync every ``freq`` batches,
barrier at epoch end — the keras-callback contract).

The model is a ``torch.nn.LSTM`` encoder-decoder where the JAX example has
flax's ``nn.RNN(nn.LSTMCell)``, and the optimizer is worker-local
``torch.optim.Adam`` where it has optax's; only the parameter delta
crosses the table. ``convert.addition_rnn_from_jax`` carries a flax
model's parameters into :class:`AdditionRNN`'s ``state_dict``.

Run:  python multiverso_tpu_torch/examples/addition_rnn.py [device]

``device`` holds the table and the model: ``cuda`` unless ``cpu`` is
given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch

CHARS = "0123456789+ "
C2I = {c: i for i, c in enumerate(CHARS)}
DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def make_dataset(n, digits, rng):
    """Encoded question/answer pairs, keras-example style: DISTINCT
    questions only, padded to ``2*digits+1`` chars and REVERSED (the
    published trick — it shortens the dependency span the LSTM must
    bridge), answers padded to ``digits+1``. ``n`` is capped at the number
    of possible questions. The same numpy draws as the JAX example."""
    q_len, a_len = 2 * digits + 1, digits + 1
    space = 10 ** digits
    n = min(n, space * space)
    flat = rng.choice(space * space, size=n, replace=False)
    X = np.zeros((n, q_len), np.int32)
    Y = np.zeros((n, a_len), np.int32)
    for i, f in enumerate(flat):
        x, y = int(f) // space, int(f) % space
        q = f"{x}+{y}".ljust(q_len)[::-1]
        ans = str(x + y).ljust(a_len)
        X[i] = [C2I[c] for c in q]
        Y[i] = [C2I[c] for c in ans]
    return X, Y


class AdditionRNN(torch.nn.Module):
    """Embedding -> LSTM encoder (last step) -> repeated -> LSTM decoder ->
    dense, the layout of the JAX example's flax module. flax's
    ``LSTMCell`` has one bias per gate (its recurrent Denses'), so the
    LSTMs' input-side biases stay zero and out of training."""

    def __init__(self, hidden: int, out_len: int) -> None:
        super().__init__()
        self.out_len = int(out_len)
        self.embed = torch.nn.Embedding(len(CHARS), hidden)
        self.encoder = torch.nn.LSTM(hidden, hidden, batch_first=True)
        self.decoder = torch.nn.LSTM(hidden, hidden, batch_first=True)
        self.dense = torch.nn.Linear(hidden, len(CHARS))
        for lstm in (self.encoder, self.decoder):
            with torch.no_grad():
                lstm.bias_ih_l0.zero_()
            lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.encoder(self.embed(x.long()))[0][:, -1]      # (B, H)
        dec_in = enc[:, None].expand(-1, self.out_len, -1)       # (B, T, H)
        return self.dense(self.decoder(dec_in)[0])               # (B, T, V)


def loss_fn(model, xb, yb):
    logits = model(xb)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), yb.long().reshape(-1))


def main(digits=2, hidden=128, n=20000, epochs=20, batch=128, lr=1e-3,
         sync_freq=4, seed=0, verbose=True, device=DEVICE):
    import multiverso_tpu_torch as mvt
    from multiverso_tpu_torch.ext import MVCallback, PytreeParamManager

    rng = np.random.default_rng(seed)
    X, Y = make_dataset(n, digits, rng)
    # size the split from the ACTUAL dataset (make_dataset caps n at the
    # number of distinct questions)
    n_val = max(len(X) // 10, 1)

    mvt.init([], device=device)
    try:
        dev = mvt.Zoo.instance().device
        Xv, Yv = (torch.from_numpy(a).to(dev) for a in (X[:n_val], Y[:n_val]))
        Xt, Yt = (torch.from_numpy(a).to(dev) for a in (X[n_val:], Y[n_val:]))
        torch.manual_seed(seed)
        model = AdditionRNN(hidden, Y.shape[1]).to(dev)
        params = {k: v for k, v in model.named_parameters()
                  if v.requires_grad}
        pm = PytreeParamManager({k: v.detach() for k, v in params.items()})
        callback = MVCallback(pm, freq=sync_freq)

        def load(tree):
            with torch.no_grad():
                for k, v in tree.items():
                    if v.data_ptr() != params[k].data_ptr():
                        params[k].copy_(v)

        load(pm.params)
        opt = torch.optim.Adam(params.values(), lr=lr)
        order = np.arange(len(Xt))
        loss = float("nan")  # stays nan if the split is under one batch
        acc = 0.0            # defined even for epochs=0
        for epoch in range(epochs):
            rng.shuffle(order)
            for i in range(0, len(Xt) - batch + 1, batch):
                idx = torch.from_numpy(order[i:i + batch]).to(dev)
                opt.zero_grad()
                loss_t = loss_fn(model, Xt[idx], Yt[idx])
                loss_t.backward()
                opt.step()
                loss = float(loss_t.detach())
                pm.params = {k: v.detach() for k, v in params.items()}
                callback.on_batch_end()   # delta-sync through the table
                load(pm.params)
            callback.on_epoch_end()       # sync + barrier (keras contract)
            load(pm.params)
            with torch.no_grad():
                pred = model(Xv).argmax(-1)
            acc = float((pred == Yv.long()).all(dim=1).float().mean())
            if verbose:
                print(f"epoch {epoch + 1}: loss={loss:.4f} "
                      f"val seq-acc={acc:.3f}")
        return acc
    finally:
        mvt.shutdown()


if __name__ == "__main__":
    main()
