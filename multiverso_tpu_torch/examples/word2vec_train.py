#!/usr/bin/env python
"""Train word2vec end-to-end on a synthetic clustered corpus and show that
embeddings of co-occurring words cluster (twin of
``examples/word2vec_train.py``).

The corpus interleaves sentences drawn entirely from even-id words with
sentences drawn from odd-id words — training should pull each parity class
together and push the classes apart.

Run:  python multiverso_tpu_torch/examples/word2vec_train.py [device]
      python multiverso_tpu_torch/examples/word2vec_train.py [device] \
          -train_file corpus.txt -output vectors.txt -size 128 -window 5 \
          -negative 5 -epoch 3 [-cbow 1] [-hs 1] [-binary 1] \
          [-use_adagrad 1] [-use_ps 1] [-min_count 5] [-sample 1e-3] \
          [-alpha 0.025] [-block 8192]

``device`` holds the embeddings (or the PS tables): ``cuda`` unless
``cpu`` is given. The flag surface mirrors the reference binary's argv
parser (Applications/WordEmbedding/src/util.h:20-44); output is the
word2vec interchange format readable by gensim et al.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.models.vocab import Dictionary, iter_token_blocks
from multiverso_tpu_torch.models.word2vec import (DeviceTrainer, PSTrainer,
                                                  Word2VecConfig,
                                                  save_embeddings)


def split_device(argv):
    """``(device, rest)``: a leading ``cpu`` / ``cuda[:i]`` names the
    device (``cuda`` when absent)."""
    if argv and (argv[0] == "cpu" or argv[0].startswith("cuda")):
        return argv[0], list(argv[1:])
    return "cuda", list(argv)


def run_from_args(argv, device="cuda"):
    """Reference driver shape: -key value argv → corpus training → saved
    embeddings."""
    opts = {"size": 128, "window": 5, "negative": 5, "epoch": 1,
            "min_count": 5, "sample": 1e-3, "alpha": 0.025, "block": 8192,
            "cbow": 0, "hs": 0, "binary": 0, "use_adagrad": 0, "use_ps": 0,
            "train_file": "", "output": "vectors.txt"}
    it = iter(argv)
    for key in it:
        name = key.lstrip("-")
        if name not in opts:
            raise SystemExit(f"unknown option {key}; have {sorted(opts)}")
        raw = next(it, None)
        if raw is None:
            raise SystemExit(f"option {key} needs a value")
        default = opts[name]
        opts[name] = type(default)(raw) if not isinstance(default, str) else raw
    if not opts["train_file"]:
        raise SystemExit("-train_file is required")
    if opts["use_adagrad"] and not opts["use_ps"]:
        raise SystemExit("-use_adagrad 1 requires -use_ps 1: AdaGrad runs "
                         "server-side on the parameter-server tables "
                         "(communicator.cpp:17-32); the device trainer "
                         "uses plain SGD with the linear lr decay")

    d = Dictionary.from_text_file(opts["train_file"],
                                  min_count=opts["min_count"])
    if len(d) == 0:
        raise SystemExit(f"no words survive -min_count {opts['min_count']}; "
                         "nothing to train")
    print(f"vocab: {len(d)} words")
    config = Word2VecConfig(
        vocab_size=len(d), dim=opts["size"], window=opts["window"],
        negatives=opts["negative"], lr=opts["alpha"], sample=opts["sample"],
        mode="cbow" if opts["cbow"] else "sg",
        objective="hs" if opts["hs"] else "ns",
        batch_pairs=8192, block_tokens=opts["block"])
    # Stream the corpus per epoch like the reference's file re-reads — no
    # materialized token list; the decay total is known from the vocab.
    blocks = lambda: iter_token_blocks(opts["train_file"], d, opts["block"])
    total_words = int(d.counts.sum()) * opts["epoch"]
    if opts["use_ps"]:
        mvt.init(device=device)
        try:
            trainer = PSTrainer(config, d,
                                use_adagrad=bool(opts["use_adagrad"]))
            trainer.train(blocks, epochs=opts["epoch"],
                          total_words=total_words)
            emb = trainer.embeddings()
        finally:
            mvt.shutdown()
    else:
        trainer = DeviceTrainer(config, d, device=device)
        trainer.train(blocks, epochs=opts["epoch"], total_words=total_words)
        emb = trainer.embeddings()
    save_embeddings(d, emb, opts["output"], binary=bool(opts["binary"]))
    print(f"embeddings -> {opts['output']}")


VOCAB, DIM, EPOCHS = 100, 32, 10


def synthetic_corpus(rng, sentences=4000, length=20):
    """Each sentence uses only even or only odd word ids."""
    out = []
    half = VOCAB // 2
    for _ in range(sentences):
        parity = rng.integers(0, 2)
        out.append(parity + 2 * rng.integers(0, half, size=length))
    return np.concatenate(out).astype(np.int32)


def main(device="cuda"):
    rng = np.random.default_rng(0)
    corpus = synthetic_corpus(rng)
    counts = np.bincount(corpus, minlength=VOCAB).astype(np.int64)

    d = Dictionary()
    d.words = [f"w{i}" for i in range(VOCAB)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum(counts, 1)

    config = Word2VecConfig(vocab_size=VOCAB, dim=DIM, window=2, negatives=4,
                            lr=0.3, sample=0.0, block_tokens=2048)
    trainer = DeviceTrainer(config, d, device=device)
    blocks = [corpus[i:i + 2048] for i in range(0, len(corpus), 2048)]
    trainer.train(blocks, epochs=EPOCHS, log_every_s=5.0)

    emb = trainer.embeddings()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sim = emb @ emb.T
    even, odd = np.arange(0, VOCAB, 2), np.arange(1, VOCAB, 2)
    within = (sim[np.ix_(even, even)].mean() + sim[np.ix_(odd, odd)].mean()) / 2
    cross = sim[np.ix_(even, odd)].mean()
    print(f"within-cluster cosine = {within:.3f}")
    print(f"cross-cluster cosine  = {cross:.3f}")
    print("learned structure!" if within - cross > 0.2 else
          "no separation — increase EPOCHS")
    return within, cross


if __name__ == "__main__":
    device, rest = split_device(sys.argv[1:])
    if rest:
        run_from_args(rest, device)
    else:
        main(device)
