#!/usr/bin/env python
"""Word2vec neighbor drill: serve trained embeddings from a PS table and
retrieve nearest neighbors with the server-side top-k query plane (twin of
``examples/word2vec_query.py``).

The training half is word2vec_train.py's synthetic parity corpus (even-id
words co-occur only with even, odd only with odd). The serving half is
what this example demonstrates: the embedding matrix lives in a
parameter-server table, and neighbor lookup is ONE ``mvt.query`` round
trip — the table server scores every row and returns just ``(ids,
scores)`` — instead of pulling the whole matrix to the client and
scoring there (the pushdown contract).

The drill asserts two properties:

* retrieval quality — a trained word's cosine neighbors share its
  parity class (the corpus's planted structure);
* serving correctness — the answer over the wire (a remote client's
  ``Request_Query``) is bit-identical to the in-process answer.

Run:  python multiverso_tpu_torch/examples/word2vec_query.py [device]

``device`` trains the embeddings and holds the table: ``cuda`` unless
``cpu`` is given.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.models.vocab import Dictionary
from multiverso_tpu_torch.models.word2vec import DeviceTrainer, Word2VecConfig

VOCAB, DIM, EPOCHS, TOPK = 60, 16, 6, 5
DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def synthetic_corpus(rng, sentences=2000, length=20):
    """Each sentence uses only even or only odd word ids."""
    half = VOCAB // 2
    out = []
    for _ in range(sentences):
        parity = rng.integers(0, 2)
        out.append(parity + 2 * rng.integers(0, half, size=length))
    return np.concatenate(out).astype(np.int32)


def train_embeddings(device):
    rng = np.random.default_rng(0)
    corpus = synthetic_corpus(rng)
    d = Dictionary()
    d.words = [f"w{i}" for i in range(VOCAB)]
    d.word2id = {w: i for i, w in enumerate(d.words)}
    d.counts = np.maximum(np.bincount(corpus, minlength=VOCAB), 1)
    config = Word2VecConfig(vocab_size=VOCAB, dim=DIM, window=2,
                            negatives=4, lr=0.3, sample=0.0,
                            block_tokens=2048)
    trainer = DeviceTrainer(config, d, device=device)
    blocks = [corpus[i:i + 2048] for i in range(0, len(corpus), 2048)]
    trainer.train(blocks, epochs=EPOCHS, log_every_s=10.0)
    return trainer.embeddings().astype(np.float32)


def main(device=DEVICE):
    emb = train_embeddings(device)

    mvt.init(remote_workers=1, device=device)  # one slot for the wire check
    try:
        table = mvt.create_table("matrix", num_row=VOCAB, num_col=DIM)
        table.add(emb)

        # in-process answer: one pushdown round trip per query batch
        probes = np.arange(0, VOCAB, 7, dtype=np.int64)
        # k+1 because each probe's own row scores highest (cosine 1.0)
        ids, scores = mvt.query(table, emb[probes], TOPK + 1,
                                metric="cosine")

        # retrieval quality: neighbors share the probe's parity class
        same = 0
        total = 0
        for row, probe in enumerate(probes):
            neighbors = [i for i in ids[row].tolist() if i != int(probe)]
            neighbors = neighbors[:TOPK]
            same += sum(1 for n in neighbors if n % 2 == probe % 2)
            total += len(neighbors)
        frac = same / max(total, 1)
        print(f"parity-consistent neighbors: {same}/{total} "
              f"({100.0 * frac:.0f}%)")

        # serving correctness: the wire path returns the identical answer
        endpoint = mvt.serve()
        client = mvt.remote_connect(endpoint)
        try:
            remote_ids, remote_scores = mvt.query(
                client.table(table.table_id), emb[probes], TOPK + 1,
                metric="cosine")
        finally:
            client.close()
        assert np.array_equal(ids, remote_ids), "wire ids != local ids"
        assert np.array_equal(scores, remote_scores), \
            "wire scores != local scores"
        print(f"remote query over {endpoint}: bit-identical to local")

        if frac <= 0.6:
            raise SystemExit("neighbors are not parity-clustered — "
                             "increase EPOCHS")
        print("neighbor drill passed!")
        return frac
    finally:
        mvt.shutdown()


if __name__ == "__main__":
    main()
