#!/usr/bin/env python
"""Topic modeling on parameter-server tables — the lightLDA workload shape
(twin of ``examples/lda_topics.py``).

Multiple workers Gibbs-sample disjoint document shards against ONE shared
word-topic table (candidate-row pulls, count-delta pushes), recovering the
planted topic structure jointly. See ``multiverso_tpu_torch/models/lda.py``
for the design notes.

Run:  python multiverso_tpu_torch/examples/lda_topics.py [device]

``device`` holds the tables and runs the sweeps: ``cuda`` unless ``cpu``
is given.
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.models.lda import (LDAConfig, PSGibbsLDA, purity,
                                             synthetic_corpus)

VOCAB, TOPICS, DOCS, DOC_LEN, WORKERS, SWEEPS = 300, 5, 400, 60, 4, 25
DEVICE = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def main(device=DEVICE):
    docs, labels = synthetic_corpus(VOCAB, TOPICS, DOCS, DOC_LEN, seed=0)
    mvt.init(local_workers=WORKERS, device=device)
    try:
        shard_size = DOCS // WORKERS
        shards = []
        tables = None
        for w in range(WORKERS):
            lda = PSGibbsLDA(LDAConfig(VOCAB, TOPICS, seed=w),
                             docs[w * shard_size:(w + 1) * shard_size],
                             tables=tables)
            tables = (lda.word_topic, lda.topic_counts)
            shards.append(lda)
        errors = []

        def run(slot):
            try:
                with mvt.worker(slot):
                    shards[slot].run(sweeps=SWEEPS)
            except Exception as exc:  # re-raised on the main thread
                errors.append(exc)

        threads = [threading.Thread(target=run, args=(s,))
                   for s in range(WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

        pred = np.concatenate([s.doc_topics() for s in shards])
        score = purity(pred, labels, TOPICS)
        print(f"{WORKERS} workers x {SWEEPS} sweeps over {DOCS} docs: "
              f"doc-topic purity vs planted labels = {score:.3f}")
        return score
    finally:
        mvt.shutdown()


if __name__ == "__main__":
    main()
