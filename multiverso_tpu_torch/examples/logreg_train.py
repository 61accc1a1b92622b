#!/usr/bin/env python
"""Logistic regression, local and PS-mode (twin of
``examples/logreg_train.py``: the reference's
``Applications/LogisticRegression`` driver shape).

Run:  python multiverso_tpu_torch/examples/logreg_train.py [device]
      python multiverso_tpu_torch/examples/logreg_train.py [device] train.conf

``device`` holds the model (or the PS tables): ``cuda`` unless ``cpu`` is
given. Config-file mode mirrors the reference binary
(``logistic_regression config_file``): the file names input/output sizes,
reader type (default/weight/bsparse), train/test files (';'-separated
URIs — mvfs:// works), objective, regularizer, PS knobs. See
multiverso_tpu_torch/models/lr_io.py for the field list.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.models.logreg import (LogReg, LogRegConfig,
                                                PSLogReg, make_model)
from multiverso_tpu_torch.models.lr_io import Configure, make_reader


def split_device(argv):
    """``(device, rest)``: a leading ``cpu`` / ``cuda[:i]`` names the
    device (``cuda`` when absent)."""
    if argv and (argv[0] == "cpu" or argv[0].startswith("cuda")):
        return argv[0], list(argv[1:])
    return "cuda", list(argv)


def run_from_config(path: str, device: str = "cuda") -> None:
    """The reference driver: everything from the config file
    (Applications/LogisticRegression/src/logreg.cpp:40-88)."""
    conf = Configure(path)
    model_config = conf.model_config()
    if conf.use_ps:
        mvt.init(device=device)
    model = make_model(model_config, device=device)
    if conf.init_model_file:
        model.load_weights(np.load(conf.init_model_file))

    reader = make_reader(conf.reader_type, conf.train_file,
                         conf.minibatch_size, conf.input_size,
                         sparse=conf.sparse, max_nnz=conf.max_nnz)
    seen = 0
    for batch in reader.epochs(conf.train_epoch):
        loss = model.update(batch)
        seen += len(batch["y"])
        if conf.show_time_per_sample and seen % conf.show_time_per_sample < conf.minibatch_size:
            print(f"samples {seen}: loss {loss:.4f}")
    reader.close()
    if isinstance(model, PSLogReg):
        model.finish()

    if conf.test_file:
        test_reader = make_reader(conf.reader_type, conf.test_file,
                                  conf.minibatch_size, conf.input_size,
                                  sparse=conf.sparse, max_nnz=conf.max_nnz)
        correct = total = 0
        with open(conf.output_file, "w") as out:
            for batch in test_reader.batches():
                pred = model.predict(batch)
                out.writelines(f"{p}\n" for p in pred)
                correct += int((pred == batch["y"].reshape(-1)).sum())
                total += len(pred)
        test_reader.close()
        print(f"test accuracy: {correct / max(total, 1):.3f} -> {conf.output_file}")

    if conf.output_model_file:
        np.save(conf.output_model_file, model.weights())
        print(f"model -> {conf.output_model_file}.npy")
    if conf.use_ps:
        mvt.shutdown()


def run_demo(device: str = "cuda"):
    rng = np.random.default_rng(0)
    true_w = rng.normal(size=30).astype(np.float32)

    def make_data(n=2048, d=30):
        X = rng.normal(size=(n, d)).astype(np.float32)
        return X, (X @ true_w > 0).astype(np.int32)

    X, y = make_data()
    Xte, yte = make_data(n=512)

    # local mode (reference `Model`)
    config = LogRegConfig(input_size=30, objective="sigmoid", lr=0.1,
                          regular="l2", regular_coef=1e-4)
    model = LogReg(config, device=device)
    for epoch in range(30):
        for i in range(0, len(X), 256):
            model.update({"x": X[i:i + 256], "y": y[i:i + 256]})
    local_acc = model.test({'x': Xte, 'y': yte})
    print(f"local  sigmoid accuracy: {local_acc:.3f}")

    # PS mode with sync-frequency pipeline (reference `PSModel`)
    mvt.init(device=device)
    try:
        ps_config = LogRegConfig(input_size=30, objective="sigmoid", lr=0.1,
                                 use_ps=True, sync_frequency=4, pipeline=True)
        ps_model = PSLogReg(ps_config)
        for epoch in range(30):
            for i in range(0, len(X), 256):
                ps_model.update({"x": X[i:i + 256], "y": y[i:i + 256]})
        ps_model.finish()
        ps_acc = ps_model.test({'x': Xte, 'y': yte})
        print(f"PS     sigmoid accuracy: {ps_acc:.3f}")
    finally:
        mvt.shutdown()
    return local_acc, ps_acc


if __name__ == "__main__":
    device, rest = split_device(sys.argv[1:])
    if rest:
        run_from_config(rest[0], device)
    else:
        run_demo(device)
