"""The port's logistic-regression config files and readers
(``multiverso_tpu_torch.models.lr_io``) against the JAX package's.

The scenarios of ``tests/test_lr_io.py`` apart from the ``mvfs://`` reader
(it comes with the wire) and the native libsvm parser (with the native
library). Every reader scenario runs both packages' readers over the same
files, and their batches are exactly equal (values, dtypes, shapes);
``Configure`` yields the same fields and an equal model configuration.
The model scenarios (``updater_type``, lr decay, warm start) run on the
port with ``device="cpu"``; the end-to-end config-file training runs in
both packages and their weights agree within rtol 1e-5, atol 1e-6."""

import dataclasses

import numpy as np
import pytest

import multiverso_tpu as mv
from multiverso_tpu.config import FLAGS as JAX_FLAGS
from multiverso_tpu.models import logreg as jl
from multiverso_tpu.models import lr_io as jio

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import logreg as tl
from multiverso_tpu_torch.models import lr_io as tio

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def port_flags():
    TORCH_FLAGS.reset()
    try:
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def _write(path, text):
    path.write_text(text)
    return str(path)


def _collect(it):
    """Batches are live double-buffer views; copy when accumulating."""
    return [{k: v.copy() for k, v in b.items()} for b in it]


def _read_both(factory, *args, epochs=1, **kwargs):
    """Every batch of ``epochs`` epochs from each package's reader, held
    exactly equal; returns the port's batches."""
    out = []
    for mod in (tio, jio):
        reader = getattr(mod, factory)(*args, **kwargs)
        try:
            out.append(_collect(reader.epochs(epochs)))
        finally:
            reader.close()
    got, want = out
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    return got


# -- Configure ----------------------------------------------------------------

def test_configure_fields_and_defaults(tmp_path):
    f = _write(tmp_path / "lr.conf", """
# training config
input_size=100
output_size = 3
sparse=true
objective_type=softmax
regular_type=L2
learning_rate=0.25
minibatch_size=32
train_file=a.data;b.data
reader_type=weight
use_ps=true
sync_frequency=4
""")
    conf, jconf = tio.Configure(f), jio.Configure(f)
    assert vars(conf) == vars(jconf)
    assert conf.input_size == 100 and conf.output_size == 3
    assert conf.sparse is True and conf.reader_type == "weight"
    assert conf.train_file == "a.data;b.data"
    assert conf.train_epoch == 1          # default kept
    assert conf.alpha == 0.005            # FTRL default kept
    mc = conf.model_config()
    assert isinstance(mc, tl.LogRegConfig)
    assert dataclasses.asdict(mc) == dataclasses.asdict(jconf.model_config())
    assert mc.objective == "softmax" and mc.regular == "l2"
    assert mc.lr == 0.25 and mc.minibatch == 32
    assert mc.use_ps and mc.sync_frequency == 4


def test_configure_rejects_unknown_key_and_missing_input_size(tmp_path):
    bad = _write(tmp_path / "bad.conf", "input_size=5\nbogus_key=1\n")
    with pytest.raises(mvt.log.FatalError):
        tio.Configure(bad)
    empty = _write(tmp_path / "empty.conf", "output_size=2\n")
    with pytest.raises(mvt.log.FatalError):
        tio.Configure(empty)
    # mvfs:// is a served scheme now: an unreachable server is a bad
    # stream, fatal at the first read, as in the JAX package
    with pytest.raises(mvt.log.FatalError, match="bad stream"):
        tio.Configure("mvfs://127.0.0.1:1/lr.conf")


# -- readers ------------------------------------------------------------------

def test_sample_reader_dense_epochs(tmp_path):
    f = _write(tmp_path / "dense.data",
               "".join(f"{i % 2} {i}.0 {i + 1}.0 {i + 2}.0\n"
                       for i in range(10)))
    batches = _read_both("SampleReader", f, minibatch=4, input_size=3)
    assert [len(b["y"]) for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(batches[0]["y"], [0, 1, 0, 1])
    np.testing.assert_array_equal(batches[0]["x"][1], [1.0, 2.0, 3.0])
    # second epoch after reset sees the same data
    reader = tio.SampleReader(f, minibatch=4, input_size=3)
    first = _collect(reader.batches())
    reader.reset()
    again = _collect(reader.batches())
    reader.close()
    assert sum(len(b["y"]) for b in again) == 10
    np.testing.assert_array_equal(again[0]["x"], first[0]["x"])


def test_reset_before_end_of_epoch_is_fatal(tmp_path):
    f = _write(tmp_path / "d.data", "1 1.0\n0 2.0\n1 3.0\n")
    reader = tio.SampleReader(f, minibatch=1, input_size=1)
    try:
        next(reader.batches())
        with pytest.raises(mvt.log.FatalError, match="end of epoch"):
            reader.reset()
    finally:
        reader.close()


def test_sample_reader_sparse_and_multifile(tmp_path):
    fa = _write(tmp_path / "a.data", "1 0:1.5 3:2.5\n0 2:1.0\n")
    fb = _write(tmp_path / "b.data", "1 1:4.0\n")
    batches = _read_both("SampleReader", f"{fa};file://{fb}", minibatch=2,
                         input_size=5, sparse=True, max_nnz=3)
    assert sum(len(b["y"]) for b in batches) == 3
    np.testing.assert_array_equal(batches[0]["idx"][0], [0, 3, -1])
    np.testing.assert_array_equal(batches[0]["val"][0], [1.5, 2.5, 0.0])


def test_sample_reader_epochs_iterator(tmp_path):
    f = _write(tmp_path / "d.data", "1 1.0\n0 2.0\n1 3.0\n")
    batches = _read_both("SampleReader", f, minibatch=2, input_size=1,
                         epochs=3)
    assert sum(len(b["y"]) for b in batches) == 9


def test_weighted_reader_scales_values(tmp_path):
    f = _write(tmp_path / "w.data", "1:2.0 0:3.0\n0:0.5 1:4.0\n")
    (batch,) = _read_both("WeightedSampleReader", f, minibatch=2,
                          input_size=4, sparse=True, max_nnz=2)
    np.testing.assert_array_equal(batch["y"], [1, 0])
    np.testing.assert_array_equal(batch["val"][0], [6.0, 0.0])   # 3.0 * 2.0
    np.testing.assert_array_equal(batch["val"][1], [2.0, 0.0])   # 4.0 * 0.5
    # dense weighted: x scaled
    fd = _write(tmp_path / "wd.data", "1:2.0 3.0 4.0\n")
    (db,) = _read_both("WeightedSampleReader", fd, minibatch=1, input_size=2)
    np.testing.assert_array_equal(db["x"][0], [6.0, 8.0])


def test_bsparse_reader_roundtrip(tmp_path):
    path, jpath = str(tmp_path / "train.bsparse"), str(tmp_path / "j.bsparse")
    labels = [1, 0, 2]
    keys = [[0, 7, 9], [3], [1, 2]]
    weights = [2.0, 1.0, 0.5]
    tio.write_bsparse(path, labels, keys, weights)
    jio.write_bsparse(jpath, labels, keys, weights)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    batches = _read_both("BSparseSampleReader", path, minibatch=2,
                         input_size=10, max_nnz=4)
    assert [len(b["y"]) for b in batches] == [2, 1]
    np.testing.assert_array_equal(batches[0]["y"], [1, 0])
    np.testing.assert_array_equal(batches[0]["idx"][0], [0, 7, 9, -1])
    np.testing.assert_array_equal(batches[0]["val"][0], [2.0, 2.0, 2.0, 0.0])
    np.testing.assert_array_equal(batches[1]["idx"][0], [1, 2, -1, -1])
    np.testing.assert_array_equal(batches[1]["val"][0], [0.5, 0.5, 0.0, 0.0])


def test_bsparse_trailing_bytes_surface(tmp_path):
    path = tmp_path / "torn.bsparse"
    tio.write_bsparse(str(path), [1], [[4, 5]])
    path.write_bytes(path.read_bytes() + b"\x01\x02")
    reader = tio.BSparseSampleReader(str(path), minibatch=2, input_size=8)
    try:
        with pytest.raises(RuntimeError, match="AsyncBuffer fill failed"):
            list(reader.batches())
    finally:
        reader.close()


def test_make_reader_factory(tmp_path):
    f = _write(tmp_path / "x.data", "1 1.0\n")
    readers = [tio.make_reader("default", f, 1, 1),
               tio.make_reader("weight", f, 1, 1),
               tio.make_reader("bsparse", f, 1, 1, sparse=True)]
    assert [type(r) for r in readers] == [
        tio.SampleReader, tio.WeightedSampleReader, tio.BSparseSampleReader]
    for r in readers:
        r.close()
    with pytest.raises(mvt.log.FatalError):
        tio.make_reader("nope", f, 1, 1)


def test_reader_reads_omp_threads_flag(tmp_path):
    f = _write(tmp_path / "x.data", "1 1.0\n")
    reader = tio.SampleReader(f, minibatch=1, input_size=1)
    assert reader._pool._max_workers == 4 == JAX_FLAGS.get("omp_threads")
    reader.close()
    mvt.set_flag("omp_threads", 2)
    reader = tio.SampleReader(f, minibatch=1, input_size=1)
    assert reader._pool._max_workers == 2
    reader.close()


def test_close_joins_the_prefetch_thread(tmp_path):
    f = _write(tmp_path / "x.data", "".join(f"{i % 2} {i}.0\n" for i in range(9)))
    reader = tio.SampleReader(f, minibatch=2, input_size=1)
    next(reader.batches())  # mid-epoch: the prefetcher holds the next fill
    thread = reader._buffer._thread
    reader.close()  # stops the prefetcher and joins it
    thread.join(timeout=30)  # a loaded machine may outlast close's own wait
    assert not thread.is_alive()


def test_reader_surfaces_parse_errors(tmp_path):
    """A malformed line raises at get(), it does not hang the prefetcher."""
    f = _write(tmp_path / "bad.data", "1 1.0\nnot-a-number x\n")
    reader = tio.SampleReader(f, minibatch=4, input_size=1)
    with pytest.raises(RuntimeError, match="AsyncBuffer fill failed"):
        for _ in reader.batches():
            pass
    reader.close()


def test_libsvm_reads_streams_and_empty_files(tmp_path):
    empty = tmp_path / "empty.libsvm"
    empty.write_text("\n  \n")
    got = tl.load_libsvm("file://" + str(empty), max_nnz=4)
    want = jl.load_libsvm(str(empty), max_nnz=4)
    for key in ("y", "idx", "val"):
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape == (0,) + want[key].shape[1:]


# -- end to end ---------------------------------------------------------------

def test_config_file_training_converges(tmp_path):
    """The reference driver shape: config file -> reader -> model, in both
    packages; linearly separable sparse data trains to high accuracy and
    the port's weights follow the JAX package's."""
    rng = np.random.default_rng(1)
    lines = []
    for _ in range(400):
        k = rng.choice(20, size=3, replace=False)
        label = int(k.min() < 10)
        lines.append(f"{label} " + " ".join(f"{i}:1.0" for i in sorted(k)))
    data = _write(tmp_path / "train.data", "\n".join(lines) + "\n")
    conf_file = _write(tmp_path / "lr.conf", f"""
input_size=20
output_size=1
sparse=true
max_nnz=4
train_epoch=40
minibatch_size=50
learning_rate=0.5
train_file={data}
""")
    weights = []
    for mod, lib, kwargs in ((tio, tl, {"device": "cpu"}), (jio, jl, {})):
        conf = mod.Configure(conf_file)
        model = lib.LogReg(conf.model_config(), **kwargs)
        reader = mod.make_reader(conf.reader_type, conf.train_file,
                                 conf.minibatch_size, conf.input_size,
                                 sparse=conf.sparse, max_nnz=conf.max_nnz)
        for batch in reader.epochs(conf.train_epoch):
            model.update(batch)
        reader.close()
        eval_reader = mod.make_reader(conf.reader_type, conf.train_file,
                                      conf.minibatch_size, conf.input_size,
                                      sparse=conf.sparse, max_nnz=conf.max_nnz)
        acc = np.mean([model.test(b) for b in eval_reader.batches()])
        eval_reader.close()
        assert acc > 0.95, acc
        weights.append(np.asarray(model.weights()))
    np.testing.assert_allclose(weights[0], weights[1], rtol=RTOL, atol=ATOL)


# -- updater_type / lr decay / warm start -------------------------------------

def test_updater_type_default_subtracts_raw_gradient():
    """reference updater.cpp:12-37: 'default' subtracts the raw gradient,
    learning_rate unused."""
    base = dict(input_size=4, objective="sigmoid", seed=3)
    m_def = tl.LogReg(tl.LogRegConfig(updater_type="default", lr=123.0, **base),
                      device="cpu")
    m_sgd1 = tl.LogReg(tl.LogRegConfig(updater_type="sgd", lr=1.0, **base),
                       device="cpu")
    batch = {"x": np.ones((2, 4), np.float32), "y": np.array([1, 0], np.int32)}
    m_def.update(batch)
    m_sgd1.update(batch)
    np.testing.assert_allclose(m_def.weights(), m_sgd1.weights(), rtol=1e-6)


def test_sgd_lr_decays_like_reference():
    """lr_t = max(1e-3, lr0 - t/(lr_coef*minibatch)), as in the JAX package."""
    config = tl.LogRegConfig(input_size=2, lr=0.5, lr_coef=1.0, minibatch=10)
    jconfig = jl.LogRegConfig(input_size=2, lr=0.5, lr_coef=1.0, minibatch=10)
    for t, override in ((0, None), (2, None), (10_000, None), (5, 0.7)):
        assert tl._effective_lr(config, t, override) == \
            jl._effective_lr(jconfig, t, override)
    assert tl._effective_lr(config, 2, None) == pytest.approx(0.5 - 2 / 10)
    assert tl._effective_lr(config, 10_000, None) == 1e-3   # floor


def test_small_lr_not_raised_by_decay_floor():
    config = tl.LogRegConfig(input_size=2, lr=5e-4)
    assert tl._effective_lr(config, 0, None) == 5e-4


def test_updater_type_validation():
    with pytest.raises(mvt.log.FatalError):
        tl.LogReg(tl.LogRegConfig(input_size=2, updater_type="adagrad"),
                  device="cpu")
    with pytest.raises(mvt.log.FatalError):
        tl.LogReg(tl.LogRegConfig(input_size=2, updater_type="ftrl"),
                  device="cpu")


def test_bad_objective_and_regular_values_fatal(tmp_path):
    """Unknown VALUES fail as loudly as unknown keys."""
    f = _write(tmp_path / "typo.conf",
               "input_size=4\nobjective_type=sofmax\n")
    with pytest.raises(mvt.log.FatalError):
        tl.LogReg(tio.Configure(f).model_config(), device="cpu")
    with pytest.raises(mvt.log.FatalError):
        tl.LogReg(tl.LogRegConfig(input_size=4, regular="l3"), device="cpu")


def test_init_model_file_warm_start(tmp_path):
    """Configure's init_model_file warm-starts local AND PS models; the PS
    path pushes the weights through the table."""
    w = np.arange(6, dtype=np.float32).reshape(1, 6) / 10
    model_file = str(tmp_path / "warm.npy")
    np.save(model_file, w)

    local = tl.LogReg(tl.LogRegConfig(input_size=5), device="cpu")
    local.load_weights(np.load(model_file))
    np.testing.assert_array_equal(local.weights(), w)

    mvt.init(device="cpu")
    ps = tl.PSLogReg(tl.LogRegConfig(input_size=5, use_ps=True))
    ps.load_weights(np.load(model_file))
    np.testing.assert_allclose(ps.weights(), w, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(ps.table.get()).reshape(1, 6), w, atol=1e-6)
