"""The port's logistic-regression app and its tables against the JAX
package's.

Models: ``LogReg`` draws its initial weights with numpy from the seed in
both packages and ``PSLogReg`` starts from zeroed tables, so the same
numpy minibatches drive both from equal states. After N minibatches the
weights agree within rtol 1e-5, atol 1e-6 (float32 sums taken in another
order: XLA's fused dot and scatter against torch's), the losses within
rtol 1e-5, and the sparse pushes' element counts exactly. Every PS table
kind is covered: array, sparse (sgd), dense FTRL and sparse FTRL, with
``sync_frequency`` and ``pipeline``.

Tables: the twins of ``tests/test_sparse_table.py`` and
``tests/test_ftrl_table.py`` without the checkpoint and wire cases (not
ported yet); the sparse tables are host numpy in both packages, so they
agree exactly. ``convert`` carries JAX table state across (FTRL ``z``/``n``,
sparse live keys and values, array weights), and both packages continue
from it. Small shapes throughout: the CPU build of torch's ``sqrt`` can be
off on tensors large enough to be split across threads."""

import numpy as np
import pytest

import multiverso_tpu as mv
from multiverso_tpu.models import logreg as jl
from multiverso_tpu.tables import ftrl_table as jftrl
from multiverso_tpu.tables import sparse_table as jsparse

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.models import logreg as tl
from multiverso_tpu_torch.tables import ftrl_table as tftrl
from multiverso_tpu_torch.tables import sparse_table as tsparse

RTOL, ATOL = 1e-5, 1e-6
STEPS = 6          # minibatches per model comparison
BATCH = 32


@pytest.fixture
def both():
    """Both runtimes up (tests/conftest.py stops only the JAX one)."""
    TORCH_FLAGS.reset()
    mv.init()
    try:
        mvt.init(device="cpu")
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def _register(pkg, sparse_mod, ftrl_mod):
    pkg.register_table_type("sparse", sparse_mod.SparseWorker)
    pkg.register_table_type("sparse_ftrl", sparse_mod.make_sparse_ftrl)
    pkg.register_table_type("ftrl", ftrl_mod.FTRLWorker)


def _tables(pkg):
    """(package, its sparse and FTRL table modules), registered."""
    mods = (jsparse, jftrl) if pkg is mv else (tsparse, tftrl)
    _register(pkg, *mods)
    return mods


def _dense_data(rng, n=192, dim=10, classes=2):
    if classes == 2:
        half = n // 2
        x = np.concatenate([rng.normal(-1.0, 1.0, (half, dim)),
                            rng.normal(+1.0, 1.0, (half, dim))]).astype(np.float32)
        y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.int32)
    else:
        centers = rng.normal(0, 3.0, (classes, dim))
        y = rng.integers(0, classes, n).astype(np.int32)
        x = (centers[y] + rng.normal(0, 1.0, (n, dim))).astype(np.float32)
    order = rng.permutation(n)
    return {"x": x[order], "y": y[order]}


def _sparse_data(rng, n=192, nnz=12, input_size=1000, classes=2):
    """Scattered feature ids (some slots masked with -1), labels from a
    hidden linear model."""
    idx = rng.integers(0, input_size, (n, nnz)).astype(np.int32)
    idx[rng.random((n, nnz)) < 0.2] = -1
    val = rng.normal(0, 1, (n, nnz)).astype(np.float32)
    w = rng.normal(0, 1, (classes, input_size))
    scores = np.einsum("bn,cbn->bc", val * (idx >= 0),
                       w[:, np.maximum(idx, 0)])
    y = (scores.argmax(1) if classes > 2 else scores[:, 0] > 0).astype(np.int32)
    return {"idx": idx, "val": val, "y": y}


def _batches(data, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < STEPS:
        out += list(jl.minibatches(data, BATCH, rng))
    return out[:STEPS]


def _close(torch_w, jax_w):
    np.testing.assert_allclose(np.asarray(torch_w), np.asarray(jax_w),
                               rtol=RTOL, atol=ATOL)


LOCAL = {
    "sigmoid": dict(input_size=10),
    "softmax": dict(input_size=10, output_size=3, objective="softmax", lr=0.5),
    "l2": dict(input_size=10, regular="l2", regular_coef=0.5),
    "l1-default-updater": dict(input_size=10, regular="l1", regular_coef=0.01,
                               updater_type="default"),
    "sparse-sigmoid": dict(input_size=1000, sparse=True, max_nnz=12),
    "sparse-softmax": dict(input_size=1000, output_size=3, sparse=True,
                           max_nnz=12, objective="softmax", regular="l2",
                           regular_coef=0.1),
}


@pytest.mark.parametrize("name", list(LOCAL))
def test_local_logreg_matches_jax(name):
    kw = LOCAL[name]
    rng = np.random.default_rng(1)
    classes = max(kw.get("output_size", 1), 2)
    data = (_sparse_data(rng, classes=classes) if kw.get("sparse")
            else _dense_data(rng, classes=classes))
    jm = jl.LogReg(jl.LogRegConfig(seed=3, **kw))
    tm = tl.LogReg(tl.LogRegConfig(seed=3, **kw), device="cpu")
    _close(tm.weights(), jm.weights())  # same numpy init
    for mb in _batches(data):
        np.testing.assert_allclose(tm.update(mb), jm.update(mb), rtol=RTOL)
    _close(tm.weights(), jm.weights())
    np.testing.assert_array_equal(tm.predict(data), jm.predict(data))
    assert tm.test(data) == jm.test(data)


PS = {
    "array": dict(input_size=10, sync_frequency=2),
    "array-pipeline": dict(input_size=10, sync_frequency=2, pipeline=True,
                           regular="l2", regular_coef=0.1),
    "array-softmax": dict(input_size=10, output_size=3, objective="softmax"),
    "sparse": dict(input_size=1000, sparse=True, max_nnz=12, sync_frequency=2),
    "ftrl": dict(input_size=10, objective="ftrl", alpha=0.5, lambda1=0.02,
                 lambda2=0.1),
    "sparse-ftrl-pipeline": dict(input_size=1000, sparse=True, max_nnz=12,
                                 objective="ftrl", alpha=0.5, lambda1=0.02,
                                 lambda2=0.1, sync_frequency=4, pipeline=True),
}


@pytest.mark.parametrize("name", list(PS))
def test_ps_logreg_matches_jax(both, name):
    kw = PS[name]
    rng = np.random.default_rng(2)
    classes = max(kw.get("output_size", 1), 2)
    data = (_sparse_data(rng, classes=classes) if kw.get("sparse")
            else _dense_data(rng, classes=classes))
    jm = jl.make_model(jl.LogRegConfig(use_ps=True, **kw))
    tm = tl.make_model(tl.LogRegConfig(use_ps=True, **kw))
    assert isinstance(tm, tl.PSLogReg)
    for mb in _batches(data):
        np.testing.assert_allclose(tm.update(mb), jm.update(mb), rtol=RTOL)
        _close(tm.weights(), jm.weights())  # the replicas, sync for sync
    jm.finish()
    tm.finish()
    _close(tm.weights(), jm.weights())
    if kw.get("sparse"):
        assert tm.table.elements_pushed == jm.table.elements_pushed
        keys_t, vals_t = tm.table.get()
        keys_j, vals_j = jm.table.get()
        np.testing.assert_array_equal(keys_t, keys_j)
        _close(vals_t, vals_j)


def test_dense_ftrl_pipeline(both):
    """A dense FTRL model with ``pipeline``: the JAX package's FTRL proxy has
    no argument-free ``get_async``, so its model raises at the first sync;
    the port's proxy has one. With the JAX proxy given that form on its
    instance, both agree sync for sync."""
    kw = dict(input_size=10, objective="ftrl", alpha=0.5, lambda1=0.02,
              lambda2=0.1, sync_frequency=2, pipeline=True)
    data = _dense_data(np.random.default_rng(4))
    mbs = _batches(data)
    with pytest.raises(TypeError, match="get_async"):
        broken = jl.make_model(jl.LogRegConfig(use_ps=True, **kw))
        for mb in mbs:
            broken.update(mb)
    jm = jl.make_model(jl.LogRegConfig(use_ps=True, **kw))
    jm.table.get_async = lambda: type(jm.table).__mro__[1].get_async(jm.table, None)
    tm = tl.make_model(tl.LogRegConfig(use_ps=True, **kw))
    for mb in mbs:
        np.testing.assert_allclose(tm.update(mb), jm.update(mb), rtol=RTOL)
        _close(tm.weights(), jm.weights())
    jm.finish()
    tm.finish()
    _close(tm.weights(), jm.weights())


def test_ps_weights_warm_start_and_convert(both):
    """``load_weights`` through the array table, and ``convert`` carrying a
    trained JAX model's weights into the port: both continue equal."""
    rng = np.random.default_rng(4)
    data = _dense_data(rng)
    kw = dict(input_size=10, use_ps=True)
    jm = jl.make_model(jl.LogRegConfig(**kw))
    tm = tl.make_model(tl.LogRegConfig(**kw))
    w0 = rng.normal(0, 0.1, (1, 11)).astype(np.float32)
    jm.load_weights(w0)
    tm.load_weights(w0)
    _close(tm.weights(), jm.weights())
    batches = _batches(data)
    for mb in batches[:3]:
        jm.update(mb)
    jm.finish()
    convert.load_logreg_weights(tm, jm.weights())
    _close(tm.weights(), jm.weights())
    for mb in batches[3:]:
        jm.update(mb)
        tm.update(mb)
    jm.finish()
    tm.finish()
    _close(tm.weights(), jm.weights())
    local = tl.LogReg(tl.LogRegConfig(input_size=10), device="cpu")
    convert.load_logreg_weights(local, jm.weights())
    _close(local.weights(), jm.weights())


def test_convert_ftrl_and_sparse_state(both):
    """JAX FTRL z/n (dense and sparse) and sparse live entries, carried into
    the port; the next Adds agree."""
    rng = np.random.default_rng(5)
    kw = dict(alpha=0.3, beta=1.0, lambda1=0.1, lambda2=0.5)
    made = {}
    for pkg in (mv, mvt):
        _tables(pkg)
        made[pkg] = (pkg.create_table("ftrl", 16, **kw),
                     pkg.create_table("sparse_ftrl", 10_000, width=2, **kw),
                     pkg.create_table("sparse", 10_000, width=2))
    jd, js_ftrl, js = made[mv]
    keys = np.array([3, 77, 9_999], np.int64)
    for _ in range(4):
        jd.add(rng.normal(0, 1, 16).astype(np.float32))
        js_ftrl.add(keys, rng.normal(0, 1, (3, 2)).astype(np.float32))
        js.add(keys, rng.normal(0, 1, (3, 2)).astype(np.float32))
    srv = jd._server_table
    td, ts_ftrl, ts = made[mvt]
    convert.load_ftrl_state(td, np.asarray(srv.z)[:16], np.asarray(srv.n)[:16])
    sf = js_ftrl._server_table
    live = sorted(sf._z)
    convert.load_ftrl_state(ts_ftrl, np.stack([sf._z[k] for k in live]),
                            np.stack([sf._n[k] for k in live]), keys=live)
    convert.load_sparse_state(ts, *js.get())
    _close(td.get(), jd.get())
    np.testing.assert_array_equal(ts_ftrl.get(keys), js_ftrl.get(keys))
    np.testing.assert_array_equal(ts.get(keys), js.get(keys))
    g = rng.normal(0, 1, 16).astype(np.float32)
    gk = rng.normal(0, 1, (3, 2)).astype(np.float32)
    for dense, sparse_ftrl, sparse in (made[mv], made[mvt]):
        dense.add(g)
        sparse_ftrl.add(keys, gk)
        sparse.add(keys, gk)
    _close(td.get(), jd.get())
    for t, j in ((ts_ftrl, js_ftrl), (ts, js)):
        for got, want in zip(t.get(), j.get()):  # live keys, values
            np.testing.assert_array_equal(got, want)


# -- tables (test_sparse_table.py, test_ftrl_table.py) --------------------------

def test_sparse_huge_keyspace_add_get(both):
    out = []
    for pkg in (mv, mvt):
        _tables(pkg)
        t = pkg.create_table("sparse", 1_000_000_000, width=3)
        t.add([5, 999_999_999], np.array([[1, 2, 3], [4, 5, 6]], np.float32))
        got = [t.get([5, 7, 999_999_999])]
        t.add([5], np.array([[1, 1, 1]], np.float32))
        got += [t.get([5]), *t.get(), len(t._server_table._store),
                t.elements_pushed, t.elements_pulled]
        out.append(got)
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(out[1][0], [[1, 2, 3], [0, 0, 0], [4, 5, 6]])
    np.testing.assert_array_equal(out[1][2], [5, 999_999_999])
    assert out[1][4] == 2  # memory in proportion to the live keys


def test_sparse_sgd_updater_sign_and_refusals(both):
    got = []
    for pkg in (mv, mvt):
        _tables(pkg)
        t = pkg.create_table("sparse", 100, width=1, updater_type="sgd")
        t.add([3], np.array([[2.0]], np.float32))
        got.append(t.get([3]))
        with pytest.raises(pkg.log.FatalError):
            t.add([100], np.array([[1.0]], np.float32))
        with pytest.raises(pkg.log.FatalError):
            pkg.create_table("sparse", 10, width=1, updater_type="adagrad")
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1], [[-2.0]])


def test_sparse_ftrl_matches_dense_ftrl(both):
    kw = dict(alpha=0.5, beta=1.0, lambda1=0.02, lambda2=0.1)
    keys = np.array([0, 2, 3], np.int64)
    out = {}
    for pkg in (mv, mvt):
        _tables(pkg)
        dense = pkg.create_table("ftrl", 4, **kw)
        sparse = pkg.create_table("sparse_ftrl", 1_000_000, width=1, **kw)
        rng = np.random.default_rng(0)
        for _ in range(5):
            g = rng.normal(0, 1, 3).astype(np.float32)
            gd = np.zeros(4, np.float32)
            gd[keys] = g
            dense.add(gd)
            sparse.add(keys * 1000, g.reshape(-1, 1))
        out[pkg] = (dense.get(), sparse.get(keys * 1000), sparse.get([999]))
    wd, ws, zero = out[mvt]
    np.testing.assert_allclose(ws.reshape(-1), wd[keys], rtol=RTOL)
    np.testing.assert_array_equal(zero, [[0.0]])
    _close(wd, out[mv][0])
    np.testing.assert_array_equal(ws, out[mv][1])


def test_ftrl_weights_closed_form():
    import torch
    z = np.array([0.5, -0.5, 2.0, -2.0], np.float32)
    n = np.ones(4, np.float32)
    kw = dict(alpha=0.5, beta=1.0, lambda1=1.0, lambda2=1.0)
    w = tftrl.ftrl_weights(torch.from_numpy(z), torch.from_numpy(n), **kw).numpy()
    np.testing.assert_array_equal(w[:2], [0.0, 0.0])
    assert w[2] < 0 < w[3]
    _close(w, np.asarray(jftrl.ftrl_weights(z, n, **kw)))


def _numpy_ftrl(grads, alpha, beta, l1, l2):
    """Dense FTRL-proximal reference (McMahan et al., per-coordinate)."""
    z = np.zeros_like(grads[0])
    n = np.zeros_like(grads[0])
    for g in grads:
        w = -np.sign(z) * np.maximum(np.abs(z) - l1, 0.0) / (
            (beta + np.sqrt(n)) / alpha + l2)
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / alpha
        z = z + g - sigma * w
        n = n + g * g
    return -np.sign(z) * np.maximum(np.abs(z) - l1, 0.0) / (
        (beta + np.sqrt(n)) / alpha + l2)


def test_ftrl_server_matches_numpy_and_jax(both):
    kw = dict(alpha=0.3, beta=1.0, lambda1=0.1, lambda2=0.5)
    rng = np.random.default_rng(5)
    grads = [rng.normal(0, 1, 16).astype(np.float32) for _ in range(20)]
    got = []
    for pkg in (mv, mvt):
        _tables(pkg)
        table = pkg.create_table("ftrl", 16, **kw)
        for g in grads:
            table.add(g)
        got.append(table.get())
    want = _numpy_ftrl(grads, kw["alpha"], kw["beta"], kw["lambda1"],
                       kw["lambda2"])
    np.testing.assert_allclose(got[1], want, rtol=1e-4, atol=1e-6)
    _close(got[1], got[0])


def test_ps_sparse_push_is_o_nnz_and_learns(both):
    """test_sparse_table.py's learning scenario on the port, the push
    count checked exactly."""
    rng = np.random.default_rng(0)
    half, dim = 300, 10
    x = np.concatenate([rng.normal(-1, 1, (half, dim)),
                        rng.normal(1, 1, (half, dim))]).astype(np.float32)
    y = np.repeat(np.array([0, 1], np.int32), half)
    order = rng.permutation(2 * half)
    feat_ids = np.arange(dim, dtype=np.int32) * 97 + 13
    data = {"idx": np.tile(feat_ids, (2 * half, 1))[order], "val": x[order],
            "y": y[order]}
    model = tl.make_model(tl.LogRegConfig(
        input_size=1000, sparse=True, max_nnz=10, use_ps=True,
        sync_frequency=2, lr=0.1))
    n_updates = 0
    for _ in range(3):
        for mb in tl.minibatches(data, 128, rng):
            model.update(mb)
            n_updates += 1
    model.finish()
    assert model.test(data) > 0.95
    assert model.table.elements_pushed == n_updates * 11  # 10 features + bias


def test_parse_and_load_libsvm(tmp_path):
    lines = ["1 0:0.5 3:1.5", "0 1:2.0", "1 7 9:-1e-3 11:4"]
    for line in lines:
        for max_nnz in (2, 4):
            got, want = (tl.parse_libsvm_line(line, max_nnz),
                         jl.parse_libsvm_line(line, max_nnz))
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
    path = tmp_path / "data.svm"
    path.write_text("\n".join(lines[:2]) + "\n\n")
    data = tl.load_libsvm(str(path), max_nnz=4)
    want = jl.load_libsvm(str(path), max_nnz=4)
    for k in ("y", "idx", "val"):
        assert data[k].dtype == want[k].dtype
        np.testing.assert_array_equal(data[k], want[k])
    np.testing.assert_array_equal(
        tl.load_libsvm("file://" + str(path), max_nnz=4)["idx"], want["idx"])
    with pytest.raises(mvt.log.FatalError):
        tl.load_libsvm("mem://data.svm")


def test_local_model_needs_the_card_unless_cpu_is_asked_for():
    """Whether a card is present is decided here, when the test runs."""
    import torch
    if torch.cuda.is_available():
        assert tl.LogReg(tl.LogRegConfig(input_size=4)).w.device.type == "cuda"
    else:
        with pytest.raises(mvt.log.FatalError, match="CUDA"):
            tl.LogReg(tl.LogRegConfig(input_size=4))
    with pytest.raises(mvt.log.FatalError):
        tl.LogReg(tl.LogRegConfig(input_size=4, objective="ftrl"), device="cpu")
