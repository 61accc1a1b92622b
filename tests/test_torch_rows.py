"""Row kernels of the torch port against the JAX package's Pallas kernels.

The port's ``scatter_add_rows`` / ``gather_rows`` run their plain PyTorch
versions on CPU tensors; the JAX side runs the Pallas kernels in interpret
mode, as ``test_pallas_rows.py`` does. Scatter with unique live ids is one
fp32 add per element, so the two must agree exactly. The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the dispatch
that reaches them is checked to raise rather than fall back."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiverso_tpu.ops import pallas_rows
from multiverso_tpu_torch.ops import kernels
from multiverso_tpu_torch.ops import rows


# Every case shares one shape (a 1024 x 16 table, 4 row groups of ids), so
# the interpret-mode Pallas kernel compiles once per function.
ROWS, COLS, BATCH = 1024, 16, 4 * rows.ROW_GROUP
SENTINEL = ROWS - 1


def _scatter_case(kind, rng):
    """(table, ids, deltas) for the scatter cases of test_pallas_rows.py."""
    table = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    deltas = rng.normal(size=(BATCH, COLS)).astype(np.float32)
    if kind == "unique":
        ids = rng.choice(SENTINEL, BATCH, replace=False).astype(np.int32)
    else:
        # pad slots aim at the sentinel row with zero deltas
        live = 2 if kind == "sentinel" else BATCH - 37
        ids = np.full(BATCH, SENTINEL, np.int32)
        ids[:live] = rng.choice(SENTINEL, live, replace=False)
        deltas[live:] = 0.0
    return table, ids, deltas


def test_row_group_matches_reference():
    assert rows.ROW_GROUP == pallas_rows.ROW_GROUP


@pytest.mark.parametrize("kind", ["unique", "sentinel", "mostly_live"])
def test_scatter_add_matches_pallas(kind):
    table, ids, deltas = _scatter_case(kind, np.random.default_rng(7))
    want = np.asarray(pallas_rows.scatter_add_rows(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)))
    t = torch.from_numpy(table.copy())
    out = rows.scatter_add_rows(t, torch.from_numpy(ids), torch.from_numpy(deltas))
    assert out is t  # in place: the port's form of a donated buffer
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("kind", ["unique", "repeated", "sentinel"])
def test_gather_matches_pallas(kind):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    if kind == "unique":
        ids = rng.choice(ROWS, BATCH, replace=False).astype(np.int32)
    elif kind == "repeated":  # reads may repeat rows freely
        ids = np.full(BATCH, 3, np.int32)
    else:
        ids = np.full(BATCH, SENTINEL, np.int32)
        ids[:100] = rng.integers(0, SENTINEL, 100)
    want = np.asarray(pallas_rows.gather_rows(jnp.asarray(table), jnp.asarray(ids)))
    got = rows.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["scatter", "gather"])
def test_rejects_batch_not_multiple_of_group(op):
    n = rows.ROW_GROUP + 1
    t_args = [torch.zeros((128, 16)), torch.zeros(n, dtype=torch.int32)]
    j_args = [jnp.zeros((128, 16)), jnp.zeros(n, jnp.int32)]
    if op == "scatter":
        t_args.append(torch.zeros((n, 16)))
        j_args.append(jnp.zeros((n, 16)))
        fns = (rows.scatter_add_rows, pallas_rows.scatter_add_rows)
    else:
        fns = (rows.gather_rows, pallas_rows.gather_rows)
    for fn, args in zip(fns, (t_args, j_args)):
        with pytest.raises(ValueError, match="not a multiple"):
            fn(*args)


def _refuse_build(name):
    raise RuntimeError("nvcc not found")


@pytest.mark.parametrize("case", ["no_toolchain", "bad_dtype", "other_device"])
def test_card_path_raises_instead_of_falling_back(case, monkeypatch):
    """A tensor the CPU path does not own must reach the kernel or raise:
    never the plain version. There is no card here, so the dispatch is
    pointed at the card path for CPU tensors."""
    dtype = torch.bfloat16 if case == "bad_dtype" else torch.float32
    device = "meta" if case == "other_device" else "cpu"
    table = torch.zeros((128, 16), dtype=dtype, device=device)
    ids = torch.zeros(rows.ROW_GROUP, dtype=torch.int32, device=device)
    deltas = torch.ones((rows.ROW_GROUP, 16), dtype=dtype, device=device)
    if case != "other_device":
        monkeypatch.setattr(rows, "_on_card", lambda op, *t: True)
    monkeypatch.setattr(kernels, "load", _refuse_build)
    plain = []
    monkeypatch.setattr(rows, "scatter_add_rows_plain",
                        lambda *a: plain.append(a))
    monkeypatch.setattr(rows, "gather_rows_plain", lambda *a: plain.append(a))
    before = rows.scatter_add_rows.launches, rows.gather_rows.launches
    with pytest.raises((RuntimeError, ValueError)):
        rows.scatter_add_rows(table, ids, deltas)
    with pytest.raises((RuntimeError, ValueError)):
        rows.gather_rows(table, ids)
    assert plain == []
    assert (rows.scatter_add_rows.launches, rows.gather_rows.launches) == before
    if device == "cpu":
        assert not table.any()


# -- the coalesced scatter ------------------------------------------------------

def _coalesced_case():
    """The input of test_pallas_rows.py::test_coalesced_scatter_matches_simple
    (seed 7): a contiguous head, a scattered tail and sentinel pads."""
    rng = np.random.default_rng(7)
    n_rows, cols = 4096, 128
    batch = 2 * rows.ROW_GROUP
    table = rng.normal(size=(n_rows, cols)).astype(np.float32)
    live = np.unique(np.concatenate(
        [np.arange(40), rng.choice(np.arange(64, n_rows - 1), 60,
                                   replace=False)]))
    pads = np.full(batch - len(live), n_rows - 1, np.int32)
    ids = np.concatenate([np.sort(live).astype(np.int32), pads])
    deltas = rng.normal(size=(batch, cols)).astype(np.float32)
    deltas[len(live):] = 0.0
    return table, ids, deltas


def test_seg_matches_reference():
    assert (rows.SEG, rows.COALESCE) == (pallas_rows.SEG, pallas_rows.COALESCE)


@pytest.mark.parametrize("pattern", ["pallas_case", "runs", "random", "sentinel_end"])
def test_seg_flags_match_pallas(pattern):
    rng = np.random.default_rng(3)
    if pattern == "pallas_case":
        ids = _coalesced_case()[1]
    elif pattern == "runs":
        ids = np.arange(100, 100 + BATCH, dtype=np.int32)
    elif pattern == "random":
        ids = rng.choice(SENTINEL, BATCH, replace=False).astype(np.int32)
    else:  # a run that ends on the sentinel row, then pads
        ids = np.full(BATCH, SENTINEL, np.int32)
        ids[:7] = np.arange(SENTINEL - 6, SENTINEL + 1)
    want = np.asarray(pallas_rows._seg_flags(jnp.asarray(ids)))
    got = rows.seg_flags(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_coalesced_scatter_matches_pallas():
    """The port's coalesced path on the CPU (its plain version) against the
    JAX interpret kernel and the simple scatter: bitwise equal."""
    table, ids, deltas = _coalesced_case()
    assert int(rows.seg_flags(torch.from_numpy(ids)).sum()) > 0
    want = np.asarray(pallas_rows._scatter_add_coalesced_call(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas), True))
    t = torch.from_numpy(table.copy())
    out = rows.scatter_add_rows_coalesced(t, torch.from_numpy(ids),
                                          torch.from_numpy(deltas))
    assert out is t
    np.testing.assert_array_equal(out.numpy(), want)
    simple = rows.scatter_add_rows(torch.from_numpy(table.copy()),
                                   torch.from_numpy(ids), torch.from_numpy(deltas))
    np.testing.assert_array_equal(out.numpy(), simple.numpy())


def test_coalesce_flag_routes_scatter(monkeypatch):
    """rows.COALESCE is read at every call: set, scatter_add_rows goes to
    the coalesced scatter; the ROW_GROUP % SEG guard refuses a group that
    does not split into segments."""
    table, ids, deltas = _coalesced_case()
    calls = []
    plain = rows.scatter_add_rows_coalesced_plain
    monkeypatch.setattr(rows, "scatter_add_rows_coalesced_plain",
                        lambda *a: calls.append(1) or plain(*a))
    args = (torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(deltas))
    rows.scatter_add_rows(*args)
    assert calls == []
    monkeypatch.setattr(rows, "COALESCE", True)
    rows.scatter_add_rows(*args)
    assert calls == [1]
    monkeypatch.setattr(rows, "ROW_GROUP", 66)
    with pytest.raises(ValueError, match="ROW_GROUP"):
        rows.scatter_add_rows(*args)


def test_coalesced_card_path_raises_instead_of_falling_back(monkeypatch):
    table = torch.zeros((128, 16))
    ids = torch.zeros(rows.ROW_GROUP, dtype=torch.int32)
    deltas = torch.ones((rows.ROW_GROUP, 16))
    monkeypatch.setattr(rows, "_on_card", lambda op, *t: True)
    monkeypatch.setattr(kernels, "load", _refuse_build)
    plain = []
    monkeypatch.setattr(rows, "scatter_add_rows_coalesced_plain",
                        lambda *a: plain.append(a))
    before = rows.scatter_add_rows_coalesced.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        rows.scatter_add_rows_coalesced(table, ids, deltas)
    assert plain == [] and rows.scatter_add_rows_coalesced.launches == before
    assert not table.any()
