"""Launch geometry and C interface of the row gather and row scatter
(``multiverso_tpu_torch/csrc/rows.cu``), checked on the host.

The kernels run only on the card (``chip_smoke.py``); what decides which
thread touches which (slot, vector) pair is computed in Python by
``rows.launch_geometry``, so it is checked here by replaying the kernels'
loops: a block is (block_x lanes across a row) x (block_y slots), the grid
walks the batch block_y slots at a time, and each lane walks its row
block_x vectors at a time."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import kernels
from multiverso_tpu_torch.ops import rows

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
BUCKETS = [64 << k for k in range(11)]          # 64 .. 65536
# a row (243 KB) wider than the 227 KB of shared memory an H100 block can
# have: the kernels keep no row in shared memory, a lane walks it
WIDE = 15_552
VECS = [1, 2, 3, 13, 14, 26, 32, 64, WIDE]
BLOCKS = {"gather": rows.GATHER_BLOCK, "scatter_l2": rows.SCATTER_BLOCK_L2,
          "scatter_sm": rows.SCATTER_BLOCK_SM}


def slot_counts(g, batch):
    """How often each slot is visited: thread (b, y) takes slots
    b * block_y + y, then steps of grid * block_y (the kernel's outer loop)."""
    step = g.grid * g.block_y
    first = np.arange(g.grid)[:, None] * g.block_y + np.arange(g.block_y)[None, :]
    slots = first.reshape(-1, 1) + step * np.arange(-(-batch // step) + 1)[None, :]
    return np.bincount(slots[slots < batch], minlength=batch)


def vector_counts(g, vecs):
    """How often each vector of a row is visited: lane x takes x, then
    steps of block_x (the kernels' inner loop; the scatter's path through
    the SM issues four of those steps' loads before their stores)."""
    v = (np.arange(g.block_x)[:, None]
         + g.block_x * np.arange(-(-vecs // g.block_x) + 1)[None, :]).ravel()
    return np.bincount(v[v < vecs], minlength=vecs)


@pytest.mark.parametrize("kernel", BLOCKS)
@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("vecs", VECS)
@pytest.mark.parametrize("batch", BUCKETS)
def test_geometry_covers_every_pair_once(batch, vecs, sm_count, kernel):
    g = rows.launch_geometry(batch, vecs, sm_count, *BLOCKS[kernel])
    # (slot, vector) is visited (visits of the slot) x (visits of the
    # vector) times: the slot loop and the vector loop are independent
    assert (slot_counts(g, batch) == 1).all()
    assert (vector_counts(g, vecs) == 1).all()
    assert 1 <= g.grid < 2 ** 31
    assert 1 <= g.block_y <= rows.MAX_SLOTS
    assert 1 <= g.block_x <= vecs
    assert g.block_x * g.block_y <= rows.MAX_THREADS
    assert g.grid >= min(batch, sm_count)  # no SM left without a block


@pytest.mark.parametrize("kernel", BLOCKS)
def test_geometry_fills_the_card_at_the_ps_shape(kernel):
    """1024 ids of 52 fp32 (13 vectors) on 132 SMs: a block for every SM;
    the word2vec buckets walk a grid bounded by WAVES blocks an SM."""
    g = rows.launch_geometry(1024, 13, 132, *BLOCKS[kernel])
    assert g.grid >= 132 and g.grid * g.block_y >= 1024
    g = rows.launch_geometry(65536, 32, 132, *BLOCKS[kernel])
    assert g.grid == min(-(-65536 // g.block_y), 132 * rows.WAVES)


def test_scatter_adds_in_l2_at_the_ps_shape_only():
    g, in_l2 = rows.scatter_launch(1024, 13, 132)      # the PS Add
    assert in_l2 and g == rows.launch_geometry(1024, 13, 132, *rows.SCATTER_BLOCK_L2)
    g, in_l2 = rows.scatter_launch(65536, 32, 132)     # the word2vec push
    assert not in_l2 and g == rows.launch_geometry(65536, 32, 132, *rows.SCATTER_BLOCK_SM)


@pytest.mark.parametrize("batch, vecs", [(65536, 32768), (1 << 31, 1), (64, 1 << 25)])
def test_geometry_rejects_pairs_past_32_bits(batch, vecs):
    with pytest.raises(ValueError, match="2\\^31"):
        rows.launch_geometry(batch, vecs, 132, *rows.GATHER_BLOCK)
    assert rows.launch_geometry(batch // 2, vecs, 132, *rows.GATHER_BLOCK).grid >= 1


def test_geometry_of_no_work_launches_nothing():
    assert rows.launch_geometry(0, 13, 132, *rows.GATHER_BLOCK).grid == 0
    assert rows.launch_geometry(64, 0, 132, *rows.SCATTER_BLOCK_SM).grid == 0


def _c_entry_points():
    """``extern "C"`` entry point -> argument C types, with the entry
    macros of rows.cu expanded."""
    src = (CSRC / "rows.cu").read_text().replace("\\\n", " ")
    entries = {}
    macros = re.findall(r'#define (\w+)\(suffix, type\)\s+extern "C" int (\w+)##suffix\(([^)]*)\)',
                        src)
    for macro, prefix, params in macros:
        for suffix in re.findall(rf"^{macro}\((\w+), [\w ]+\)$", src, re.M):
            entries[prefix + suffix] = params
    for name, params in re.findall(r'^extern "C" int (\w+)\(([^)]*)\)', src, re.M):
        entries[name] = params
    return {name: [" ".join(p.split()[:-1]) for p in params.split(",")]
            for name, params in entries.items()}


C_TYPES = {"void*": kernels.ctypes.c_void_p, "const void*": kernels.ctypes.c_void_p,
           "int64_t": kernels.ctypes.c_int64}


def test_signatures_match_the_c_entry_points():
    entries = _c_entry_points()
    assert set(entries) == set(kernels.SIGNATURES["rows"])
    for name, params in entries.items():
        assert [C_TYPES[p] for p in params] == list(kernels.SIGNATURES["rows"][name]), name
    # the gather and the simple scatter take their launch geometry, the
    # scatter its in_l2 choice
    assert entries["mvt_gather_rows"][6:9] == ["int64_t"] * 3
    assert entries["mvt_scatter_add_rows_f64"][6:10] == ["int64_t"] * 4
    assert len(entries["mvt_scatter_add_rows_coalesced_f32"]) == 7


def test_wrapper_passes_the_geometry_and_resolves_each_entry_once(monkeypatch):
    """The card path, pointed at CPU tensors: the C function is looked up
    once, and called with the table's sizes and launch_geometry's grid."""
    calls, loads = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    def load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(rows, "_entries", {})
    monkeypatch.setattr(rows, "_on_card", lambda op, *t: True)
    monkeypatch.setattr(rows, "_sm_count", lambda index: 132)
    monkeypatch.setattr(rows, "_launch", lambda fn, index, *args: fn(*args))
    monkeypatch.setattr(kernels, "load", load)
    table = torch.zeros((1000, 52))
    ids = torch.zeros(1024, dtype=torch.int32)
    deltas = torch.zeros((1024, 52))
    before = rows.scatter_add_rows.launches, rows.gather_rows.launches
    for _ in range(2):
        rows.scatter_add_rows(table, ids, deltas)
        rows.gather_rows(table, ids)
    assert loads == ["rows", "rows"]  # one lookup per entry point
    assert [c[0] for c in calls] == ["mvt_scatter_add_rows_f32", "mvt_gather_rows"] * 2
    scatter, in_l2 = rows.scatter_launch(1024, 13, 132)
    gather = rows.launch_geometry(1024, 13, 132, *rows.GATHER_BLOCK)
    assert calls[0][1][3:] == (1000, 1024, 13, *scatter, in_l2)
    assert calls[1][1][3:] == (1000, 1024, 13, *gather)
    assert [(n, a[3:]) for n, a in calls[2:]] == [(n, a[3:]) for n, a in calls[:2]]
    assert (rows.scatter_add_rows.launches, rows.gather_rows.launches) == (
        before[0] + 2, before[1] + 2)
