"""Row scatter-add and row gather on device-resident tables (port of
``multiverso_tpu/ops/pallas_rows.py``).

Each function has three parts, side by side:

* the wrapper (:func:`scatter_add_rows`, :func:`scatter_add_rows_coalesced`,
  :func:`gather_rows`): checks its inputs, then dispatches on the device
  the tensors lie on. On a CUDA device it launches the hand-written kernel
  of ``csrc/rows.cu`` or raises; on the CPU it runs the plain version.
  There is no fallback from the card to the plain version and no switch
  that routes it there.
* the plain PyTorch version (:func:`scatter_add_rows_plain`,
  :func:`scatter_add_rows_coalesced_plain`, :func:`gather_rows_plain`):
  ``index_add_`` / ``index_select``. The CPU tests use it and
  ``chip_smoke.py`` holds the kernels against it.
* a launch counter, ``<wrapper>.launches``: one per kernel launch, and
  nowhere else — so a run can show that its main path went through the
  kernel.

Kernel notes (which TPU function each replaces, what bounds it, what its
design does about that) are at the top of ``csrc/rows.cu``.

Contracts, as in the JAX package (enforced by ``MatrixServer``):

* ids are int32 in ``[0, table_rows)``; pad slots point at the table's
  sentinel row (never a live row) with zero deltas;
* for the scatters the live ids are unique within a call (duplicates
  pre-combined on the host); pad slots may repeat the sentinel;
* the batch is a multiple of ``ROW_GROUP`` (bucket sizes are powers of
  two >= it).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from multiverso_tpu_torch.ops import kernels

#: Bucket granule: every id batch is a multiple of it. The TPU kernel
#: issued one 64-row DMA group per grid step; the CUDA grid has no such
#: group, but the bucket contract (and so the traces both packages see)
#: stays the same.
ROW_GROUP = 64

_VECTOR = 16  # bytes each kernel thread moves

# -- launch geometry of the gather and the scatter ------------------------------
# A block is (block_x lanes across a row) x (block_y slots); the grid walks
# the batch block_y slots at a time, and a lane walks its row block_x
# vectors at a time (``csrc/rows.cu``).

#: Most threads a block may have (``kMaxThreads`` in ``csrc/rows.cu``).
MAX_THREADS = 256
#: Most slots a block takes in one pass.
MAX_SLOTS = 32
#: The grid is capped at this many blocks an SM; larger batches walk.
WAVES = 16
#: Index math in the kernels is 32-bit: batch x vectors a row stays below.
MAX_PAIRS = 1 << 31
#: (threads a block aims at, most lanes across a row) of the gather and of
#: the scatter's two paths, from the card's sweeps (``PERF.md`` §6): one
#: lane a vector, but for the scatter through the SM, whose lanes keep up
#: to four row and delta loads each in flight (``kInFlight``).
GATHER_BLOCK = (256, 32)
SCATTER_BLOCK_L2 = (128, 32)
SCATTER_BLOCK_SM = (256, 8)
#: The scatter adds in L2 (atomic reductions) up to this many (slot,
#: vector) pairs, and through the SM above it, where L2's atomics fall
#: behind a read-modify-write (``csrc/rows.cu``; the card's crossover is
#: between 2^18 and 2^19 pairs).
IN_L2_MAX_PAIRS = 1 << 18


class Geometry(NamedTuple):
    grid: int
    block_x: int
    block_y: int


@functools.lru_cache(maxsize=256)
def launch_geometry(batch: int, vecs: int, sm_count: int, threads: int,
                    lanes: int) -> Geometry:
    """The launch for ``batch`` slots of ``vecs`` 16-byte vectors on a card
    of ``sm_count`` SMs. A row takes up to ``lanes`` lanes; a block takes
    as many slots as fit ``threads``, fewer while that leaves an SM
    without a block; the grid stops at ``WAVES`` blocks an SM and walks
    the rest. No work is a grid of 0 blocks, which the kernels' entry
    points do not launch."""
    if batch < 0 or vecs < 0 or sm_count <= 0:
        raise ValueError(f"launch_geometry: batch {batch}, vecs {vecs}, "
                         f"sm_count {sm_count}")
    if batch * vecs == 0:
        return Geometry(0, 1, 1)
    if batch * vecs >= MAX_PAIRS:
        raise ValueError(f"launch_geometry: batch {batch} x {vecs} vectors a "
                         f"row is not below 2^31 (32-bit kernel indices)")
    block_x = min(vecs, lanes, threads, MAX_THREADS)
    block_y = max(1, min(MAX_SLOTS, threads // block_x, MAX_THREADS // block_x))
    while block_y > 1 and -(-batch // block_y) < sm_count:
        block_y -= 1
    grid = min(-(-batch // block_y), sm_count * WAVES)
    return Geometry(grid, block_x, block_y)


def scatter_launch(batch: int, vecs: int, sm_count: int):
    """(geometry, in_l2): whether the scatter adds by atomic reductions in
    L2 (latency-bound batches) or through the SM (bytes-bound ones), and
    the launch for that path."""
    in_l2 = batch * vecs <= IN_L2_MAX_PAIRS
    block = SCATTER_BLOCK_L2 if in_l2 else SCATTER_BLOCK_SM
    return launch_geometry(batch, vecs, sm_count, *block), in_l2


_sm_counts: dict = {}


def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, read once."""
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


_entries: dict = {}


def _entry(name: str):
    """The ctypes function ``name`` of ``csrc/rows.cu``, resolved once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(kernels.load("rows"), name)
    return fn


def _launch(fn, index: int, *args) -> int:
    """Call ``fn(*args, stream)`` with the current stream of CUDA device
    ``index``, from that device (entered only when it is not the current
    one); returns the CUDA error code of the launch."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


_SCATTER_DTYPES = {
    torch.float32: "f32",
    torch.float64: "f64",
    torch.float16: "f16",
    torch.int32: "i32",
    torch.int64: "i64",
}


def _check(op: str, table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"{op}: table must be 2-D, got shape {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"{op}: ids must be a 1-D int32 tensor, got "
                         f"{ids.dtype} of shape {tuple(ids.shape)}")
    if ids.shape[0] % ROW_GROUP:
        raise ValueError(
            f"{op}: batch {ids.shape[0]} not a multiple of {ROW_GROUP}")
    if ids.device != table.device:
        raise ValueError(f"{op}: ids on {ids.device}, table on {table.device}")


def _on_card(op: str, table: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    if table.is_cuda:
        return True
    if table.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {table.device}")


def _kernel_args(op: str, ids: torch.Tensor, *row_tensors: torch.Tensor) -> int:
    """Layout checks the kernels rely on: contiguous tensors, and rows that
    are whole, 16-byte aligned vectors. Returns vectors per row."""
    row_bytes = row_tensors[0].shape[1] * row_tensors[0].element_size()
    if row_bytes % _VECTOR:
        raise ValueError(f"{op}: a row of {row_bytes} B is not a whole number "
                         f"of {_VECTOR}-byte vectors (pad the columns)")
    if not ids.is_contiguous():
        raise ValueError(f"{op}: ids must be contiguous")
    for t in row_tensors:
        if not t.is_contiguous() or t.data_ptr() % _VECTOR:
            raise ValueError(f"{op}: row tensors must be contiguous and "
                             f"{_VECTOR}-byte aligned")
    return row_bytes // _VECTOR


def _raise_on_error(op: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {code}")


# -- scatter-add -------------------------------------------------------------

def scatter_add_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table[ids[i]] += deltas[i]`` in place."""
    return table.index_add_(0, ids, deltas)


def _check_scatter(op: str, table: torch.Tensor, ids: torch.Tensor,
                   deltas: torch.Tensor) -> None:
    _check(op, table, ids)
    if deltas.shape != (ids.shape[0], table.shape[1]) or deltas.dtype != table.dtype:
        raise ValueError(f"{op}: deltas {deltas.dtype}{tuple(deltas.shape)} do "
                         f"not match ids ({ids.shape[0]},) and table "
                         f"{table.dtype}{tuple(table.shape)}")
    if deltas.device != table.device:
        raise ValueError(f"{op}: deltas on {deltas.device}, table on {table.device}")


def _launch_scatter(op: str, entry: str, table: torch.Tensor,
                    ids: torch.Tensor, deltas: torch.Tensor) -> int:
    """Launch ``<entry>_<dtype>`` of ``csrc/rows.cu`` on the table's
    current stream (the simple scatter with its launch geometry); returns
    the CUDA error code of the launch."""
    suffix = _SCATTER_DTYPES.get(table.dtype)
    if suffix is None:
        raise ValueError(f"{op}: no kernel for dtype {table.dtype}")
    vecs = _kernel_args(op, ids, table, deltas)
    fn = _entry(f"{entry}_{suffix}")
    index, batch = table.get_device(), ids.shape[0]
    args = (table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), table.shape[0],
            batch, vecs)
    if entry == "mvt_scatter_add_rows":
        geometry, in_l2 = scatter_launch(batch, vecs, _sm_count(index))
        args += (*geometry, in_l2)
    return _launch(fn, index, *args)


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """In place ``table[ids[i], :] += deltas[i, :]`` for unique live ids;
    returns ``table`` itself (the port's form of the JAX package's donated
    buffer). With :data:`COALESCE` set (read at every call) the call goes
    to :func:`scatter_add_rows_coalesced`, as ``MVTPU_COALESCE=1`` does in
    the JAX package."""
    op = "scatter_add_rows"
    if COALESCE:
        if ROW_GROUP % SEG:
            # batches would not split into whole segments
            raise ValueError(f"MVTPU_COALESCE needs ROW_GROUP % {SEG} == 0, "
                             f"got {ROW_GROUP}")
        return scatter_add_rows_coalesced(table, ids, deltas)
    _check_scatter(op, table, ids, deltas)
    if not _on_card(op, table):
        return scatter_add_rows_plain(table, ids, deltas)
    code = _launch_scatter(op, "mvt_scatter_add_rows", table, ids, deltas)
    scatter_add_rows.launches += 1
    _raise_on_error(op, code)
    return table


scatter_add_rows.launches = 0


# -- coalesced scatter-add ------------------------------------------------------
# Sorted unique ids (word2vec's pushes) hold runs of consecutive rows. The
# batch splits into SEG-slot segments; a segment whose ids are consecutive
# is one contiguous span of the table and moves as such (``csrc/rows.cu``).
# Same result as scatter_add_rows, bit for bit. Off unless
# ``MVTPU_COALESCE=1``: it becomes a default only once the card shows a
# gain (``ROADMAP.md``).

SEG = 4  # slots per coalescible segment

COALESCE = os.environ.get("MVTPU_COALESCE", "0") == "1"


def seg_flags(ids: torch.Tensor) -> torch.Tensor:
    """``(batch // SEG,)`` int32: 1 where a segment's ids are consecutive.
    The kernel computes the same flag from each segment's ids itself; this
    is for tests and reports."""
    segs = ids.reshape(-1, SEG)
    return (torch.diff(segs, dim=1) == 1).all(dim=1).to(torch.int32)


#: Plain PyTorch version: the simple scatter's ``index_add_`` (the two
#: kernels compute the same function).
scatter_add_rows_coalesced_plain = scatter_add_rows_plain


def scatter_add_rows_coalesced(table: torch.Tensor, ids: torch.Tensor,
                               deltas: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_add_rows` through the segment-coalescing kernel: in
    place, unique live ids, returns ``table``."""
    op = "scatter_add_rows_coalesced"
    _check_scatter(op, table, ids, deltas)
    if not _on_card(op, table):
        return scatter_add_rows_coalesced_plain(table, ids, deltas)
    code = _launch_scatter(op, "mvt_scatter_add_rows_coalesced", table, ids,
                           deltas)
    scatter_add_rows_coalesced.launches += 1
    _raise_on_error(op, code)
    return table


scatter_add_rows_coalesced.launches = 0


# -- gather ------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table[ids]`` as a new tensor."""
    return table.index_select(0, ids)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` into a new ``(len(ids), cols)`` tensor. Repeated ids
    are allowed."""
    op = "gather_rows"
    _check(op, table, ids)
    if not _on_card(op, table):
        return gather_rows_plain(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    vecs = _kernel_args(op, ids, table, out)
    fn = _entry("mvt_gather_rows")
    index, batch = table.get_device(), ids.shape[0]
    geometry = launch_geometry(batch, vecs, _sm_count(index), *GATHER_BLOCK)
    code = _launch(fn, index, table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                   table.shape[0], batch, vecs, *geometry)
    gather_rows.launches += 1
    _raise_on_error(op, code)
    return out


gather_rows.launches = 0
