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

import os

import torch

from multiverso_tpu_torch.ops import kernels

#: Bucket granule: every id batch is a multiple of it. The TPU kernel
#: issued one 64-row DMA group per grid step; the CUDA grid has no such
#: group, but the bucket contract (and so the traces both packages see)
#: stays the same.
ROW_GROUP = 64

_VECTOR = 16  # bytes each kernel thread moves

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
    if table.device.type == "cuda":
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
    current stream; returns the CUDA error code of the launch."""
    suffix = _SCATTER_DTYPES.get(table.dtype)
    if suffix is None:
        raise ValueError(f"{op}: no kernel for dtype {table.dtype}")
    vecs = _kernel_args(op, ids, table, deltas)
    fn = getattr(kernels.load("rows"), f"{entry}_{suffix}")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        return fn(table.data_ptr(), ids.data_ptr(), deltas.data_ptr(),
                  table.shape[0], ids.shape[0], vecs, stream)


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
    fn = kernels.load("rows").mvt_gather_rows
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        code = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                  table.shape[0], ids.shape[0], vecs, stream)
        gather_rows.launches += 1
    _raise_on_error(op, code)
    return out


gather_rows.launches = 0
