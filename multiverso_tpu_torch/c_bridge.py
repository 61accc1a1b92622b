"""Python side of the C API bridge (port of ``multiverso_tpu/c_bridge.py``;
reference: ``src/c_api.cpp`` marshalling).

Called by the embedded interpreter inside the port's
``libmultiverso_tpu.so`` (``native/c_api.cpp``). The C shim passes raw
host pointers wrapped as memoryviews; this module views them as numpy
arrays (zero-copy) and drives the port's table API, whose tables sit on
the runtime's device (``cuda`` unless ``-device=cpu`` is passed to
``MV_Init``). Replies are copied into the caller's buffer on the host; an
Add's payload is copied before the call returns, so an async Add never
reads a buffer the caller has reused. Handles are small ints so they pack
into the reference's ``void*`` TableHandler.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

import multiverso_tpu_torch as mvt

_tables: Dict[int, object] = {}
_next_handle = [1]
_lock = threading.Lock()


def _register(table) -> int:
    with _lock:
        handle = _next_handle[0]
        _next_handle[0] += 1
        _tables[handle] = table
        return handle


def _f32(view, size) -> np.ndarray:
    return np.frombuffer(view, dtype=np.float32, count=size)


def _i32(view, count) -> np.ndarray:
    return np.frombuffer(view, dtype=np.int32, count=count)


def _host(value) -> np.ndarray:
    """A reply as a host array (a tensor on the card or the CPU, or numpy)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


# -- lifecycle ---------------------------------------------------------------

def init(argv: List[str]) -> None:
    mvt.init(argv)


def shutdown() -> None:
    with _lock:
        _tables.clear()
    mvt.shutdown()


def barrier() -> None:
    mvt.barrier()


def num_workers() -> int:
    return mvt.num_workers()


def num_servers() -> int:
    return mvt.num_servers()


def worker_id() -> int:
    return mvt.worker_id()


def server_id() -> int:
    return mvt.server_id()


def rank() -> int:
    return mvt.rank()


def size() -> int:
    return mvt.size()


def set_flag(name: str, value: str) -> None:
    mvt.set_flag(name, value)


# -- array table -------------------------------------------------------------

def new_array_table(size: int) -> int:
    return _register(mvt.create_table("array", size, np.float32))


def array_get(handle: int, view, size: int) -> None:
    out = _f32(view, size)
    np.copyto(out, _host(_tables[handle].get()))


def array_add(handle: int, view, size: int, async_: int) -> None:
    delta = _f32(view, size).copy()
    table = _tables[handle]
    if async_:
        table.add_async(delta)
    else:
        table.add(delta)


# -- matrix table ------------------------------------------------------------

def new_matrix_table(num_row: int, num_col: int) -> int:
    return _register(mvt.create_table("matrix", num_row, num_col, np.float32))


def matrix_get_all(handle: int, view, size: int) -> None:
    out = _f32(view, size)
    np.copyto(out, _host(_tables[handle].get()).reshape(-1))


def matrix_add_all(handle: int, view, size: int, async_: int) -> None:
    table = _tables[handle]
    delta = _f32(view, size).copy().reshape(table.num_row, table.num_col)
    if async_:
        table.add_async(delta)
    else:
        table.add(delta)


def matrix_get_rows(handle: int, view, size: int, ids_view, n: int) -> None:
    table = _tables[handle]
    ids = _i32(ids_view, n)
    out = _f32(view, size)
    np.copyto(out, _host(table.get(ids)).reshape(-1))


def matrix_add_rows(handle: int, view, size: int, ids_view, n: int,
                    async_: int) -> None:
    table = _tables[handle]
    ids = _i32(ids_view, n).copy()
    delta = _f32(view, size).copy().reshape(n, table.num_col)
    if async_:
        table.add_async(delta, row_ids=ids)
    else:
        table.add(delta, row_ids=ids)
