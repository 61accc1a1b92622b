"""Carry table state from the JAX package into this one.

The JAX package's table state leaves it as numpy arrays at LOGICAL dims —
the slicing its checkpoint ``store`` writes (``MatrixServer.store``:
``data[:num_row, :num_col]`` and each updater state
``[:, :num_row, :num_col]``; ``ArrayServer.store``: ``data[:size]`` and
``[:, :size]``). :func:`load_state` installs such arrays into a table of
this package, into its own padded layout, so the next Add computes the
same result in both packages. :func:`word2vec_params` does the same for
the word2vec parameters of ``init_params`` / ``DeviceTrainer.params``.
Nothing here imports the JAX package: the caller hands over plain arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.array_table import ArrayServer
from multiverso_tpu_torch.tables.matrix_table import MatrixServer


def load_state(table, data: np.ndarray,
               states: Mapping[str, np.ndarray]) -> None:
    """Install ``data`` and the updater ``states`` (numpy, logical dims,
    each state with its leading worker dimension) into ``table`` (a worker
    proxy or a server table of kind array or matrix). The state names must
    be the table's updater's. Runs on the dispatcher thread, serialized
    with table traffic; a sparse table then serves every row fresh once."""
    server = getattr(table, "_server_table", table)
    if isinstance(server, MatrixServer):
        logical = (slice(0, server.num_row), slice(0, server.num_col))
        shape = (server.num_row, server.num_col)
    elif isinstance(server, ArrayServer):
        logical = (slice(0, server.size),)
        shape = (server.size,)
    else:
        raise TypeError(f"load_state: unsupported table {type(server).__name__}")
    data = np.asarray(data)
    if data.shape != shape:
        raise ValueError(f"load_state: data shape {data.shape} != table {shape}")
    if set(states) != set(server.states):
        raise ValueError(f"load_state: states {sorted(states)} != the "
                         f"updater's {sorted(server.states)}")
    for name, arr in states.items():
        want = (server.states[name].shape[0],) + shape
        if np.shape(arr) != want:
            raise ValueError(f"load_state: state {name!r} shape "
                             f"{np.shape(arr)} != {want}")

    def install() -> None:
        server.data[logical] = torch.from_numpy(
            np.array(data, dtype=server.dtype)).to(server.device)
        for name, arr in states.items():
            dst = server.states[name]
            dst[(slice(None),) + logical] = torch.from_numpy(
                np.array(arr)).to(server.device, dst.dtype)
        if getattr(server, "is_sparse", False):
            with server._std_lock:
                server._up_to_date[:, :] = False

    Zoo.instance().server.run_serialized(install)


def word2vec_params(w_in: np.ndarray, w_out: np.ndarray,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX package's word2vec parameters (``init_params`` or
    ``DeviceTrainer.params``, as numpy, sentinel row included) as the
    port's dict of float32 tensors on ``device`` (``cuda`` unless the CPU
    is asked for)."""
    device = mesh_lib.build_device(str(device))
    out = {}
    for name, arr in (("w_in", w_in), ("w_out", w_out)):
        arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError(f"word2vec_params: {name} must be 2-D, got "
                             f"shape {arr.shape}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)
    if out["w_in"].shape[1] != out["w_out"].shape[1]:
        raise ValueError("word2vec_params: w_in and w_out widths differ")
    return out
