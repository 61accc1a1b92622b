"""Carry table state from the JAX package into this one.

The JAX package's table state leaves it as numpy arrays at LOGICAL dims —
the slicing its checkpoint ``store`` writes (``MatrixServer.store``:
``data[:num_row, :num_col]`` and each updater state
``[:, :num_row, :num_col]``; ``ArrayServer.store``: ``data[:size]`` and
``[:, :size]``). :func:`load_state` installs such arrays into a table of
this package, into its own padded layout, so the next Add computes the
same result in both packages. :func:`word2vec_params` does the same for
the word2vec parameters of ``init_params`` / ``DeviceTrainer.params``.
The logistic-regression state crosses the same way:
:func:`load_logreg_weights` (a ``LogReg``'s weights, or a ``PSLogReg``'s
array table), :func:`load_ftrl_state` (an FTRL table's ``z``/``n``, dense
or sparse) and :func:`load_sparse_state` (a sparse table's live keys and
values); a host KV table's entries cross with :func:`load_kv_state`, a
device KV table's with :func:`load_device_kv_state` (by replay: the JAX
table spreads its hash over 8 shards, the port's over one, so slot arrays
do not carry over). A tiered table crosses through its snapshot bytes
(:func:`load_snapshot`), which are the plain sparse or KV format.
The CIFAR ResNet crosses with :func:`resnet_variables` (a flax model's
``variables`` into the port's name -> tensor dicts), and its ASGD table with
:func:`resnet_table_from_jax` / :func:`resnet_table_to_jax`: the JAX table
holds the flax leaves in ``jax.tree_util`` order (dict keys sorted, so
``BasicBlock_10`` precedes ``BasicBlock_2``) with HWIO convolution kernels
and (in, out) dense kernels; the port's holds its parameter names sorted,
in torch's OIHW and (out, in) layouts. The carry is a permutation plus a
transpose per leaf.
A JAX ``PSGibbsLDA``'s state (tokens, assignments, counts) leaves with
:func:`lda_state_from_jax`, and a port ``PSGibbsLDA`` resumes from it
(``z=``); the addition-RNN example's flax parameters become the port
example's ``state_dict`` with :func:`addition_rnn_from_jax`, and the
long-context example's parameter dict becomes the port twin's with
:func:`long_context_params_from_jax`.
Nothing here imports the JAX package: the caller hands over plain arrays.
A checkpoint file (``checkpoint.py``) is the second way across: the JAX
package's ``store_table`` writes the same state, and the port's
``load_table`` installs it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.array_table import ArrayServer
from multiverso_tpu_torch.tables.ftrl_table import FTRLServer
from multiverso_tpu_torch.io import MemoryStream
from multiverso_tpu_torch.tables.kv_table import DeviceKVServer, KVServer
from multiverso_tpu_torch.tables.matrix_table import MatrixServer
from multiverso_tpu_torch.tables.sparse_table import (SparseFTRLServer,
                                                      SparseServer)


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


def load_sparse_state(table, keys: np.ndarray, values: np.ndarray) -> None:
    """Replace a sparse table's entries with ``keys`` (the JAX table's live
    keys) and their ``(len(keys), width)`` ``values``, as its get-all
    returns them."""
    server = getattr(table, "_server_table", table)
    if type(server) is not SparseServer:
        raise TypeError(f"load_sparse_state: unsupported table "
                        f"{type(server).__name__}")
    keys = np.asarray(keys, np.int64).reshape(-1)
    values = np.asarray(values, server.dtype).reshape(-1, server.width)
    if len(keys) != len(values):
        raise ValueError(f"load_sparse_state: {len(keys)} keys but "
                         f"{len(values)} value rows")
    server._check_keys(keys)
    store = {int(k): v.copy() for k, v in zip(keys, values)}

    def install() -> None:
        server._store = store

    Zoo.instance().server.run_serialized(install)


def load_kv_state(table, items: Mapping[int, Any]) -> None:
    """Replace a host KV table's entries with ``items`` (key -> value, as
    the JAX ``KVWorker.get()`` returns them); values take the table's
    value dtype."""
    server = getattr(table, "_server_table", table)
    if type(server) is not KVServer:
        raise TypeError(f"load_kv_state: unsupported table "
                        f"{type(server).__name__}")
    cast = server.value_dtype.type
    store = {int(k): cast(v) for k, v in items.items()}

    def install() -> None:
        server._store = store

    Zoo.instance().server.run_serialized(install)


def load_device_kv_state(table, items: Mapping[int, Any]) -> None:
    """Replace a device KV table's entries with ``items`` (key -> value, as
    the JAX ``KVWorker.get()`` returns them for its ``DeviceKVServer``):
    the table is emptied at its capacity and the pairs replayed through
    its growing insert path, so the key -> value map, not the slot layout,
    carries over."""
    server = getattr(table, "_server_table", table)
    if not isinstance(server, DeviceKVServer):
        raise TypeError(f"load_device_kv_state: unsupported table "
                        f"{type(server).__name__}")
    keys = np.fromiter((int(k) for k in items), np.int64, len(items))
    values = np.fromiter(items.values(), server.value_dtype, len(items))

    def install() -> None:
        server._alloc(server.shard_capacity)
        server._live = 0
        if len(keys):
            server.process_add((keys, values, None))

    Zoo.instance().server.run_serialized(install)


def load_snapshot(table, payload: bytes) -> None:
    """Load a table's checkpoint bytes (``ServerTable.store`` of either
    package) into ``table``, on the dispatcher. The tiered tables' bytes
    are the plain sparse and KV formats, so a JAX tiered table crosses
    into a port tiered table or a plain one, and back."""
    server = getattr(table, "_server_table", table)
    Zoo.instance().server.run_serialized(
        lambda: server.load(MemoryStream(bytes(payload))))


def load_ftrl_state(table, z: np.ndarray, n: np.ndarray,
                    keys: Optional[np.ndarray] = None) -> None:
    """Install FTRL accumulators: a dense FTRL table takes ``z`` and ``n``
    of its logical size; a sparse FTRL table takes the live ``keys`` with
    ``(len(keys), width)`` rows of ``z`` and ``n``."""
    server = getattr(table, "_server_table", table)
    z = np.asarray(z, np.float32)
    n = np.asarray(n, np.float32)
    if isinstance(server, FTRLServer):
        if keys is not None or z.shape != (server.size,) or n.shape != z.shape:
            raise ValueError(f"load_ftrl_state: dense table of size "
                             f"{server.size} takes z and n of that shape, "
                             f"no keys")

        def install() -> None:
            server.z[: server.size] = torch.from_numpy(z.copy()).to(server.device)
            server.n[: server.size] = torch.from_numpy(n.copy()).to(server.device)
    elif isinstance(server, SparseFTRLServer):
        if keys is None:
            raise ValueError("load_ftrl_state: a sparse FTRL table needs keys")
        keys = np.asarray(keys, np.int64).reshape(-1)
        shape = (len(keys), server.width)
        if z.reshape(-1).size != np.prod(shape) or n.shape != z.shape:
            raise ValueError(f"load_ftrl_state: z and n must hold {shape} rows")
        z, n = z.reshape(shape), n.reshape(shape)
        zs = {int(k): r.copy() for k, r in zip(keys, z)}
        ns = {int(k): r.copy() for k, r in zip(keys, n)}

        def install() -> None:
            server._z, server._n = zs, ns
    else:
        raise TypeError(f"load_ftrl_state: unsupported table "
                        f"{type(server).__name__}")
    Zoo.instance().server.run_serialized(install)


def load_logreg_weights(model, w: np.ndarray) -> None:
    """A ``LogReg``'s weights ``(output_size, input_size + 1)``; for a
    ``PSLogReg`` on the array table, the table's data, then the replica is
    pulled again. Sparse and FTRL PS models hold table state instead: load
    it with :func:`load_sparse_state` / :func:`load_ftrl_state` into
    ``model.table``, then call ``model.finish()`` to pull it."""
    from multiverso_tpu_torch.models.logreg import PSLogReg
    cfg = model.config
    w = np.asarray(w, np.float32)
    if w.shape != (cfg.output_size, cfg.input_size + 1):
        raise ValueError(f"load_logreg_weights: shape {w.shape} != "
                         f"{(cfg.output_size, cfg.input_size + 1)}")
    if not isinstance(model, PSLogReg):
        model.load_weights(w)
        return
    if not isinstance(model.table._server_table, ArrayServer):
        raise TypeError("load_logreg_weights: a sparse or FTRL PSLogReg holds "
                        "table state; use load_sparse_state / load_ftrl_state")
    load_state(model.table, w.reshape(-1), {})
    model.finish()


def _resnet_leaves(config) -> List[Tuple[str, tuple, tuple, tuple]]:
    """``(port name, port shape, flax path, axes)`` of every ResNet
    parameter and BatchNorm statistic, in the port's module order; the
    flax leaf is the port leaf transposed by ``axes`` (None: as it is)."""
    from multiverso_tpu_torch.models.resnet import CifarResNet
    norm = "BatchNorm" if config.norm == "batch" else "GroupNorm"
    with torch.device("meta"):
        model = CifarResNet(config)
    named = list(model.named_parameters()) + list(model.named_buffers())
    out = []
    for name, t in named:
        *mods, leaf = name.split(".")
        if mods[0] == "blocks":
            prefix = (f"BasicBlock_{mods[1]}",)
            mod = {"conv1": "Conv_0", "conv2": "Conv_1", "norm1": f"{norm}_0",
                   "norm2": f"{norm}_1"}[mods[2]]
        else:
            prefix = ()
            mod = {"conv": "Conv_0", "norm": f"{norm}_0", "fc": "Dense_0"}[mods[0]]
        axes = None
        if leaf == "weight" and t.dim() == 4:      # OIHW <- HWIO
            leaf, axes = "kernel", (2, 3, 1, 0)
        elif leaf == "weight" and t.dim() == 2:    # (out, in) <- (in, out)
            leaf, axes = "kernel", (1, 0)
        elif leaf == "weight":
            leaf = "scale"
        out.append((name, tuple(t.shape), prefix + (mod, leaf), axes))
    return out


def _flax_leaf(tree: Mapping, path: tuple) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def resnet_variables(flax_variables: Mapping, config,
                     device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """A flax ``CifarResNet``'s ``variables`` (``params``, and
    ``batch_stats`` for norm="batch", as nested dicts of numpy arrays) as
    the port's ``variables`` on ``device`` (``cuda`` unless the CPU is
    asked for): dicts of name -> float32 tensor for
    ``models.resnet.CifarResNet`` built from the same ``config``."""
    device = mesh_lib.build_device(str(device))
    out: Dict[str, Dict[str, torch.Tensor]] = {"params": {}}
    if config.norm == "batch":
        out["batch_stats"] = {}
    for name, shape, path, axes in _resnet_leaves(config):
        stats = path[-1] in ("mean", "var")
        arr = _flax_leaf(flax_variables["batch_stats" if stats else "params"],
                         path)
        if axes is not None:
            arr = arr.transpose(np.argsort(axes))
        if arr.shape != shape:
            raise ValueError(f"resnet_variables: {'/'.join(path)} has shape "
                             f"{arr.shape}, the port's {name} {shape}")
        out["batch_stats" if stats else "params"][name] = torch.from_numpy(
            np.array(arr, np.float32)).to(device)
    return out


def _resnet_orders(config):
    """The parameters as ``(name, port shape, flax shape, axes)`` in the
    port table's order, and a permutation giving the JAX table's order."""
    leaves = [(name, shape, path, axes) for name, shape, path, axes
              in _resnet_leaves(config) if path[-1] not in ("mean", "var")]
    port = sorted(leaves, key=lambda e: e[0])
    jax_order = sorted(range(len(port)), key=lambda i: port[i][2])
    rows = [(name, shape, shape if axes is None else
             tuple(shape[a] for a in axes), axes)
            for name, shape, _, axes in port]
    return rows, jax_order


def resnet_table_from_jax(flat: np.ndarray, config) -> np.ndarray:
    """The JAX ASGD table's flat vector (``PytreeParamManager`` over a flax
    ResNet's ``params``) in the port table's order and layouts: restore a
    JAX ResNet checkpoint's array, then :func:`load_state` this into the
    port trainer's ``manager.table``."""
    rows, jax_order = _resnet_orders(config)
    flat = np.asarray(flat, np.float32).reshape(-1)
    parts: List[Optional[np.ndarray]] = [None] * len(rows)
    n = 0
    for i in jax_order:
        _, shape, fshape, axes = rows[i]
        size = int(np.prod(fshape))
        leaf = flat[n:n + size].reshape(fshape)
        parts[i] = leaf if axes is None else leaf.transpose(np.argsort(axes))
        n += size
    if n != flat.size:
        raise ValueError(f"resnet_table_from_jax: {flat.size} values, the "
                         f"config's parameters are {n}")
    return np.concatenate([p.reshape(-1) for p in parts])


def resnet_table_to_jax(flat: np.ndarray, config) -> np.ndarray:
    """The inverse of :func:`resnet_table_from_jax`: the port's ASGD table
    as the JAX package's ``PytreeParamManager`` lays it out."""
    rows, jax_order = _resnet_orders(config)
    flat = np.asarray(flat, np.float32).reshape(-1)
    parts, n = [], 0
    for _, shape, _, axes in rows:
        size = int(np.prod(shape))
        leaf = flat[n:n + size].reshape(shape)
        parts.append(leaf if axes is None else leaf.transpose(axes))
        n += size
    if n != flat.size:
        raise ValueError(f"resnet_table_to_jax: {flat.size} values, the "
                         f"config's parameters are {n}")
    return np.concatenate([parts[i].reshape(-1) for i in jax_order])


def lda_state_from_jax(jax_lda) -> Dict[str, np.ndarray]:
    """A JAX ``PSGibbsLDA``'s state as numpy: ``tokens`` (D, L) with -1
    pads, its assignments ``z``, the word-topic counts (vocab, K) and the
    topic totals (K,). A port ``PSGibbsLDA`` built over the same documents
    with ``z=state["z"]`` seeds its tables to the same counts."""
    k = int(jax_lda.config.num_topics)
    return {
        "tokens": np.array(jax_lda.tokens, dtype=np.int32, copy=True),
        "z": np.array(jax_lda.z, dtype=np.int32, copy=True),
        "word_topic": np.array(jax_lda.word_topic_counts(), dtype=np.float32,
                               copy=True),
        "topic_counts": np.array(np.asarray(jax_lda.topic_counts.get())[:k],
                                 dtype=np.float32, copy=True),
    }


def _lstm_from_flax(cell: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax ``LSTMCell``'s parameters as ``torch.nn.LSTM`` layer 0's: the
    ``i*`` kernels (no bias) stack into ``weight_ih`` and the ``h*`` kernels
    into ``weight_hh`` in torch's gate order i, f, g, o, each transposed
    to (out, in); flax has one bias (the ``h*`` Denses'), so ``bias_ih``
    is zero and ``bias_hh`` is flax's."""
    gates = ("i", "f", "g", "o")

    def kernel(name):
        return np.asarray(cell[name]["kernel"], np.float32).T

    w_ih = np.concatenate([kernel("i" + g) for g in gates])
    w_hh = np.concatenate([kernel("h" + g) for g in gates])
    b_hh = np.concatenate([np.asarray(cell["h" + g]["bias"], np.float32)
                           for g in gates])
    return {f"{prefix}.weight_ih_l0": torch.from_numpy(w_ih),
            f"{prefix}.weight_hh_l0": torch.from_numpy(w_hh),
            f"{prefix}.bias_ih_l0": torch.zeros(b_hh.shape, dtype=torch.float32),
            f"{prefix}.bias_hh_l0": torch.from_numpy(b_hh)}


def addition_rnn_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX addition-RNN example's flax ``params`` (``Embed_0``,
    ``LSTMCell_0`` the encoder, ``LSTMCell_1`` the decoder, ``Dense_0``)
    as a ``state_dict`` of the port example's ``AdditionRNN`` (CPU
    float32 tensors; ``load_state_dict`` moves them to the module's
    device). The ``Dense`` kernel is transposed to torch's (out, in)."""
    out = {"embed.weight": torch.from_numpy(np.array(
        flax_params["Embed_0"]["embedding"], np.float32))}
    out.update(_lstm_from_flax(flax_params["LSTMCell_0"], "encoder"))
    out.update(_lstm_from_flax(flax_params["LSTMCell_1"], "decoder"))
    out["dense.weight"] = torch.from_numpy(np.array(
        np.asarray(flax_params["Dense_0"]["kernel"], np.float32).T))
    out["dense.bias"] = torch.from_numpy(np.array(
        flax_params["Dense_0"]["bias"], np.float32))
    return out


def long_context_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX long-context example's parameter dict (``emb``, ``rel``,
    ``qkv``, ``proj``, ``mlp_in``, ``mlp_out``, as numpy arrays) as the
    port twin's (CPU float32 tensors, for
    ``examples/long_context_lm.py``'s ``params=``). Both models multiply
    activations on the left (``g @ qkv``), so every leaf keeps its
    layout."""
    names = ("emb", "rel", "qkv", "proj", "mlp_in", "mlp_out")
    return {n: torch.from_numpy(np.array(params[n], np.float32))
            for n in names}
