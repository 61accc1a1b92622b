"""Typed request/reply codec for the host wire (remote table serving; port
of ``multiverso_tpu/runtime/wire.py``, its blobs byte for byte).

Reference capability (not copied): table requests crossed processes as typed
``Blob`` lists — keys blob, values blob, option blob — assembled by
``WorkerTable::Partition`` and consumed by ``ServerTable::ProcessAdd/Get``
(``src/worker.cpp:30-76``, ``src/server.cpp:36-58``); SparseMatrixTable
compressed its blobs with ``SparseFilter`` on every host hop
(``src/table/sparse_matrix_table.cpp:147-153, 260-309``).

Requests here are the *same* Python structures the in-process
dispatcher consumes (tuples of ids/values/options), so a remote client and a
local worker exercise identical server code. The codec maps such a structure
to a blob list: blob 0 is a JSON structure tree (tags + scalar leaves), blobs
1..N are raw ndarrays referenced by index. Float32 arrays are run through the
SparseFilter codec when compression is enabled AND it actually shrinks the
payload — the ``sparse`` tag is self-describing, so no negotiation handshake
is needed.
"""

from __future__ import annotations

import json
from typing import Any, List

import numpy as np

from multiverso_tpu_torch.dashboard import monitor
from multiverso_tpu_torch.updaters import AddOption, GetOption
from multiverso_tpu_torch.utils.quantization import QuantizedDelta

# arrays below this size never win from sparse encoding (header overhead)
_COMPRESS_MIN_SIZE = 64


def encode(obj: Any, compress: bool = False) -> List[np.ndarray]:
    """Structure -> [json-tree blob, ndarray blobs...]. Timed under the
    WIRE_ENCODE monitor (the reference instrumented exactly its serialize
    path, mpi_net.h:292)."""
    with monitor("WIRE_ENCODE"):
        return _encode(obj, compress)


def _encode(obj: Any, compress: bool) -> List[np.ndarray]:
    blobs: List[np.ndarray] = []

    def enc(o: Any) -> Any:
        if o is None:
            return {"t": "none"}
        if isinstance(o, (bool, np.bool_)):
            return {"t": "b", "v": bool(o)}
        if isinstance(o, (int, np.integer)):
            return {"t": "i", "v": int(o)}
        if isinstance(o, (float, np.floating)):
            return {"t": "f", "v": float(o)}
        if isinstance(o, str):
            return {"t": "s", "v": o}
        if isinstance(o, AddOption):
            return {"t": "addopt",
                    "v": [o.worker_id, o.momentum, o.learning_rate,
                          o.rho, o.lambda_]}
        if isinstance(o, GetOption):
            return {"t": "getopt", "v": o.worker_id}
        if isinstance(o, QuantizedDelta):
            # pre-encoded by the client's ErrorFeedback (the OneBits-slot
            # codec); rides as one uint8 blob, decoded server-side to
            # plain float32 so process_add never sees the compression
            blobs.append(np.frombuffer(o.payload, dtype=np.uint8))
            return {"t": "quant", "i": len(blobs) - 1,
                    "shape": list(o.shape)}
        if isinstance(o, np.ndarray) or hasattr(o, "__array__"):
            arr = np.ascontiguousarray(np.asarray(o))
            if (compress and arr.dtype == np.float32
                    and arr.size >= _COMPRESS_MIN_SIZE):
                from multiverso_tpu_torch.utils.quantization import sparse_encode
                payload = sparse_encode(arr)
                if len(payload) < arr.nbytes:
                    blobs.append(np.frombuffer(payload, dtype=np.uint8))
                    return {"t": "sparse", "i": len(blobs) - 1,
                            "shape": list(arr.shape)}
            blobs.append(arr)
            return {"t": "arr", "i": len(blobs) - 1}
        if isinstance(o, (list, tuple)):
            kind = "tuple" if isinstance(o, tuple) else "list"
            if o and all(isinstance(x, (int, float, np.integer, np.floating))
                         for x in o):
                # numeric lists ride as one array (KV key/value lists can be
                # large); decoded back to a python list
                blobs.append(np.asarray(o))
                return {"t": "nlist", "i": len(blobs) - 1, "k": kind}
            return {"t": kind, "items": [enc(x) for x in o]}
        if isinstance(o, dict):
            keys = list(o.keys())
            vals = list(o.values())
            if keys and all(isinstance(k, (int, np.integer)) for k in keys) \
                    and all(isinstance(v, (int, float, np.integer, np.floating))
                            for v in vals):
                # int->scalar dict (KV whole-table get) as two arrays
                blobs.append(np.asarray(keys, dtype=np.int64))
                blobs.append(np.asarray(vals))
                return {"t": "ndict", "k": len(blobs) - 2, "v": len(blobs) - 1}
            return {"t": "dict",
                    "items": [[enc(k), enc(v)] for k, v in o.items()]}
        raise TypeError(f"wire.encode: unsupported type {type(o)!r}")

    tree = enc(obj)
    head = np.frombuffer(json.dumps(tree).encode(), dtype=np.uint8)
    return [head] + blobs


def decode(blobs: List[np.ndarray]) -> Any:
    """[json-tree blob, ndarray blobs...] -> structure (WIRE_DECODE monitor,
    mirror of mpi_net.h:327's deserialize timer)."""
    with monitor("WIRE_DECODE"):
        return _decode(blobs)


def _decode(blobs: List[np.ndarray]) -> Any:
    tree = json.loads(bytes(np.asarray(blobs[0], dtype=np.uint8)).decode())
    data = blobs[1:]

    def dec(node: Any) -> Any:
        t = node["t"]
        if t == "none":
            return None
        if t in ("b", "i", "f", "s"):
            return node["v"]
        if t == "addopt":
            w, m, lr, rho, lam = node["v"]
            return AddOption(int(w), m, lr, rho, lam)
        if t == "getopt":
            return GetOption(int(node["v"]))
        if t == "arr":
            return data[node["i"]]
        if t == "sparse":
            from multiverso_tpu_torch.utils.quantization import sparse_decode
            shape = tuple(node["shape"])
            count = int(np.prod(shape)) if shape else 1
            flat = sparse_decode(
                bytes(np.asarray(data[node["i"]], dtype=np.uint8)), count)
            return flat.reshape(shape)
        if t == "quant":
            from multiverso_tpu_torch.utils.quantization import quant_decode
            shape = tuple(node["shape"])
            count = int(np.prod(shape)) if shape else 1
            flat = quant_decode(
                bytes(np.asarray(data[node["i"]], dtype=np.uint8)), count)
            return flat.reshape(shape)
        if t == "nlist":
            items = data[node["i"]].tolist()
            return tuple(items) if node["k"] == "tuple" else items
        if t in ("list", "tuple"):
            items = [dec(x) for x in node["items"]]
            return tuple(items) if t == "tuple" else items
        if t == "ndict":
            return dict(zip(data[node["k"]].tolist(),
                            data[node["v"]].tolist()))
        if t == "dict":
            return {dec(k): dec(v) for k, v in node["items"]}
        raise ValueError(f"wire.decode: unknown tag {t!r}")

    return dec(tree)
