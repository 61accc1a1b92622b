"""KVTable — key-value table with integer keys (port of
``multiverso_tpu/tables/kv_table.py``, the host backend).

Reference capability (not copied): header-only distributed
``unordered_map<Key,Val>`` with a worker-side local cache ``raw()``
(``include/multiverso/table/kv_table.h``); its ``Store/Load`` were Fatal
stubs — implemented for real here.

:class:`KVServer` is a host dict behind the dispatcher: control-plane use
(word counts, arbitrary-width python ints). Nothing of it lives on the
device. Not yet ported: the device-resident hash backend
(``DeviceKVServer``, ``capacity=N``) and the tiered backend.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np

from multiverso_tpu_torch import log
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable


class KVServer(ServerTable):
    def __init__(self, value_dtype: Any = np.float32) -> None:
        super().__init__()
        self.value_dtype = np.dtype(value_dtype)
        self._store: Dict[int, Any] = {}

    def merge_add_requests(self, requests):
        """Key/value add streams concatenate: ``process_add`` folds the
        merged pair list in exactly the original arrival order, so one
        fused apply is bit-identical to per-message applies."""
        keys: list = []
        values: list = []
        consumed = 0
        for request in requests:
            if not (isinstance(request, tuple) and len(request) == 3):
                break
            k, v, _option = request
            if k is None or v is None or len(k) != len(v):
                break  # per-message path reports the real error
            keys.extend(list(k))
            values.extend(list(v))
            consumed += 1
        if not consumed:
            return None
        return (keys, values, requests[0][2]), len(keys), consumed

    def process_add(self, request) -> None:
        keys, values, _option = request
        for k, v in zip(keys, values):
            if k in self._store:
                self._store[k] = self._store[k] + v
            else:
                self._store[k] = v

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            return dict(self._store)
        zero = self.value_dtype.type(0)
        return [self._store.get(k, zero) for k in keys]

    def store(self, stream) -> None:
        items = sorted(self._store.items())
        stream.write(struct.pack("<q", len(items)))
        for k, v in items:
            arr = np.asarray(v, dtype=self.value_dtype)
            stream.write(struct.pack("<q", int(k)))
            stream.write(arr.tobytes() or self.value_dtype.type(0).tobytes())

    def load(self, stream) -> None:
        (count,) = struct.unpack("<q", stream.read(8))
        self._store.clear()
        item = self.value_dtype.itemsize
        for _ in range(count):
            (k,) = struct.unpack("<q", stream.read(8))
            v = np.frombuffer(stream.read(item), dtype=self.value_dtype)[0]
            self._store[k] = v


class KVWorker(WorkerTable):
    """Client proxy with a local cache (reference: ``raw()``)."""

    def __init__(self, value_dtype: Any = np.float32,
                 capacity: Optional[int] = None,
                 server: Optional[ServerTable] = None) -> None:
        super().__init__()
        self.value_dtype = np.dtype(value_dtype)
        if server is not None:
            self._server_table = server
        elif capacity is not None:
            log.fatal("the device-resident KV backend (capacity=N) is not "
                      "yet ported to multiverso_tpu_torch")
        else:
            self._server_table = KVServer(value_dtype)
        self._register(self._server_table)
        self._raw: Dict[int, Any] = {}

    def raw(self) -> Dict[int, Any]:
        return self._raw

    def get(self, keys: Union[int, Iterable[int], None] = None):
        single = isinstance(keys, (int, np.integer))
        norm = None if keys is None else ([int(keys)] if single else [int(k) for k in keys])
        result = super().get((norm, None))
        if norm is None:
            self._raw = result
            return dict(result)
        for k, v in zip(norm, result):
            self._raw[k] = v
        return result[0] if single else result

    def add(self, keys: Union[int, Iterable[int]], values) -> None:
        norm, vals = self._normalize(keys, values)
        super().add((norm, vals, None))

    def add_async(self, keys, values) -> int:
        norm, vals = self._normalize(keys, values)
        return super().add_async((norm, vals, None))

    def _normalize(self, keys, values) -> Tuple[list, list]:
        if isinstance(keys, (int, np.integer)):
            return [int(keys)], [self.value_dtype.type(values)]
        norm = [int(k) for k in keys]
        vals = [self.value_dtype.type(v) for v in values]
        return norm, vals
