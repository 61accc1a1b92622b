"""Sparse-key tables: arbitrary integer keys, vector values, O(nnz) traffic
(port of ``multiverso_tpu/tables/sparse_table.py``).

The high-dimensional sparse-model table (the CTR shape): key spaces of 1e8
and more, where a dense device table would cost memory in proportion to
the key space instead of the live keys. The host dict IS the hash table,
as in the JAX package, so this module is host numpy there and here:

* ``add(keys, values)`` ships exactly the touched entries; the server
  applies the linear updater's sign (default ``+=``, sgd ``-=``).
* ``get(keys)`` returns exactly those rows (missing keys read as zero).
* ``get()`` returns ``(live_keys, values)``, sorted by key: size in
  proportion to the live keys.

:class:`SparseFTRLServer` is the struct-valued variant: per-key FTRL
accumulators ``(z, n)``; Add ships raw gradients, Get derives the
FTRL-proximal weights.

Checkpoints (``store``/``load``) write the live keys sorted, then their
rows (``SparseFTRLServer``: each key's ``z`` then ``n`` row), byte for byte
as the JAX package does.

:class:`TieredSparseServer` keeps the rows in a hot/cold
:class:`~multiverso_tpu_torch.store.TieredStore` under a byte budget
(``make_tiered_sparse``); its snapshot is the plain sparse format.

``remote_spec`` reports ``kind=sparse`` for all three servers, so a
remote client serves them through one proxy (``runtime/remote.py``).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np

from multiverso_tpu_torch import log
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable
from multiverso_tpu_torch.updaters import SGDUpdater, Updater, get_updater


class SparseServer(ServerTable):
    """Hash-map server: key -> (width,) row, created on first touch."""

    def __init__(self, key_space: int, width: int = 1,
                 dtype: Any = np.float32, updater_type: str = "") -> None:
        super().__init__()
        self.key_space = int(key_space)
        self.width = int(width)
        self.dtype = np.dtype(dtype)
        updater = get_updater(self.dtype, updater_type)
        if type(updater) not in (Updater, SGDUpdater):
            log.fatal("sparse table supports linear updaters (default/sgd); "
                      "use the sparse_ftrl table for stateful optimization")
        self._sign = -1.0 if isinstance(updater, SGDUpdater) else 1.0
        self._store: Dict[int, np.ndarray] = {}

    def _check_keys(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        if keys.size and (keys.min() < 0 or keys.max() >= self.key_space):
            log.fatal("sparse key out of range [0, %d)", self.key_space)
        return keys

    def process_add(self, request) -> None:
        keys, values, _option = request
        keys = self._check_keys(keys)
        values = np.asarray(values, dtype=self.dtype).reshape(-1, self.width)
        if len(keys) != len(values):
            log.fatal("sparse.add: %d keys but %d value rows",
                      len(keys), len(values))
        sign = self._sign
        store = self._store
        for k, v in zip(keys.tolist(), values):
            row = store.get(k)
            if row is None:
                store[k] = sign * v.copy()
            else:
                row += sign * v

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            # get-all: live entries only (reference Get(DataBlock*) semantics)
            live = np.fromiter(self._store.keys(), dtype=np.int64,
                               count=len(self._store))
            live.sort()
            vals = (np.stack([self._store[k] for k in live.tolist()])
                    if len(live) else np.zeros((0, self.width), self.dtype))
            return live, vals
        keys = self._check_keys(keys)
        out = np.zeros((len(keys), self.width), self.dtype)
        for i, k in enumerate(keys.tolist()):
            row = self._store.get(k)
            if row is not None:
                out[i] = row
        return out

    # -- checkpoint ---------------------------------------------------------
    def remote_spec(self):
        return {"kind": "sparse", "key_space": self.key_space,
                "width": self.width, "dtype": self.dtype.str}

    def store(self, stream) -> None:
        live, vals = self.process_get((None, None))
        stream.write(struct.pack("<qq", len(live), self.width))
        stream.write(live.astype(np.int64).tobytes())
        stream.write(vals.astype(self.dtype).tobytes())

    def load(self, stream) -> None:
        count, width = struct.unpack("<qq", stream.read(16))
        if width != self.width:
            log.fatal("sparse.load: width %d != %d", width, self.width)
        keys = np.frombuffer(stream.read(8 * count), dtype=np.int64)
        vals = np.frombuffer(stream.read(self.dtype.itemsize * count * width),
                             dtype=self.dtype).reshape(count, width)
        self._store = {int(k): v.copy() for k, v in zip(keys, vals)}


class SparseFTRLServer(ServerTable):
    """Struct-valued sparse server: per-key FTRL accumulators ``(z, n)``;
    Add ships raw gradient rows, Get derives FTRL-proximal weights (the
    server never stores stale w; same closed form as the dense
    :mod:`~multiverso_tpu_torch.tables.ftrl_table`)."""

    def __init__(self, key_space: int, width: int = 1, alpha: float = 0.1,
                 beta: float = 1.0, lambda1: float = 1.0,
                 lambda2: float = 1.0) -> None:
        super().__init__()
        self.key_space = int(key_space)
        self.width = int(width)
        self.dtype = np.dtype(np.float32)
        self.alpha, self.beta = float(alpha), float(beta)
        self.lambda1, self.lambda2 = float(lambda1), float(lambda2)
        self._z: Dict[int, np.ndarray] = {}
        self._n: Dict[int, np.ndarray] = {}

    def _weights(self, z: np.ndarray, n: np.ndarray) -> np.ndarray:
        shrunk = np.sign(z) * np.maximum(np.abs(z) - self.lambda1, 0.0)
        denom = (self.beta + np.sqrt(n)) / self.alpha + self.lambda2
        return (-shrunk / denom).astype(np.float32)

    def process_add(self, request) -> None:
        keys, grads, _option = request
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        grads = np.asarray(grads, dtype=np.float32).reshape(-1, self.width)
        for k, g in zip(keys.tolist(), grads):
            z = self._z.get(k)
            if z is None:
                z = np.zeros(self.width, np.float32)
                n = np.zeros(self.width, np.float32)
            else:
                n = self._n[k]
            w = self._weights(z, n)
            sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / self.alpha
            self._z[k] = z + g - sigma * w
            self._n[k] = n + g * g

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            live = np.fromiter(self._z.keys(), dtype=np.int64,
                               count=len(self._z))
            live.sort()
            vals = (np.stack([self._weights(self._z[k], self._n[k])
                              for k in live.tolist()])
                    if len(live) else np.zeros((0, self.width), np.float32))
            return live, vals
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        out = np.zeros((len(keys), self.width), np.float32)
        for i, k in enumerate(keys.tolist()):
            z = self._z.get(k)
            if z is not None:
                out[i] = self._weights(z, self._n[k])
        return out

    def remote_spec(self):
        return {"kind": "sparse", "key_space": self.key_space,
                "width": self.width, "dtype": self.dtype.str}

    def store(self, stream) -> None:
        live = np.array(sorted(self._z.keys()), dtype=np.int64)
        stream.write(struct.pack("<qq", len(live), self.width))
        stream.write(live.tobytes())
        for k in live.tolist():
            stream.write(self._z[k].tobytes())
            stream.write(self._n[k].tobytes())

    def load(self, stream) -> None:
        count, width = struct.unpack("<qq", stream.read(16))
        if width != self.width:
            log.fatal("sparse_ftrl.load: width %d != %d", width, self.width)
        keys = np.frombuffer(stream.read(8 * count), dtype=np.int64)
        self._z, self._n = {}, {}
        row = 4 * width
        for k in keys.tolist():
            self._z[k] = np.frombuffer(stream.read(row), np.float32).copy()
            self._n[k] = np.frombuffer(stream.read(row), np.float32).copy()


class TieredSparseServer(SparseServer):
    """SparseServer whose row store is hot/cold tiered (``store/``): hot
    rows stay dict-resident under ``tier_resident_bytes``; the LRU tail
    spills to quantized CRC-framed segments on disk and promotes back on
    access through a frequency-sketch admission filter.

    Everything above the store is unchanged: its snapshot is the plain
    sparse format. Demotion runs inside ``process_add``, on the
    dispatcher, after the triggering Add has applied."""

    def __init__(self, key_space: int, width: int = 1,
                 dtype: Any = np.float32, updater_type: str = "",
                 resident_bytes: Optional[int] = None,
                 cold_bits: Optional[int] = None,
                 tier_dir: Optional[str] = None,
                 admit_touches: Optional[int] = None) -> None:
        super().__init__(key_space, width, dtype, updater_type)
        from multiverso_tpu_torch.store import TieredStore
        self._tier = TieredStore(self.width, self.dtype,
                                 resident_bytes=resident_bytes,
                                 cold_bits=cold_bits, directory=tier_dir,
                                 admit_touches=admit_touches)
        self._store = None  # any missed base-class path must fail loudly

    def process_add(self, request) -> None:
        keys, values, _option = request
        keys = self._check_keys(keys)
        values = np.asarray(values, dtype=self.dtype).reshape(-1, self.width)
        if len(keys) != len(values):
            log.fatal("sparse.add: %d keys but %d value rows",
                      len(keys), len(values))
        signed = np.asarray(self._sign * values, dtype=self.dtype)
        tier = self._tier
        for k, v in zip(keys.tolist(), signed):
            row = tier.get_for_update(k)
            if row is None:
                tier.put(k, v.copy())
            else:
                row += v
        tier.maybe_maintain()

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            snap = dict(self._tier.items())
            live = np.fromiter(snap.keys(), dtype=np.int64, count=len(snap))
            live.sort()
            vals = (np.stack([snap[k] for k in live.tolist()])
                    if len(live) else np.zeros((0, self.width), self.dtype))
            return live, vals
        keys = self._check_keys(keys)
        out = np.zeros((len(keys), self.width), self.dtype)
        for i, k in enumerate(keys.tolist()):
            row = self._tier.get(k)
            if row is not None:
                out[i] = row
        return out

    # store() is inherited: it snapshots via process_get((None, None)).
    def load(self, stream) -> None:
        count, width = struct.unpack("<qq", stream.read(16))
        if width != self.width:
            log.fatal("sparse.load: width %d != %d", width, self.width)
        keys = np.frombuffer(stream.read(8 * count), dtype=np.int64)
        vals = np.frombuffer(stream.read(self.dtype.itemsize * count * width),
                             dtype=self.dtype).reshape(count, width)
        self._tier.clear()
        for k, v in zip(keys.tolist(), vals):
            self._tier.put(k, v.copy())
        self._tier.maybe_maintain()  # a beyond-RAM snapshot re-tiers on load

    def tier_stats(self) -> Dict[str, int]:
        return self._tier.stats()


class SparseWorker(WorkerTable):
    """Client proxy: O(nnz) get/add over arbitrary integer keys.

    ``get(keys)`` -> (N, W) rows; ``get()`` -> (live_keys, values);
    ``add(keys, values)`` ships exactly the touched entries. Counters
    ``elements_pushed`` / ``elements_pulled`` make the O(nnz) contract
    testable.
    """

    def __init__(self, key_space: int, width: int = 1,
                 dtype: Any = np.float32, updater_type: str = "",
                 ftrl: bool = False, server: Optional[ServerTable] = None,
                 **ftrl_kwargs: Any) -> None:
        super().__init__()
        self.key_space = int(key_space)
        self.width = int(width)
        self.dtype = np.dtype(dtype)
        if server is not None:
            self._server_table = server
        elif ftrl:
            self._server_table = SparseFTRLServer(key_space, width,
                                                  **ftrl_kwargs)
        else:
            self._server_table = SparseServer(key_space, width, dtype,
                                              updater_type)
        self._register(self._server_table)
        self.elements_pushed = 0
        self.elements_pulled = 0

    def _norm_keys(self, keys) -> Optional[np.ndarray]:
        if keys is None:
            return None
        return np.asarray(keys, dtype=np.int64).reshape(-1)

    def get(self, keys: Optional[Iterable[int]] = None
            ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        raw = super().get((self._norm_keys(keys), None))
        if keys is None:
            self.elements_pulled += int(raw[1].size)
        else:
            self.elements_pulled += int(raw.size)
        return raw

    def get_async(self, keys: Optional[Iterable[int]] = None) -> int:
        return super().get_async((self._norm_keys(keys), None))

    def add(self, keys: Iterable[int], values: np.ndarray) -> None:
        keys = self._norm_keys(keys)
        values = np.asarray(values, dtype=self.dtype)
        self.elements_pushed += int(values.size)
        super().add((keys, values, None))

    def add_async(self, keys: Iterable[int], values: np.ndarray) -> int:
        keys = self._norm_keys(keys)
        values = np.asarray(values, dtype=self.dtype)
        self.elements_pushed += int(values.size)
        return super().add_async((keys, values, None))


def make_sparse_ftrl(key_space: int, width: int = 1, **kwargs: Any
                     ) -> SparseWorker:
    """Factory for ``register_table_type("sparse_ftrl", ...)``."""
    return SparseWorker(key_space, width, ftrl=True, **kwargs)


def make_tiered_sparse(key_space: int, width: int = 1,
                       dtype: Any = np.float32, updater_type: str = "",
                       **tier_kwargs: Any) -> SparseWorker:
    """Factory for ``register_table_type("tiered_sparse", ...)``: a
    SparseWorker served by a beyond-RAM :class:`TieredSparseServer`
    (``tier_kwargs``: resident_bytes / cold_bits / tier_dir /
    admit_touches; defaults come from the ``tier_*`` flags)."""
    server = TieredSparseServer(key_space, width, dtype, updater_type,
                                **tier_kwargs)
    return SparseWorker(key_space, width, dtype, updater_type, server=server)
