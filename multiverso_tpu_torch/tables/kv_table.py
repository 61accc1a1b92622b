"""KVTable — key-value table with integer keys (port of
``multiverso_tpu/tables/kv_table.py``).

Reference capability (not copied): header-only distributed
``unordered_map<Key,Val>`` hash-sharded ``key % num_servers``, with a
worker-side local cache ``raw()`` (``include/multiverso/table/kv_table.h``);
its ``Store/Load`` were Fatal stubs — implemented for real here.

Three server backends behind one worker API:

* :class:`KVServer` — a host dict behind the dispatcher: control-plane use
  (word counts, arbitrary-width python ints).
* :class:`TieredKVServer` — the same, with its values in a hot/cold
  :class:`~multiverso_tpu_torch.store.TieredStore` (``make_tiered_kv``).
* :class:`DeviceKVServer` (``capacity=N``) — the data-plane design: keys
  and values live on the device in a static-capacity open-addressing hash
  (:mod:`multiverso_tpu_torch.ops.device_hash`), placed on a server shard
  by ``key % num_shards``; the port has one shard per device. Growth is
  rebuild-and-replay. The lightLDA-shaped sparse-KV store.

Checkpoints of all three are the live pairs sorted by key, byte for byte
as the JAX package writes them, so they interchange.

In a multi-process lockstep world (``runtime/multihost.py``) every rank
holds a whole replica of a KV table and replays the same Adds, growth
included: Gets need no exchange. On the card the device hash's claim
rounds may settle a contended slot differently on each rank, so the
ranks' slot layouts can differ while their key->value maps and live
counts agree.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Optional, Tuple, Union

import numpy as np

import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.ops import device_hash
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable
from multiverso_tpu_torch.utils import next_pow2, torch_dtype


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

    def remote_spec(self):
        return {"kind": "kv", "dtype": self.value_dtype.str}

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


class TieredKVServer(KVServer):
    """KVServer whose value store is hot/cold tiered (``store/``). Scalars
    ride the tier as width-1 rows; numeric dtypes only (the host KVServer
    also stores python objects, which cannot spill to fixed-width
    segments). Its snapshot is the plain KV format, and its ``remote_spec``
    says ``kind=kv``, so remote proxies treat it as a plain KV table."""

    def __init__(self, value_dtype: Any = np.float32,
                 resident_bytes: Optional[int] = None,
                 cold_bits: Optional[int] = None,
                 tier_dir: Optional[str] = None,
                 admit_touches: Optional[int] = None) -> None:
        super().__init__(value_dtype)
        if self.value_dtype.kind not in "fiu":
            log.fatal("tiered KV values must be numeric (got %s); the "
                      "in-RAM KV table handles object values",
                      self.value_dtype)
        from multiverso_tpu_torch.store import TieredStore
        self._tier = TieredStore(1, self.value_dtype,
                                 resident_bytes=resident_bytes,
                                 cold_bits=cold_bits, directory=tier_dir,
                                 admit_touches=admit_touches)
        self._store = None  # any missed base-class path must fail loudly

    def process_add(self, request) -> None:
        keys, values, _option = request
        tier = self._tier
        dtype = self.value_dtype
        for k, v in zip(keys, values):
            k = int(k)
            row = tier.get_for_update(k)
            if row is None:
                tier.put(k, np.array([v], dtype=dtype))
            else:
                row[0] = row[0] + dtype.type(v)
        tier.maybe_maintain()

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            return {int(k): self.value_dtype.type(row[0])
                    for k, row in self._tier.items()}
        zero = self.value_dtype.type(0)
        out = []
        for k in keys:
            row = self._tier.get(int(k))
            out.append(self.value_dtype.type(row[0])
                       if row is not None else zero)
        return out

    # KVServer.store/load read self._store directly: snapshot through the
    # tier instead (the same format, so snapshots interchange)
    def store(self, stream) -> None:
        items = sorted((int(k), self.value_dtype.type(row[0]))
                       for k, row in self._tier.items())
        stream.write(struct.pack("<q", len(items)))
        for k, v in items:
            stream.write(struct.pack("<q", k))
            stream.write(np.asarray(v, dtype=self.value_dtype).tobytes())

    def load(self, stream) -> None:
        (count,) = struct.unpack("<q", stream.read(8))
        self._tier.clear()
        item = self.value_dtype.itemsize
        for _ in range(count):
            (k,) = struct.unpack("<q", stream.read(8))
            v = np.frombuffer(stream.read(item), dtype=self.value_dtype)[0]
            self._tier.put(int(k), np.array([v], dtype=self.value_dtype))
        self._tier.maybe_maintain()

    def tier_stats(self) -> Dict[str, int]:
        return self._tier.stats()


class DeviceKVServer(ServerTable):
    """Hash-sharded device-resident KV store (see the module docstring).

    Keys and values are ``(num_shards, shard_capacity + 1)`` tensors on the
    runtime's device, as in the JAX package (the last column is the
    shard's scratch slot); the port has one shard a device. Every
    Add combines duplicate keys on the host (``np.add.at``), then inserts
    the unique pairs with ONE host read for the overflow flags and the
    inserted count together. Growth: before an insert that could push the
    load factor past 0.5 the table is rebuilt with 4x headroom and the
    live pairs replayed into it (proactive); lanes that still exhaust
    their probes are re-inserted after a doubling rebuild (reactive); a
    ninth nested rebuild is fatal."""

    def __init__(self, value_dtype: Any = np.float32,
                 capacity: int = 1 << 20) -> None:
        super().__init__()
        self.value_dtype = np.dtype(value_dtype)
        if self.value_dtype.str not in ("<f4", "<i4"):
            log.fatal("DeviceKVServer values must be float32/int32; got %s "
                      "— use the host KV table for wider types",
                      self.value_dtype)
        self._torch_dtype = torch_dtype(self.value_dtype)
        self.num_shards = mesh_lib.table_shards()
        if self.num_shards != 1:
            log.fatal("DeviceKVServer places its hash on one device (one "
                      "shard), got %d shards", self.num_shards)
        # exact live count: hash_add reports newly-inserted slots per batch
        # (and rebuilds recount), so growth decisions never scan
        self._live = 0
        self.rebuilds = 0
        self._alloc(next_pow2(max(64, int(capacity))))

    def _alloc(self, per: int) -> None:
        """Fresh key and value tensors at capacity ``per``."""
        self.shard_capacity = self.capacity = per
        shape = (1, per + 1)
        self.keys = torch.full(shape, device_hash.EMPTY, dtype=torch.int32,
                               device=self.device)
        self.values = torch.zeros(shape, dtype=self._torch_dtype,
                                  device=self.device)

    @property
    def device_bytes(self) -> int:
        """Bytes the key and value tensors hold on the device."""
        return (self.keys.numel() * self.keys.element_size()
                + self.values.numel() * self.values.element_size())

    def _add(self, bk: torch.Tensor, bv: torch.Tensor):
        """``hash_add`` into the shard: (per-lane overflow flags, count of
        newly inserted keys), on the device."""
        return device_hash.hash_add(self.keys[0], self.values[0], bk, bv,
                                    self.shard_capacity)

    def _upload(self, keys: np.ndarray, values: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(
                    values, self.value_dtype)).to(self.device))

    def process_add(self, request) -> None:
        keys, values, _option = request
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        if keys.size and keys.min() < 0:
            log.fatal("DeviceKV keys must be >= 0")
        if keys.size and keys.max() >= (1 << 31):
            log.fatal("DeviceKV keys must fit int32")
        vals = np.asarray(values, dtype=self.value_dtype).reshape(-1)
        ukeys, inv = np.unique(keys.astype(np.int32), return_inverse=True)
        uvals = np.zeros(len(ukeys), self.value_dtype)
        np.add.at(uvals, inv, vals)
        self._insert(ukeys, uvals)

    def _insert(self, ukeys: np.ndarray, uvals: np.ndarray,
                depth: int = 0) -> None:
        """Insert unique (key, value) pairs, growing the table as needed
        (see the class docstring); lossless by the ``hash_add`` contract."""
        if depth > 8:
            log.fatal("DeviceKV growth did not converge after %d rebuilds "
                      "(capacity=%d, batch=%d)", depth, self.capacity,
                      len(ukeys))
        if 2 * (self._live + len(ukeys)) > self.capacity:
            self._grow(self._live + len(ukeys))
        if not len(ukeys):
            return
        overflow, inserted = self._add(*self._upload(ukeys, uvals))
        # ONE host read for the flags and the count together
        host = self._host_read(torch.cat([overflow.to(torch.int64),
                                          inserted.reshape(1)]))
        flags = host[:-1] > 0
        self._live += int(host[-1])
        if flags.any():
            # real probe exhaustion: force at least a doubling
            self._grow(self._live + int(flags.sum()), force_double=True)
            self._insert(ukeys[flags], uvals[flags], depth + 1)

    def _grow(self, need: int, force_double: bool = False) -> None:
        """Rebuild at a capacity giving >= 4x headroom over ``need`` live
        keys and replay the live pairs into it (which recounts the live
        figure exactly). ``force_double`` (the reactive overflow path)
        guarantees progress even where the headroom math alone would keep
        the same size. The JAX package replays through a host dict of the
        pairs; here they stay on the device."""
        live = self.keys[:, :-1] >= 0
        rk = self.keys[:, :-1][live]
        rv = self.values[:, :-1][live]
        n = int(rk.numel())
        # 4x headroom (load <= 0.25): the batch claim protocol retries one
        # slot per probe round, so contention can exhaust MAX_PROBE well
        # before 0.5 load
        per = next_pow2(max(64, 4 * max(need, n + 1),
                            2 * self.shard_capacity if force_double else 0))
        log.info("DeviceKV grow: %d live keys, capacity %d -> %d", n,
                 self.capacity, per)
        self._alloc(per)
        self.rebuilds += 1
        self._live = n
        if n:
            overflow, _inserted = self._add(rk, rv)
            if bool(overflow.any()):
                # 4x headroom should never exhaust 16 probes; if the key
                # distribution is that adversarial, stop
                log.fatal("DeviceKV rebuild overflowed its own replay "
                          "(%d keys, capacity %d)", n, self.capacity)

    def _live_pairs(self):
        """The live keys (int64) and values on the host, in slot order."""
        keys = self._host_read(self.keys[:, :-1]).reshape(-1)
        values = self._host_read(self.values[:, :-1]).reshape(-1)
        live = keys >= 0
        return keys[live].astype(np.int64), values[live]

    def process_get(self, request):
        keys, _option = request
        if keys is None:
            k, v = self._live_pairs()
            cast = self.value_dtype.type
            return {kk: cast(vv) for kk, vv in zip(k.tolist(), v.tolist())}
        keys = np.asarray(keys, dtype=np.int32).reshape(-1)
        out = device_hash.hash_get(self.keys[0], self.values[0],
                                   torch.from_numpy(keys).to(self.device),
                                   self.shard_capacity)
        return list(self._host_read(out))

    def remote_spec(self):
        return {"kind": "kv", "dtype": self.value_dtype.str}

    # -- checkpoint (live pairs only) ---------------------------------------
    def _record_dtype(self) -> np.dtype:
        """One stored pair: an int64 key, then the value (packed)."""
        return np.dtype([("k", "<i8"), ("v", self.value_dtype)])

    def store(self, stream) -> None:
        k, v = self._live_pairs()
        order = np.argsort(k, kind="stable")
        records = np.empty(len(k), self._record_dtype())
        records["k"] = k[order]
        records["v"] = v[order]
        stream.write(struct.pack("<q", len(k)))
        stream.write(records.tobytes())

    def load(self, stream) -> None:
        (count,) = struct.unpack("<q", stream.read(8))
        dtype = self._record_dtype()
        records = np.frombuffer(stream.read(count * dtype.itemsize), dtype,
                                count=count)
        # reset and replay through the growing insert path: a snapshot
        # larger than the current capacity simply triggers a rebuild
        self._alloc(self.shard_capacity)
        self._live = 0
        if count:
            self.process_add((records["k"].astype(np.int64),
                              records["v"].astype(self.value_dtype), None))


class KVWorker(WorkerTable):
    """Client proxy with a local cache (reference: ``raw()``). Pass
    ``capacity=N`` for the device-resident hash backend."""

    def __init__(self, value_dtype: Any = np.float32,
                 capacity: Optional[int] = None,
                 server: Optional[ServerTable] = None) -> None:
        super().__init__()
        self.value_dtype = np.dtype(value_dtype)
        if server is not None:
            self._server_table = server
        elif capacity is not None:
            self._server_table = DeviceKVServer(value_dtype, capacity)
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


def make_tiered_kv(value_dtype: Any = np.float32,
                   **tier_kwargs: Any) -> KVWorker:
    """Factory for ``register_table_type("tiered_kv", ...)``: a KVWorker
    served by a beyond-RAM :class:`TieredKVServer` (``tier_kwargs``:
    resident_bytes / cold_bits / tier_dir / admit_touches; defaults come
    from the ``tier_*`` flags)."""
    return KVWorker(value_dtype, server=TieredKVServer(value_dtype,
                                                       **tier_kwargs))
