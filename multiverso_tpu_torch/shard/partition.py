"""Table partitioners + the shard layout plan (port of
``multiverso_tpu/shard/partition.py``; host only, and the layout manifest
is the JAX package's byte for byte, so clients of either package
bootstrap from members of either package).

Reference capability (not copied): every reference table subclassed
``Partition(deltas) -> per-server blobs`` — ArrayTable sliced by contiguous
element range, KV/sparse tables hashed ``key % num_servers`` — and the
worker merged per-server partial replies positionally
(``include/multiverso/table_interface.h``, ``src/table/array_table.cpp``).

Here partitioning is a first-class, *serializable* object: the same spec
that routes a client's request (:mod:`multiverso_tpu_torch.shard.router`) is
written into the shard group's layout manifest so a recovering shard, a
warm standby, and a freshly bootstrapping client all agree on who owns
which rows/keys. Two kinds:

* ``range`` — contiguous spans for positional tables (array elements,
  matrix rows, optionally sparse key ranges). Shard ``k`` owns
  ``[bounds[k], bounds[k+1])``; requests translate global ids to
  shard-local ids by subtracting the span base (the shard's table is
  allocated at its *local* size — HBM ∝ span, not ∝ total).
* ``hash`` — a stable splitmix64 mix over int64 keys, mod shard count.
  Stable means: not Python's per-process ``hash()`` — the same key maps
  to the same shard in every process, forever, which is what makes the
  layout recoverable.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from multiverso_tpu_torch import log

PARTITIONER_KINDS = ("range", "hash")

# flag value -> key-table partitioner (array/matrix rows are always range:
# whole-table Get/Add are span-positional operations a hash cannot serve)
_FLAG_VALUES = ("auto", "range", "hash")


def stable_hash64(keys: Any) -> np.ndarray:
    """Vectorized splitmix64 finalizer over int64 keys -> uint64 mix.

    Process-stable and layout-stable by construction (pure arithmetic,
    no seeds from the environment): the shard map survives restarts,
    failovers, and client re-bootstraps.
    """
    x = np.asarray(keys, dtype=np.int64).astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class RangePartitioner:
    """Contiguous spans over ``[0, total)`` — near-even split by default."""

    kind = "range"

    def __init__(self, total: int, num_shards: int,
                 bounds: Optional[Sequence[int]] = None) -> None:
        self.total = int(total)
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            log.fatal("RangePartitioner: num_shards must be >= 1 (got %d)",
                      self.num_shards)
        if bounds is None:
            # near-even: the first (total % shards) spans get one extra row
            base, extra = divmod(self.total, self.num_shards)
            bounds = [0]
            for k in range(self.num_shards):
                bounds.append(bounds[-1] + base + (1 if k < extra else 0))
        self.bounds = [int(b) for b in bounds]
        if (len(self.bounds) != self.num_shards + 1 or self.bounds[0] != 0
                or self.bounds[-1] != self.total
                or any(lo > hi for lo, hi in zip(self.bounds,
                                                 self.bounds[1:]))):
            log.fatal("RangePartitioner: bounds %r do not tile [0, %d) "
                      "into %d spans", self.bounds, self.total,
                      self.num_shards)
        self._edges = np.asarray(self.bounds[1:-1], dtype=np.int64)

    def shard_of(self, ids: Any) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        return np.searchsorted(self._edges, ids, side="right")

    def span(self, shard: int) -> tuple:
        return self.bounds[shard], self.bounds[shard + 1]

    def local_size(self, shard: int) -> int:
        lo, hi = self.span(shard)
        return hi - lo

    def to_local(self, ids: np.ndarray, shard: int) -> np.ndarray:
        return ids - self.bounds[shard]

    def to_global(self, ids: np.ndarray, shard: int) -> np.ndarray:
        return ids + self.bounds[shard]

    # keys translate like ids: a range-partitioned sparse table stores
    # shard-local keys so its key_space stays ∝ span
    translates = True

    def to_spec(self) -> Dict[str, Any]:
        return {"kind": "range", "total": self.total,
                "num_shards": self.num_shards, "bounds": list(self.bounds)}


class HashPartitioner:
    """Stable-hash placement for arbitrary integer keys."""

    kind = "hash"
    translates = False  # keys stay global on every shard

    def __init__(self, num_shards: int) -> None:
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            log.fatal("HashPartitioner: num_shards must be >= 1 (got %d)",
                      self.num_shards)

    def shard_of(self, keys: Any) -> np.ndarray:
        return (stable_hash64(keys) % np.uint64(self.num_shards)).astype(
            np.int64)

    def to_local(self, keys: np.ndarray, shard: int) -> np.ndarray:
        return keys

    def to_global(self, keys: np.ndarray, shard: int) -> np.ndarray:
        return keys

    def to_spec(self) -> Dict[str, Any]:
        return {"kind": "hash", "num_shards": self.num_shards}


def make_partitioner(kind: str, num_shards: int,
                     total: Optional[int] = None):
    """Construct a partitioner by name; unknown names fail fast with the
    accepted values in the message (config-hygiene contract)."""
    if kind == "range":
        if total is None:
            log.fatal("range partitioner needs a total (rows/elements/"
                      "key_space)")
        return RangePartitioner(total, num_shards)
    if kind == "hash":
        return HashPartitioner(num_shards)
    log.fatal("unknown partitioner %r (accepted: %s)", kind,
              "|".join(PARTITIONER_KINDS))


def partitioner_from_spec(spec: Dict[str, Any]):
    """Rebuild a partitioner from its serialized layout-manifest spec."""
    kind = spec.get("kind")
    if kind == "range":
        return RangePartitioner(spec["total"], spec["num_shards"],
                                bounds=spec.get("bounds"))
    if kind == "hash":
        return HashPartitioner(spec["num_shards"])
    log.fatal("layout manifest names unknown partitioner %r (accepted: %s)",
              kind, "|".join(PARTITIONER_KINDS))


def validate_partitioner_flag(value: str) -> str:
    """The ``-shard_partitioner`` flag, validated: unknown values fail via
    log.fatal with the accepted set instead of silently defaulting."""
    value = str(value).strip().lower()
    if value not in _FLAG_VALUES:
        log.fatal("shard_partitioner=%r is not a partitioner "
                  "(accepted: %s); see docs/sharding.md", value,
                  "|".join(_FLAG_VALUES))
    return value


def parse_shard_endpoints(text: Any) -> List[str]:
    """The ``-shard_endpoints`` flag: comma-separated host:port list,
    validated fail-fast (a malformed entry names itself in the fatal)."""
    if isinstance(text, (list, tuple)):
        entries = [str(e).strip() for e in text]
    else:
        entries = [e.strip() for e in str(text).split(",")]
    entries = [e for e in entries if e]
    if not entries:
        log.fatal("shard_endpoints is empty — pass a comma-separated "
                  "host:port list (e.g. '10.0.0.1:5550,10.0.0.2:5550')")
    for e in entries:
        host, sep, port = e.rpartition(":")
        if not sep or not host or not port.isdigit():
            log.fatal("shard_endpoints entry %r is not host:port "
                      "(full list: %r)", e, entries)
    return entries


# -- layout planning ----------------------------------------------------------

_TABLE_KINDS = ("array", "matrix", "kv", "sparse")


def _table_partitioner_kind(table_kind: str, flag_value: str) -> str:
    """Resolve the partitioner for one table kind under the flag.

    array/matrix are always range (their whole-table ops are positional
    spans); kv is always hash (unbounded key space has no ranges);
    sparse follows the flag (auto -> hash).
    """
    if table_kind in ("array", "matrix"):
        if flag_value == "hash":
            log.fatal("shard_partitioner=hash cannot serve %s tables "
                      "(whole-table Get/Add are span-positional); use "
                      "auto or range", table_kind)
        return "range"
    if table_kind == "kv":
        if flag_value == "range":
            log.fatal("shard_partitioner=range cannot serve kv tables "
                      "(keys are unbounded); use auto or hash")
        return "hash"
    if table_kind == "sparse":
        return "hash" if flag_value == "auto" else flag_value
    log.fatal("unknown table kind %r (accepted: %s)", table_kind,
              "|".join(_TABLE_KINDS))


def plan_tables(table_specs: Sequence[Dict[str, Any]], num_shards: int,
                partitioner_flag: str = "auto") -> List[Dict[str, Any]]:
    """Turn declarative global table specs into layout-manifest entries.

    ``table_specs``: ``[{"kind": "matrix", "num_row": R, "num_col": C,
    ...}, ...]`` — the same keyword surface as ``mv.create_table``.
    Returns entries ``{"table_id", "kind", "params", "partitioner"}``
    where ``params`` holds the GLOBAL constructor arguments and
    ``partitioner`` the serialized placement spec.
    """
    flag_value = validate_partitioner_flag(partitioner_flag)
    entries = []
    for table_id, raw in enumerate(table_specs):
        spec = dict(raw)
        kind = spec.pop("kind", None)
        if kind not in _TABLE_KINDS:
            log.fatal("table spec %d: unknown kind %r (accepted: %s)",
                      table_id, kind, "|".join(_TABLE_KINDS))
        part_kind = _table_partitioner_kind(kind, flag_value)
        if kind == "array":
            total = int(spec["size"])
        elif kind == "matrix":
            total = int(spec["num_row"])
        elif kind == "sparse":
            total = int(spec["key_space"])
        else:  # kv: hash has no total
            total = None
        part = make_partitioner(part_kind, num_shards, total=total)
        if "dtype" in spec:
            spec["dtype"] = np.dtype(spec["dtype"]).str
        if "value_dtype" in spec:
            spec["value_dtype"] = np.dtype(spec["value_dtype"]).str
        entries.append({"table_id": table_id, "kind": kind, "params": spec,
                        "partitioner": part.to_spec()})
    return entries


def shard_table_kwargs(entry: Dict[str, Any], shard: int) -> Dict[str, Any]:
    """Shard-local constructor kwargs for one layout entry: range kinds
    shrink their positional dimension to the shard's span (ids/keys are
    translated to local by the router), hash kinds keep global params.
    Returns ``(kwargs, row_offset)`` — the offset a range shard's server
    table records for directory introspection."""
    params = dict(entry["params"])
    part = partitioner_from_spec(entry["partitioner"])
    kind = entry["kind"]
    offset = 0
    if isinstance(part, RangePartitioner):
        lo, hi = part.span(shard)
        offset = lo
        if kind == "array":
            params["size"] = hi - lo
        elif kind == "matrix":
            params["num_row"] = hi - lo
        elif kind == "sparse":
            params["key_space"] = hi - lo
    elif kind == "kv" and params.get("capacity"):
        # device-KV shards split the preallocated capacity (each child
        # process holds ~1/N of the keys)
        params["capacity"] = max(64, int(params["capacity"]) // part.num_shards)
    return params, offset
