"""Client-side shard router: split Get/Add by placement, merge replies
(port of ``multiverso_tpu/shard/router.py``; host only — a router client
holds no table state and touches no card).

:class:`ShardedClient` is a drop-in for
:class:`~multiverso_tpu_torch.runtime.remote.RemoteClient`: same
``table()/tables()/close()`` surface, same worker-proxy classes, same
``submit/post`` channel contract underneath. The difference is one layer —
a :class:`_ShardChannel` that, per request, maps the touched rows/keys to
shard ids through the table's partitioner, issues the sub-requests through
per-shard ``RemoteClient``\\ s (each with its OWN retry/retransmit/
reconnect state, so a slow or dead shard never blocks traffic to the
others), and merges the partial replies into one result that is
bit-identical to a single-server run.

Split/merge are module-level pure functions (:func:`split_request`) so the
bit-identical property is testable against real server tables without a
socket in sight (tests/test_torch_shard.py holds them equal to the JAX
package's, part for part).

``Request_Query`` (top-k retrieval pushdown, query/) fans out whole: the
candidate set is the entire table, so every shard scores the same query
and the merge folds per-shard partial top-ks — ids re-globalized through
the partitioner — under the engine's ordering contract.

Observability: every fan-out bumps ``ROUTER_FANOUT`` by the number of
sub-requests, and each sub-request's round trip lands in a per-shard
histogram ``ROUTER_SHARD<k>_SECONDS`` — a dead shard's failover shows up
in ITS histogram while the others stay flat (the property the chaos test
asserts).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count, gauge_add, observe
from multiverso_tpu_torch.obs.trace import hop, tag_tenant
from multiverso_tpu_torch.runtime.admission import resolve_tenant
from multiverso_tpu_torch.runtime.message import MsgType, next_msg_id
from multiverso_tpu_torch.shard.partition import (RangePartitioner,
                                            partitioner_from_spec)
from multiverso_tpu_torch.updaters import AddOption, GetOption
from multiverso_tpu_torch.utils.backoff import Backoff

LAYOUT_VERSION = 1

# how many times one logical request may chase the layout before its
# failure surfaces to the caller (each attempt re-fetches/installs the
# newest layout first, so >1 migration completing mid-request is covered)
_MAX_REROUTES = 3


class ShardLayout:
    """The shard group's layout manifest — who serves what, where.

    Plain-JSON manifest (written by :class:`~multiverso_tpu_torch.shard.group.
    ShardGroup`, fetched by clients via the ``Control_Layout`` RPC)::

        {"version": 1, "num_shards": N,
         "layout_version": 1,                       # monotonic; bumped by
                                                    # every live migration
         "endpoints": ["host:port", ...],           # one per shard
         "replicas": [["host:port", ...], ...],     # optional: per-shard
                                                    # read-replica fleets
         "tables": [{"table_id": 0, "kind": "matrix",
                     "params": {...global ctor args...},
                     "partitioner": {"kind": "range", ...}}, ...]}

    ``version`` is the manifest SCHEMA version (a format contract);
    ``layout_version`` is the TOPOLOGY generation — it only moves
    forward, each split/merge/move bumps it, and routers stamp it on
    every sharded request so a mid-migration server can refuse stale
    routing with ``Reply_WrongShard`` (docs/sharding.md).
    """

    def __init__(self, manifest: Dict[str, Any]) -> None:
        if int(manifest.get("version", 0)) != LAYOUT_VERSION:
            log.fatal("shard layout version %r unsupported (want %d)",
                      manifest.get("version"), LAYOUT_VERSION)
        self.layout_version = int(manifest.get("layout_version", 1))
        self.manifest = manifest
        self.endpoints: List[str] = list(manifest["endpoints"])
        self.num_shards = int(manifest.get("num_shards",
                                           len(self.endpoints)))
        if self.num_shards != len(self.endpoints):
            log.fatal("shard layout lists %d endpoints for %d shards",
                      len(self.endpoints), self.num_shards)
        # per-shard read-replica endpoints (read-replica tier); absent or
        # short lists pad to [] — a shard with no replicas simply serves
        # every Get from its primary
        raw = list(manifest.get("replicas", []))
        self.replicas: List[List[str]] = [
            list(raw[k]) if k < len(raw) else []
            for k in range(self.num_shards)]
        self.tables: List[Dict[str, Any]] = list(manifest["tables"])
        self._parts: Dict[int, Any] = {}

    def entry(self, table_id: int) -> Dict[str, Any]:
        for e in self.tables:
            if int(e["table_id"]) == int(table_id):
                return e
        log.fatal("shard layout has no table %d (tables: %s)", table_id,
                  [int(e["table_id"]) for e in self.tables])

    def partitioner(self, table_id: int):
        part = self._parts.get(int(table_id))
        if part is None:
            part = partitioner_from_spec(self.entry(table_id)["partitioner"])
            self._parts[int(table_id)] = part
        return part

    def to_json(self) -> str:
        return json.dumps(self.manifest)

    @classmethod
    def from_file(cls, path: str) -> "ShardLayout":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))


def fetch_layout(endpoint: str, timeout: float = 10.0,
                 budget: Optional[object] = None) -> ShardLayout:
    """One-shot layout RPC: any member of a shard group answers with the
    full manifest, so clients bootstrap from a single known endpoint (the
    reference's Controller broadcast, pull-shaped). Like the stats probe,
    this takes no worker slot and no lease.

    Connection-level failures (refused, reset, probe timeout) retry on
    the shared jittered backoff (utils/backoff.py) inside ``timeout``: a
    client racing a group's startup — or a migration's member churn —
    should wait out the bind race, not fail on the first probe. A
    server-side REFUSAL (not a shard-group member) still raises
    immediately. ``budget`` (a fault/retry.py RetryBudget) gates the
    re-fetches a layout-churn storm would otherwise amplify."""
    from multiverso_tpu_torch.runtime.remote import control_probe
    deadline = time.monotonic() + timeout
    bo = Backoff(base=0.05, cap=1.0, deadline=deadline, budget=budget)
    while True:
        remaining = deadline - time.monotonic()
        try:
            payload = control_probe(endpoint, MsgType.Control_Layout,
                                    MsgType.Control_Reply_Layout,
                                    timeout=max(0.2, remaining),
                                    what="layout")
            return ShardLayout(payload)
        except OSError as exc:  # ConnectionError/TimeoutError included
            if not bo.wait():
                raise
            count("LAYOUT_FETCH_RETRIES")
            log.debug("fetch_layout(%s): %r — retrying (attempt %d)",
                      endpoint, exc, bo.attempt)


# -- split/merge (pure; the bit-identical contract lives here) ---------------


def _as_ids(ids: Any) -> np.ndarray:
    return np.asarray(ids).reshape(-1)


def _split_by_owner(part, ids: np.ndarray):
    """-> list of (shard, positions, local_ids); shards with no work are
    omitted, positions index the caller's original order."""
    owners = part.shard_of(ids)
    out = []
    for shard in range(part.num_shards):
        mask = owners == shard
        if not mask.any():
            continue
        pos = np.nonzero(mask)[0]
        local = part.to_local(ids[pos], shard)
        out.append((shard, pos, local.astype(ids.dtype, copy=False)))
    return out


def split_request(kind: str, part, msg_type: MsgType, request: Any,
                  params: Dict[str, Any],
                  rewrite_option: Optional[Callable[[int, Any], Any]] = None,
                  ) -> Tuple[List[Tuple[int, Any]], Callable[[List[Any]], Any]]:
    """Split one channel-level request into per-shard sub-requests.

    Returns ``(parts, merge)``: ``parts`` is ``[(shard, sub_request),
    ...]`` (possibly empty for an empty workload) and ``merge`` folds the
    aligned partial replies into the single-server reply. ``params`` is
    the table's GLOBAL layout params (used to synthesize empty results).
    ``rewrite_option`` maps a default-stamped option envelope to the
    shard-local worker identity.
    """
    opt = rewrite_option or (lambda shard, option: option)
    if msg_type == MsgType.Request_Query:
        if kind not in ("matrix", "sparse"):
            log.fatal("router: top-k query is unsupported for %r tables "
                      "(no row-shaped scorable state)", kind)
        return _split_query(part, request)
    if kind == "array":
        return _split_array(part, msg_type, request, opt)
    if kind == "matrix":
        return _split_matrix(part, msg_type, request, params, opt)
    if kind == "kv":
        return _split_kv(part, msg_type, request, opt)
    if kind == "sparse":
        return _split_sparse(part, msg_type, request, params, opt)
    log.fatal("router: unknown table kind %r", kind)


def _split_query(part, request):
    """Top-k pushdown fan-out. There is no id set to route by — the
    candidate set is the whole table — so every shard scores the SAME
    ``(vecs, k, metric)`` request against its rows. Per-shard replies
    carry shard-LOCAL ids (matrix row indices; translated sparse keys);
    the merge maps them back through the partitioner (``to_global`` is
    the identity for hash-partitioned sparse keys, which are stored
    global) and re-imposes the engine's ordering contract — score
    descending, ties by ascending GLOBAL id — which is what makes the
    assembled top-k bit-identical to a single-shard oracle, ragged
    partials (a shard owning fewer than k rows) included."""
    from multiverso_tpu_torch.query.engine import merge_topk
    _vecs, k, _metric = request  # validated at the submit entry point
    parts = [(s, request) for s in range(part.num_shards)]

    def merge(rs):
        globalized = []
        for (s, _sub), r in zip(parts, rs):
            ids = np.asarray(r[0], dtype=np.int64)
            scores = np.asarray(r[1], dtype=np.float32)
            globalized.append(
                (np.asarray(part.to_global(ids, s), dtype=np.int64),
                 scores))
        return merge_topk(globalized, int(k))
    return parts, merge


def _split_array(part, msg_type, request, opt):
    if not isinstance(part, RangePartitioner):
        log.fatal("array tables route by range partitioner only")
    if msg_type == MsgType.Request_Get:
        # request IS the option (ArrayWorker.get(option)); every shard
        # contributes its span, concatenated in shard order
        parts = [(s, opt(s, request)) for s in range(part.num_shards)]
        return parts, lambda rs: np.concatenate(
            [np.asarray(r) for r in rs])
    delta, option = request
    flat = np.asarray(delta).reshape(-1)
    parts = [(s, (flat[part.span(s)[0]:part.span(s)[1]], opt(s, option)))
             for s in range(part.num_shards)]
    return parts, lambda rs: None


def _split_matrix(part, msg_type, request, params, opt):
    if not isinstance(part, RangePartitioner):
        log.fatal("matrix tables route by range partitioner only")
    num_col = int(params["num_col"])
    dtype = np.dtype(params.get("dtype", "<f4"))
    if msg_type == MsgType.Request_Get:
        row_ids, option = request
        if row_ids is None:
            parts = [(s, (None, opt(s, option)))
                     for s in range(part.num_shards)]

            def merge(rs):
                if rs and isinstance(rs[0], tuple):
                    # sparse stale-rows form: (local_ids, rows) per shard
                    # -> global ids, concatenated (shard spans are
                    # ascending, so the id order matches a single server's
                    # ascending np.where scan)
                    ids = np.concatenate(
                        [part.to_global(np.asarray(r[0]), s)
                         for (s, _), r in zip(parts, rs)])
                    rows = np.concatenate([np.asarray(r[1]).reshape(
                        -1, num_col) for r in rs])
                    return ids.astype(np.int32, copy=False), rows
                return np.concatenate([np.asarray(r) for r in rs])
            return parts, merge
        ids = _as_ids(row_ids)
        split = _split_by_owner(part, ids)
        parts = [(s, (local, opt(s, option))) for s, _pos, local in split]

        def merge(rs):
            first = np.asarray(rs[0])
            out = np.empty((len(ids),) + first.shape[1:], first.dtype)
            for (s, pos, _local), r in zip(split, rs):
                out[pos] = np.asarray(r)
            return out
        if not parts:
            return parts, lambda rs: np.zeros((0, num_col), dtype)
        return parts, merge
    # Add
    row_ids, values, option = request
    if row_ids is None:
        vals = np.asarray(values).reshape(part.total, -1)
        parts = [(s, (None, vals[part.span(s)[0]:part.span(s)[1]],
                      opt(s, option)))
                 for s in range(part.num_shards)]
        return parts, lambda rs: None
    ids = _as_ids(row_ids)
    vals = np.asarray(values).reshape(len(ids), -1)
    split = _split_by_owner(part, ids)
    parts = [(s, (local, vals[pos], opt(s, option)))
             for s, pos, local in split]
    return parts, lambda rs: None


def _split_kv(part, msg_type, request, opt):
    if msg_type == MsgType.Request_Get:
        keys, option = request
        if keys is None:
            parts = [(s, (None, opt(s, option)))
                     for s in range(part.num_shards)]

            def merge(rs):
                out: Dict[int, Any] = {}
                for r in rs:
                    out.update(r)
                return out
            return parts, merge
        ids = np.asarray([int(k) for k in keys], dtype=np.int64)
        split = _split_by_owner(part, ids)
        parts = [(s, ([int(k) for k in local], opt(s, option)))
                 for s, _pos, local in split]

        def merge(rs):
            out: List[Any] = [None] * len(ids)
            for (s, pos, _local), r in zip(split, rs):
                for p, v in zip(pos, r):
                    out[int(p)] = v
            return out
        if not parts:
            return parts, lambda rs: []
        return parts, merge
    keys, values, option = request
    ids = np.asarray([int(k) for k in keys], dtype=np.int64)
    vals = list(values)
    split = _split_by_owner(part, ids)
    parts = [(s, ([int(k) for k in local], [vals[int(p)] for p in pos],
                  opt(s, option)))
             for s, pos, local in split]
    return parts, lambda rs: None


def _split_sparse(part, msg_type, request, params, opt):
    width = int(params.get("width", 1))
    dtype = np.dtype(params.get("dtype", "<f4"))
    if msg_type == MsgType.Request_Get:
        keys, option = request
        if keys is None:
            parts = [(s, (None, opt(s, option)))
                     for s in range(part.num_shards)]

            def merge(rs):
                live = np.concatenate(
                    [part.to_global(np.asarray(r[0], np.int64), s)
                     for (s, _), r in zip(parts, rs)])
                vals = np.concatenate(
                    [np.asarray(r[1]).reshape(-1, width) for r in rs])
                order = np.argsort(live)  # single server returns sorted keys
                return live[order], vals[order]
            return parts, merge
        ids = _as_ids(keys).astype(np.int64)
        split = _split_by_owner(part, ids)
        parts = [(s, (local, opt(s, option))) for s, _pos, local in split]

        def merge(rs):
            first = np.asarray(rs[0])
            out = np.zeros((len(ids),) + first.shape[1:], first.dtype)
            for (s, pos, _local), r in zip(split, rs):
                out[pos] = np.asarray(r)
            return out
        if not parts:
            return parts, lambda rs: np.zeros((0, width), dtype)
        return parts, merge
    keys, values, option = request
    ids = _as_ids(keys).astype(np.int64)
    vals = np.asarray(values).reshape(len(ids), -1)
    split = _split_by_owner(part, ids)
    parts = [(s, (local, vals[pos], opt(s, option)))
             for s, pos, local in split]
    return parts, lambda rs: None


def make_shard_error_feedback(kind: str, params: Dict[str, Any], part,
                              bits: int) -> Optional[List[Any]]:
    """Per-shard ErrorFeedback residual slices keyed by the layout's
    RANGE partitioner: shard ``k``'s residual covers exactly its span, so
    shard-local ids index it directly and the union of the slices tiles
    the global residual a single-server client would keep. Only float32
    array/matrix tables quantize (parity with RemoteClient's proxies);
    returns None when quantization does not apply."""
    if bits <= 0 or kind not in ("array", "matrix"):
        return None
    if np.dtype(params.get("dtype", "<f4")) != np.float32:
        return None
    if not isinstance(part, RangePartitioner):
        return None  # array/matrix always range-route; belt and braces
    from multiverso_tpu_torch.utils.quantization import ErrorFeedback
    if kind == "matrix":
        return [ErrorFeedback((part.local_size(s), int(params["num_col"])),
                              bits)
                for s in range(part.num_shards)]
    return [ErrorFeedback((part.local_size(s),), bits)
            for s in range(part.num_shards)]


def dedup_add_ids(kind: str, request: Any) -> Any:
    """Pre-aggregate duplicate row ids in a matrix Add BEFORE the split:
    within one shard a duplicate local id would share one residual read
    and last-write the error feedback (same hazard the per-proxy EF path
    guards against)."""
    if kind != "matrix":
        return request
    ids, values, option = request
    if ids is None:
        return request
    from multiverso_tpu_torch.runtime.remote import merge_duplicate_rows
    ids_arr = np.asarray(ids).reshape(-1)
    vals = np.asarray(values, np.float32).reshape(len(ids_arr), -1)
    ids2, vals2 = merge_duplicate_rows(ids_arr, vals)
    return (ids2, vals2, option)


def quantize_split_parts(kind: str, efs: List[Any],
                         parts: List[Tuple[int, Any]]
                         ) -> List[Tuple[int, Any]]:
    """Compress each per-shard Add sub-request with ITS shard's residual
    slice — quantization runs AFTER the plain-float32 split, so the
    quantized payload routes correctly and each shard's server decodes a
    payload shaped for its local table."""
    out: List[Tuple[int, Any]] = []
    for shard, sub in parts:
        ef = efs[shard]
        if kind == "matrix":
            ids, values, option = sub
            quant = ef.compress(np.asarray(values, np.float32), ids)
            out.append((shard, (ids, quant, option)))
        else:  # array: (span-values, option), whole-slice residual
            values, option = sub
            out.append((shard, (ef.compress(np.asarray(values, np.float32)),
                                option)))
    return out


def _empty_reply(kind: str, msg_type: MsgType, request: Any,
                 params: Dict[str, Any]) -> Any:
    """Single-server-shaped reply for a zero-part workload (empty id/key
    batches never touch the wire)."""
    if msg_type == MsgType.Request_Add:
        return None
    if msg_type == MsgType.Request_Query:
        n_q = int(np.atleast_2d(np.asarray(request[0])).shape[0])
        return (np.zeros((n_q, 0), np.int64),
                np.zeros((n_q, 0), np.float32))
    dtype = np.dtype(params.get("dtype", params.get("value_dtype", "<f4")))
    if kind == "matrix":
        return np.zeros((0, int(params["num_col"])), dtype)
    if kind == "sparse":
        return np.zeros((0, int(params.get("width", 1))), dtype)
    if kind == "kv":
        return []
    return np.zeros(0, dtype)


def globalize_add(kind: str, sub: Any, part, shard: int) -> Any:
    """Map one shard-local Add sub-request back to GLOBAL coordinates.

    When a live migration fences a shard mid-fan-out, only SOME parts of
    an Add are refused with ``Reply_WrongShard``; the applied parts must
    not be re-sent (Adds are not idempotent across a layout change — the
    dedup window does not migrate). The refused part re-enters the router
    as a fresh global request and re-splits under the NEW layout. This is
    the inverse of the split functions, pure so tests can assert
    split → globalize → re-split is lossless. Only range-partitioned
    array/matrix tables can migrate (reshard.plan_* refuse the rest), so
    only their sub-request shapes are invertible here.
    """
    if kind == "matrix":
        local, vals, option = sub
        lo, hi = part.span(shard)
        if local is None:
            # whole-span Add: the shard's slice of a full-table payload
            rows = np.asarray(vals).reshape(hi - lo, -1)
            return np.arange(lo, hi, dtype=np.int32), rows, option
        ids = part.to_global(np.asarray(local).reshape(-1), shard)
        return ids.astype(np.int32, copy=False), np.asarray(vals), option
    if kind == "array":
        delta, option = sub
        lo, hi = part.span(shard)
        flat = np.asarray(delta).reshape(-1)
        out = np.zeros(part.total, flat.dtype)
        out[lo:hi] = flat
        return out, option
    log.fatal("router: cannot globalize a %r Add part (only migratable "
              "kinds are re-routed)", kind)


# -- fan-out completion ------------------------------------------------------


class _MergeCompletion:
    """Counts down the per-shard partial replies; on the last one, merges
    and settles the caller's completion. A failed part is first offered to
    the router's migration-retry hook (``retry``): the hook may re-issue
    the part under a refreshed layout ("reissued" — the merge stays armed
    and the hook settles the part later) or take over the whole request
    ("superseded" — the merge disarms without failing; the hook completes
    the caller's completion itself). Unhandled failures fail the whole
    request (the per-shard RemoteClient already burned its own retry/
    reconnect budget before reporting failure)."""

    __slots__ = ("_completion", "_merge", "_results", "_left", "_failed",
                 "_lock", "_retry")

    def __init__(self, completion, n_parts: int, merge_fn,
                 retry=None) -> None:
        self._completion = completion
        self._merge = merge_fn
        self._results: List[Any] = [None] * n_parts
        self._left = n_parts
        self._failed = False
        self._lock = threading.Lock()
        self._retry = retry

    def part(self, idx: int, shard: int) -> "_PartCompletion":
        return _PartCompletion(self, idx, shard)

    def _part_done(self, idx: int, result: Any) -> None:
        with self._lock:
            self._results[idx] = result
            self._left -= 1
            fire = self._left == 0 and not self._failed
        if not fire:
            return
        try:
            self._completion.done(self._merge(self._results))
        except Exception as exc:  # noqa: BLE001 — a merge bug must fail the
            # waiter, not kill the per-shard pump thread delivering the reply
            self._completion.fail(exc)

    def _part_fail(self, idx: int, shard: int,
                   error: BaseException) -> None:
        if self._retry is not None:
            with self._lock:
                if self._failed:
                    return
            verdict = None
            try:
                verdict = self._retry(self, idx, shard, error)
            except Exception as exc:  # noqa: BLE001 — a hook bug fails the
                # request, never the pump thread delivering the refusal
                error = exc
            if verdict == "reissued":
                return
            if verdict == "superseded":
                with self._lock:
                    self._failed = True
                return
        self._force_fail(error)

    def _force_fail(self, error: BaseException) -> None:
        with self._lock:
            if self._failed:
                return
            self._failed = True
        self._completion.fail(error)


class _PartCompletion:
    """One sub-request's completion: records the per-shard round trip in
    ``ROUTER_SHARD<k>_SECONDS`` (and the live queue depth in the
    ``ROUTER_SHARD<k>_INFLIGHT`` gauge) then reports to the merge
    parent."""

    __slots__ = ("_parent", "_idx", "_shard", "_t0", "_settled")

    def __init__(self, parent: _MergeCompletion, idx: int,
                 shard: int) -> None:
        self._parent = parent
        self._idx = idx
        self._shard = shard
        self._t0 = time.monotonic()
        self._settled = False
        gauge_add(f"ROUTER_SHARD{shard}_INFLIGHT", 1)

    def _observe(self) -> None:
        # a retry hook may re-deliver; the gauge must decrement exactly
        # once per sub-request or the depth drifts
        if self._settled:
            return
        self._settled = True
        observe(f"ROUTER_SHARD{self._shard}_SECONDS",
                time.monotonic() - self._t0)
        gauge_add(f"ROUTER_SHARD{self._shard}_INFLIGHT", -1)

    def done(self, result: Any) -> None:
        self._observe()
        self._parent._part_done(self._idx, result)

    def fail(self, error: BaseException) -> None:
        self._observe()
        self._parent._part_fail(self._idx, self._shard, error)


class _ShardChannel:
    """WorkerTable request channel that routes through the ShardedClient
    (the sharded analog of RemoteChannel)."""

    def __init__(self, client: "ShardedClient") -> None:
        self._client = client

    def worker_id(self) -> int:
        return self._client.worker_id

    def submit(self, table_id: int, msg_type: MsgType, request: Any,
               msg_id: int, completion) -> None:
        self._client._route(table_id, msg_type, request, completion)

    def post(self, table_id: int, msg_type: MsgType) -> None:
        self._client._post_all(table_id, msg_type)


class ShardedClient:
    """Off-mesh client for a shard group — RemoteClient's surface, N
    servers underneath.

    Registers one worker slot on EVERY shard (size the shards'
    ``remote_workers`` flag for the expected client count); the option
    envelopes riding each sub-request carry that shard's own worker id,
    so per-worker updater state and staleness planes stay consistent
    per shard. Per-shard fault state is exactly RemoteClient's: retries,
    retransmits, reconnect-and-resume, and the dedup window each shard
    keeps — one shard's failover never blocks the others' traffic.
    """

    def __init__(self, layout: Any, timeout: float = 30.0,
                 read_preference: Optional[str] = None) -> None:
        self.layout = (layout if isinstance(layout, ShardLayout)
                       else ShardLayout(layout))
        from multiverso_tpu_torch.runtime.remote import RemoteClient
        self._timeout = timeout
        self._read_pref = read_preference
        # wire_quant_bits routes THROUGH the shard router: residuals are
        # kept as per-shard slices keyed by (table, layout generation) —
        # a migration re-partitions the table, so the slices rebuild
        # (residual history resets; quantization is lossy anyway)
        self._efs: Dict[Tuple[int, int], Optional[List[Any]]] = {}
        self._ef_lock = threading.Lock()
        # _state_lock guards the (layout, clients, shard_wids) triple so a
        # routing attempt reads one consistent snapshot; _refresh_lock
        # serializes whole refresh operations (which dial sockets and can
        # take seconds) without blocking routers on the hot path
        self._state_lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._retired: List[RemoteClient] = []
        self._clients: List[RemoteClient] = []
        try:
            for shard, endpoint in enumerate(self.layout.endpoints):
                # each per-shard client owns ITS shard's read tier: the
                # layout's replica fleet for that shard, routed per the
                # read preference with per-shard fallback to that
                # shard's primary (docs/serving.md)
                self._clients.append(RemoteClient(
                    endpoint, timeout=timeout,
                    read_endpoints=self.layout.replicas[shard],
                    read_preference=read_preference))
        except BaseException:
            self.close()
            raise
        self.num_shards = self.layout.num_shards
        self.worker_id = self._clients[0].worker_id
        self.num_workers = self._clients[0].num_workers
        self._shard_wids = [c.worker_id for c in self._clients]
        self._channel = _ShardChannel(self)
        # directory: global view (layout params + shard-0 extras such as
        # num_workers / is_pipelined, which the proxies' shaping needs)
        self.directory: List[Dict[str, Any]] = []
        for entry in self.layout.tables:
            table_id = int(entry["table_id"])
            base = next((dict(s) for s in self._clients[0].directory
                         if int(s["table_id"]) == table_id), {})
            base.pop("row_offset", None)
            base.update({k: v for k, v in entry["params"].items()})
            base["table_id"] = table_id
            base["kind"] = entry["kind"]
            self.directory.append(base)

    # -- routing -------------------------------------------------------------
    def _rewrite_option(self, wids: List[int], shard: int,
                        option: Any) -> Any:
        """Default-stamped envelopes (worker_id == this router's
        representative id) are re-stamped with the shard-local worker id;
        explicit/admin envelopes pass through untouched. ``wids`` is the
        attempt's shard-worker-id snapshot (a concurrent layout refresh
        must not shift indices mid-split)."""
        if (isinstance(option, (AddOption, GetOption))
                and option.worker_id == self.worker_id
                and wids[shard] != self.worker_id):
            return dataclasses.replace(option, worker_id=wids[shard])
        return option

    def _table_efs(self, table_id: int, entry: Dict[str, Any], part,
                   version: int) -> Optional[List[Any]]:
        """Lazily built per-shard residual slices (full-table float32 —
        only allocate for tables that actually Add). Keyed by layout
        generation: a migration changes the partitioner, so stale slices
        must never compress a new-generation split."""
        key = (int(table_id), int(version))
        with self._ef_lock:
            if key not in self._efs:
                self._efs[key] = make_shard_error_feedback(
                    entry["kind"], entry["params"], part,
                    int(config.get_flag("wire_quant_bits")))
            return self._efs[key]

    def _route(self, table_id: int, msg_type: MsgType, request: Any,
               completion) -> None:
        self._route_attempt(table_id, msg_type, request, completion, 0)

    def _route_attempt(self, table_id: int, msg_type: MsgType, request: Any,
                       completion, attempt: int) -> None:
        with self._state_lock:  # one consistent snapshot per attempt
            layout = self.layout
            clients = self._clients
            wids = self._shard_wids
        version = layout.layout_version
        entry = layout.entry(table_id)
        part = layout.partitioner(table_id)
        efs = (self._table_efs(table_id, entry, part, version)
               if msg_type == MsgType.Request_Add else None)
        if efs is not None:
            request = dedup_add_ids(entry["kind"], request)
        rewrite = lambda s, o: self._rewrite_option(wids, s, o)  # noqa: E731
        parts, merge = split_request(entry["kind"], part, msg_type, request,
                                     entry["params"],
                                     rewrite_option=rewrite)
        plain_parts = parts  # pre-quantization, for WrongShard re-issue
        if efs is not None and parts:
            # residual state mutates per compress: serialize against
            # concurrent Adds to the same table
            with self._ef_lock:
                parts = quantize_split_parts(entry["kind"], efs, parts)
        if completion is None:
            for shard, sub in parts:
                clients[shard]._send(table_id, msg_type, sub,
                                     next_msg_id(), None,
                                     watermark=version)
            return
        if not parts:
            completion.done(_empty_reply(entry["kind"], msg_type, request,
                                         entry["params"]))
            return
        count("ROUTER_FANOUT", len(parts))
        retry = None
        if attempt < _MAX_REROUTES:
            retry = self._migration_retry(table_id, msg_type, request,
                                          completion, attempt, entry, part,
                                          wids, plain_parts)
        mc = _MergeCompletion(completion, len(parts), merge, retry=retry)
        for idx, (shard, sub) in enumerate(parts):
            rid = clients[shard]._send(table_id, msg_type, sub,
                                       next_msg_id(),
                                       mc.part(idx, shard),
                                       watermark=version)
            # _send returns the per-shard span id (0 untraced): tag which
            # shard this leg targeted so a stitched trace shows the fan
            hop(rid, f"router_shard{shard}")
            tag_tenant(rid, resolve_tenant(table_id))

    def _migration_retry(self, table_id: int, msg_type: MsgType,
                         request: Any, completion, attempt: int,
                         entry: Dict[str, Any], part, wids: List[int],
                         plain_parts: List[Tuple[int, Any]]):
        """Build the _MergeCompletion retry hook for one fan-out attempt.

        Re-route contract (docs/sharding.md): a ``Reply_WrongShard``
        PROVES the part was not applied (the server consults its dedup
        window before the layout fence), so an Add re-issues exactly the
        refused parts — globalized back through the attempt's partitioner
        and re-split under the refreshed layout — while the applied parts
        stand; re-sending those would double-apply. A Get is idempotent,
        so any refusal or connection loss simply aborts the merge and
        re-runs the WHOLE request against the new layout. Refresh + dial
        happen on a short-lived daemon thread, never on the per-shard
        pump thread that delivered the refusal.
        """
        from multiverso_tpu_torch.runtime.remote import WrongShardError

        def handler(mc, idx, shard, error):
            wrong = isinstance(error, WrongShardError)
            idempotent = msg_type in (MsgType.Request_Get,
                                      MsgType.Request_Query)
            if not wrong and not (idempotent
                                  and isinstance(error, ConnectionError)):
                return None
            manifest = error.manifest if wrong else None
            count("ROUTER_REROUTES")
            if idempotent:
                def rerun():
                    try:
                        self.refresh_layout(manifest)
                        self._route_attempt(table_id, msg_type, request,
                                            completion, attempt + 1)
                    except BaseException as exc:  # noqa: BLE001
                        completion.fail(exc)
                threading.Thread(target=rerun, daemon=True,
                                 name="mv-router-reroute").start()
                return "superseded"
            sub = plain_parts[idx][1]

            class _Relay:  # settles the original merge slot
                def done(_self, result):  # noqa: N805
                    mc._part_done(idx, None)

                def fail(_self, err):  # noqa: N805
                    mc._force_fail(err)

            def rerun():
                try:
                    self.refresh_layout(manifest)
                    g = globalize_add(entry["kind"], sub, part, shard)
                    # undo the OLD shard's option re-stamp so the next
                    # attempt re-stamps for whichever shard now owns it
                    opt = g[-1]
                    if (isinstance(opt, (AddOption, GetOption))
                            and opt.worker_id == wids[shard]):
                        opt = dataclasses.replace(
                            opt, worker_id=self.worker_id)
                    self._route_attempt(table_id, msg_type,
                                        g[:-1] + (opt,), _Relay(),
                                        attempt + 1)
                except BaseException as exc:  # noqa: BLE001
                    mc._force_fail(exc)
            threading.Thread(target=rerun, daemon=True,
                             name="mv-router-reroute").start()
            return "reissued"
        return handler

    # -- layout refresh ------------------------------------------------------
    def refresh_layout(self, manifest: Optional[Any] = None,
                       dial_timeout: Optional[float] = None) -> bool:
        """Adopt a newer layout; returns True if one was installed.

        ``manifest`` usually rides in on a ``Reply_WrongShard`` refusal;
        when None (connection loss — no refusal to learn from), the
        current members are polled for whatever layout is published.
        Per-shard clients for endpoints still in the layout are REUSED
        (their worker slots, updater state and dedup windows survive);
        clients for endpoints that left are retired — kept open, since
        their pumps may still be delivering refusals for in-flight
        requests — and closed at :meth:`close`.
        """
        with self._refresh_lock:
            fresh = None
            if manifest is not None:
                cand = (manifest if isinstance(manifest, ShardLayout)
                        else ShardLayout(manifest))
                if cand.layout_version > self.layout.layout_version:
                    fresh = cand
            else:
                for ep in list(self.layout.endpoints):
                    try:
                        cand = fetch_layout(ep, timeout=2.0)
                    except (OSError, RuntimeError):
                        continue
                    if cand.layout_version > self.layout.layout_version:
                        fresh = cand
                    break
            if fresh is None:
                return False
            self._install_layout(fresh, dial_timeout)
            return True

    def _install_layout(self, fresh: ShardLayout,
                        dial_timeout: Optional[float]) -> None:
        """Swap in ``fresh`` (caller holds ``_refresh_lock``). New
        endpoints dial with retry/backoff: a WrongShard refusal races the
        migration's recipient binding its port, so first dials may be
        refused for a moment."""
        from multiverso_tpu_torch.runtime.remote import RemoteClient
        current = dict(zip(self.layout.endpoints, self._clients))
        deadline = time.monotonic() + float(
            dial_timeout if dial_timeout is not None
            else config.get_flag("reconnect_deadline_seconds"))
        clients: List[Any] = []
        fresh_clients: List[Any] = []
        try:
            for shard, ep in enumerate(fresh.endpoints):
                client = current.pop(ep, None)
                if client is None:
                    bo = Backoff(base=0.05, cap=1.0, deadline=deadline)
                    while True:
                        try:
                            client = RemoteClient(
                                ep, timeout=self._timeout,
                                read_endpoints=fresh.replicas[shard],
                                read_preference=self._read_pref)
                            break
                        except OSError:
                            if not bo.wait():
                                raise
                    fresh_clients.append(client)
                clients.append(client)
        except BaseException:
            for c in fresh_clients:
                try:
                    c.close()
                except Exception:  # noqa: BLE001
                    pass
            raise
        with self._state_lock:
            self._retired.extend(current.values())
            self._clients = clients
            self.layout = fresh
            self.num_shards = fresh.num_shards
            # self.worker_id stays STABLE: it is the sentinel proxies
            # stamp into default option envelopes (_rewrite_option)
            self._shard_wids = [c.worker_id for c in clients]
        with self._ef_lock:
            self._efs.clear()
        # flush the read tier: rows that changed owner must not serve
        # from a replica snapshot keyed to the old layout
        for entry in fresh.tables:
            for c in clients:
                rr = getattr(c, "_read_router", None)
                if rr is not None:
                    try:
                        rr.note_local_write(int(entry["table_id"]))
                    except Exception:  # noqa: BLE001
                        pass
        count("ROUTER_LAYOUT_REFRESHES")
        log.info("router: adopted layout v%d (%d shards)",
                 fresh.layout_version, fresh.num_shards)

    def _post_all(self, table_id: int, msg_type: MsgType) -> None:
        """Fire-and-forget control posts (finish_train) fan to every
        shard: each shard's clocks retire this worker independently."""
        for client in self._clients:
            client._send(table_id, msg_type, None, next_msg_id(), None)

    # -- table proxies ---------------------------------------------------------
    def table(self, table_id: int):
        """Worker proxy over the GLOBAL table shape; same shaping classes
        as RemoteClient's proxies, routed channel underneath."""
        from multiverso_tpu_torch.runtime import remote as remote_mod
        spec = next((s for s in self.directory
                     if int(s["table_id"]) == int(table_id)), None)
        if spec is None:
            raise KeyError(f"no sharded table with id {table_id}; "
                           f"layout tables: {self.directory}")
        kind = spec["kind"]
        builders = {"array": remote_mod._RemoteArrayWorker,
                    "matrix": remote_mod._RemoteMatrixWorker,
                    "kv": remote_mod._RemoteKVWorker,
                    "sparse": remote_mod._RemoteSparseWorker}
        if kind not in builders:
            raise KeyError(f"unknown sharded table kind {kind!r}")
        proxy = builders[kind](spec, int(table_id), self._channel)
        if getattr(proxy, "_ef", None) is not None:
            # the ROUTER owns quantization for sharded tables: it splits
            # the plain-float32 Add first, then compresses each sub-
            # request against that shard's residual slice (_route); a
            # proxy-level EF here would double-quantize and hand the
            # splitter an unsplittable payload
            proxy._ef = None
        return proxy

    def tables(self) -> List[Any]:
        return [self.table(s["table_id"]) for s in self.directory]

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        for client in list(self._clients) + list(self._retired):
            try:
                client.close()
            except Exception:  # noqa: BLE001 — best-effort fan-out close
                pass
