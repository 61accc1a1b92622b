"""MatrixTable — 2-D dense table with row-subset Get/Add and sparse
staleness tracking (port of ``multiverso_tpu/tables/matrix_table.py``).

* Server state is ONE ``(padded_rows, padded_cols)`` tensor on the runtime's
  device. Rows are padded to whole 16-byte vectors (``mesh.padded_cols``)
  and one sentinel row sits past ``num_row``; only the logical shape is
  ever visible.
* Row-id batches are padded to power-of-two buckets (at least
  ``ROW_GROUP``) aimed at the sentinel row, as in the JAX package.
* A row Add on a linear updater (default / sgd) merges duplicate ids on the
  host, then runs ONE in-place row scatter (``ops.rows.scatter_add_rows``:
  the CUDA kernel on the card, ``index_add_`` on the CPU). Stateful
  updaters gather, apply and write back rows with torch indexing.
* Every row Get — host, sparse and device-out — is ``ops.rows.gather_rows``.
* ``is_sparse`` staleness (``up_to_date``) is host-side numpy metadata.

Tables are updated in place (the JAX package donated its buffers), so any
reply that hands out table state is a copy.

Checkpoints (``store``/``load``) hold the logical ``num_row x num_col``
data and updater states only: neither the column padding nor the sentinel
row is checkpoint content, and ``load`` zeroes both again (the zero-delta
pads of every scatter aim at the sentinel row). ``load`` writes into the
existing tensors, so a registered program or a trainer's transaction that
closed over them sees the restored values.

``remote_spec`` gives remote clients the logical shape; the wire proxy is
``runtime/remote.py``'s ``_RemoteMatrixWorker``. Live migration
(``extract_range``/``absorb_range``) moves logical rows only: the
transfer is read to host memory, and the recipient writes it into its
existing tensor in place (the JAX table rebinds a fresh array).

In a multi-process lockstep world (``runtime/multihost.py``) each rank
holds rows ``[row_lo, row_hi)`` (``Zoo.row_range``) plus its own sentinel
row, and the updater state of those rows; the whole logical table exists
only as the ranks' union. Every rank replays the same requests: an Add
applies the rows this rank owns (ids made local, one scatter on its
shard, no collective); a Get gathers its owned rows with the gather
kernel and the ranks exchange them on the process group
(``MultihostRuntime.exchange_rows``), so the origin gets the whole reply;
whole-table reads and snapshots assemble the ranks' ranges; a restore
loads each rank's range. Callers still pad with ``sentinel_row`` (the
global ``num_row``); the shard's own sentinel is ``local_sentinel``. Device
IO is off (``supports_device_io`` False): the lockstep descriptors carry
host data. Live migration and queries refuse a sharded table.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import monitor
from multiverso_tpu_torch.ops.rows import ROW_GROUP, gather_rows, scatter_add_rows
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.programs import resolve_program
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.array_table import (_make_states,
                                                     _make_whole_update,
                                                     load_states)
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable
from multiverso_tpu_torch.updaters import (AddOption, GetOption, SGDUpdater,
                                           Updater, get_updater)
from multiverso_tpu_torch.utils import async_upload, next_pow2, torch_dtype


def merge_duplicate_rows(ids: np.ndarray, values: np.ndarray):
    """Pre-aggregate duplicate row ids: returns ``(unique_ids, summed_rows)``
    with the ids sorted, or the inputs unchanged when they are already
    unique. The row scatter kernel needs unique live ids, and a stateful
    updater must apply once per row. (Copied from
    ``multiverso_tpu/runtime/remote.py``.)

    Copies each unique id's FIRST row, then sums only the (few) genuinely
    duplicated groups — cheaper on row-matrix payloads than ``np.add.at``
    or ``np.add.reduceat``."""
    id_arr = np.asarray(ids)
    uniq, inverse, counts = np.unique(id_arr, return_inverse=True,
                                      return_counts=True)
    if len(uniq) == len(id_arr):
        return ids, values
    values = np.asarray(values)
    order = np.argsort(inverse, kind="stable")
    starts = np.cumsum(counts) - counts
    merged = values[order[starts]]  # fancy index: a fresh writable array
    for g in np.nonzero(counts > 1)[0]:
        s = starts[g]
        merged[g] = values[order[s:s + counts[g]]].sum(axis=0)
    return uniq.astype(id_arr.dtype, copy=False), merged


def _make_row_update(updater: Updater):
    """The stateful per-row update ``f(data, states, ids, delta, worker,
    scalars) -> (data, states)``: gather the rows and the acting worker's
    state rows, apply, and write both back in place. ``ids`` are unique
    apart from sentinel pads with zero deltas."""

    def f(data, states, ids, delta, worker, scalars):
        w = worker if updater.per_worker_state else 0
        idx = ids.long()
        rows = data[idx]
        sliced = {k: v[w, idx] for k, v in states.items()}
        new_rows, new_sliced = updater.apply(rows, sliced, delta, scalars)
        data[idx] = new_rows
        for k in states:
            states[k][w, idx] = new_sliced[k]
        return data, states

    return f


# ``init_range`` draws: rows per block (about 4M values, so a rank's
# transient draw stays one block whatever the table's size) and each
# block's seed. Block 0 keeps the table's own seed.
_INIT_BLOCK_VALUES = 1 << 22


def _init_block_rows(num_col: int) -> int:
    return max(1, _INIT_BLOCK_VALUES // max(1, int(num_col)))


def _init_block_seed(seed: int, block: int) -> int:
    if block == 0:
        return seed
    return int(np.random.SeedSequence([seed, block]).generate_state(
        1, np.uint64)[0] >> 1)


def draw_range_rows(out: torch.Tensor, row_lo: int, num_row: int,
                    init_range: Tuple[float, float], seed: int) -> None:
    """Fill ``out`` with rows ``[row_lo, row_lo + len(out))`` of a
    ``num_row``-row table drawn uniform in ``init_range`` from ``seed``.
    Only the blocks that meet those rows are drawn, one at a time."""
    row_hi, num_col = row_lo + out.shape[0], out.shape[1]
    draw_dtype = out.dtype if out.dtype.is_floating_point else torch.float32
    block = _init_block_rows(num_col)
    for start in range(row_lo - row_lo % block, row_hi, block):
        stop = min(start + block, num_row)
        gen = torch.Generator(device=out.device)
        gen.manual_seed(_init_block_seed(seed, start // block))
        draws = torch.empty((stop - start, num_col), dtype=draw_dtype,
                            device=out.device).uniform_(*init_range,
                                                        generator=gen)
        lo, hi = max(start, row_lo), min(stop, row_hi)
        out[lo - row_lo: hi - row_lo] = draws[lo - start: hi - start].to(
            out.dtype)


class MatrixServer(ServerTable):
    def __init__(self, num_row: int, num_col: int, dtype: Any = np.float32,
                 updater_type: str = "", num_workers: Optional[int] = None,
                 init_value: Optional[np.ndarray] = None,
                 init_range: Optional[Tuple[float, float]] = None,
                 seed: int = 0, is_sparse: bool = False,
                 is_pipelined: Optional[bool] = None) -> None:
        super().__init__()
        zoo = Zoo.instance()
        self.num_row = int(num_row)
        self.num_col = int(num_col)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.num_workers = num_workers if num_workers is not None else zoo.num_workers
        # this rank's rows [row_lo, row_hi) of the logical table (all of
        # them in one process) and the world's ranges; multihost: None in
        # one process
        self.multihost = zoo.multihost
        self.row_lo, self.row_hi = zoo.row_range(self.num_row)
        self.row_ranges = mesh_lib.shard_ranges(self.num_row, zoo.size)
        self.local_rows = self.row_hi - self.row_lo
        # one scratch row past the shard's rows: padded id buckets aim
        # there. Callers pad with the global sentinel_row (num_row)
        self.padded_rows = self.local_rows + 1
        self.sentinel_row = self.num_row
        self.local_sentinel = self.local_rows
        self.padded_cols = mesh_lib.padded_cols(self.num_col, self.dtype)

        self.data = torch.zeros((self.padded_rows, self.padded_cols),
                                dtype=self.torch_dtype, device=self.device)
        mine = slice(self.row_lo, self.row_hi)
        if init_value is not None:
            init = np.asarray(init_value, dtype=self.dtype).reshape(
                self.num_row, self.num_col)[mine]
            self.data[: self.local_rows, : self.num_col] = torch.from_numpy(
                np.ascontiguousarray(init)).to(self.device)
        elif init_range is not None:
            # random-init server ctor overload (reference: matrix_table.cpp:
            # 372-384), drawn on the device — not the JAX package's numpy
            # draws. Drawn in blocks of rows, each from its own seed, so a
            # rank draws only the blocks that meet its rows and every rank's
            # range holds the values one process would
            draw_range_rows(self.data[: self.local_rows, : self.num_col],
                            self.row_lo, self.num_row, init_range, int(seed))

        self.updater = get_updater(self.dtype, updater_type)
        self.states = _make_states(self.updater,
                                   (self.padded_rows, self.padded_cols),
                                   self.torch_dtype, self.num_workers,
                                   self.device)

        # staleness metadata (gen-2 `up_to_date_`): host-side control plane.
        # is_pipelined doubles the planes (reference matrix.cpp:407-418):
        # each worker owns TWO staleness identities — worker_id and
        # worker_id + num_workers — which its double-buffered client
        # alternates between.
        self.is_sparse = bool(is_sparse)
        if is_pipelined is None:
            is_pipelined = bool(config.get_flag("is_pipelined"))
        self.is_pipelined = bool(is_pipelined)
        if self.is_sparse:
            self.num_slots = self.num_workers * (2 if self.is_pipelined else 1)
            self._up_to_date = np.zeros((self.num_slots, self.num_row), dtype=bool)
            self._std_lock = threading.Lock()

        self._whole_update = _make_whole_update(self.updater)
        self._linear = type(self.updater) in (Updater, SGDUpdater)
        self._negate = isinstance(self.updater, SGDUpdater)
        self._row_update = _make_row_update(self.updater)

    # -- row sharding (multi-process worlds) -------------------------------
    def own_rows(self, ids: np.ndarray) -> Tuple[Optional[np.ndarray],
                                                  np.ndarray]:
        """``(pos, local_ids)``: the positions in ``ids`` of the rows this
        rank holds and their shard-local ids. In one process every row is
        local: ``(None, ids)``. Sentinel pads (``num_row``) are owned by
        nobody."""
        if self.multihost is None:
            return None, ids
        ids = np.asarray(ids)
        pos = np.nonzero((ids >= self.row_lo) & (ids < self.row_hi))[0]
        return pos, (ids[pos] - self.row_lo).astype(np.int32)

    def row_owner(self, ids: np.ndarray) -> np.ndarray:
        """The rank holding each logical row id."""
        starts = np.asarray([lo for lo, _ in self.row_ranges])
        return (np.searchsorted(starts, np.asarray(ids), side="right")
                - 1).astype(np.int64)

    def rows_host(self, ids: np.ndarray) -> np.ndarray:
        """Logical rows ``ids`` as a host ``(n, num_col)`` array. Sharded:
        each rank gathers the rows it holds (the gather kernel) and the
        ranks exchange them — collective, so on the lockstep stream
        only."""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        pos, local = self.own_rows(ids)
        if pos is None or len(local):
            ids_p, _, n = self._bucket_ids(local, None)
            mine = self._host_read(gather_rows(self.data, ids_p)[:n, : self.num_col])
        else:
            mine = np.zeros((0, self.num_col), self.dtype)
        if pos is None:
            return mine
        return self.multihost.exchange_rows(self.row_owner(ids), mine)

    def logical_host(self, arr: torch.Tensor, axis: int = 0) -> np.ndarray:
        """Host copy of a row-shaped device tensor's logical block (rows
        ``[0, local_rows)`` along ``axis``, logical columns last),
        assembled across the ranks when sharded (collective)."""
        index = [slice(None)] * arr.dim()
        index[axis] = slice(0, self.local_rows)
        index[-1] = slice(0, self.num_col)
        local = self._host_read(arr[tuple(index)])
        if self.multihost is None:
            return local
        return self.multihost.assemble(local, self.row_ranges, axis=axis)

    def candidate_rows(self, ids: np.ndarray) -> torch.Tensor:
        """A ``(len(ids), padded_cols)`` device tensor of logical rows
        ``ids`` for a transaction's compact space; sentinel pads
        (``num_row``) read as zero rows, as the sentinel row does.
        Sharded: the ranks' held rows, exchanged (collective)."""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        live = np.nonzero(ids < self.num_row)[0]
        host = np.zeros((len(ids), self.padded_cols), self.dtype)
        host[live, : self.num_col] = self.rows_host(ids[live])
        return async_upload(host, self.device)

    def owned_push(self, ids: np.ndarray, delta: torch.Tensor
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """This rank's share of a transaction's push on a row-split table:
        the rows of the logical ``ids`` (unique apart from sentinel pads)
        it holds, as shard-local ids bucketed to a power of two with the
        shard's sentinel, and their ``delta`` rows with zero pads.
        ``(None, None)`` when it holds none of them."""
        pos, local = self.own_rows(np.asarray(ids).reshape(-1))
        if not len(local):
            return None, None
        ids_p, _, n = self._bucket_ids(local, None)
        out = torch.zeros((ids_p.shape[0], delta.shape[1]), dtype=delta.dtype,
                          device=delta.device)
        out[:n] = delta[torch.as_tensor(pos, device=delta.device)]
        return ids_p, out

    def _refuse_sharded(self, what: str) -> None:
        if self.multihost is not None:
            log.fatal("Matrix.%s is unsupported on a table whose rows are "
                      "split over a multi-process world", what)

    def _signed(self, delta: torch.Tensor) -> torch.Tensor:
        """A linear updater's delta as the row scatter adds it."""
        return -delta if self._negate else delta

    def row_apply_traceable(self):
        """The per-row update as a function ``(data, states, ids, delta,
        worker, scalars) -> (data, states)`` for a caller's device
        transaction. Same semantics as the add path: a linear updater is
        one in-place row scatter (sign folded in), a stateful updater the
        row update. ``ids`` must be unique apart from sentinel pads with
        zero deltas."""
        if self._linear:
            def apply_linear(data, states, ids, delta, worker, scalars):
                return scatter_add_rows(data, ids, self._signed(delta)), states

            return apply_linear
        return self._row_update

    # -- helpers -----------------------------------------------------------
    def _bucket_ids(self, ids: np.ndarray, values: Optional[np.ndarray],
                    ensure_pad: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
        """Pad (shard-local ids, values) to a power-of-two bucket aimed at
        the shard's sentinel row and upload them. ``ensure_pad`` keeps at
        least one sentinel slot (device-out gets hand the bucket to the
        caller as a compact training space whose masked ops need a
        non-live row)."""
        n = len(ids)
        bucket = max(next_pow2(n + 1 if ensure_pad else n), ROW_GROUP)
        ids_p = np.full(bucket, self.local_sentinel, dtype=np.int32)
        ids_p[:n] = ids
        vals_p = None
        if values is not None:
            padded = np.zeros((bucket, self.padded_cols), dtype=self.dtype)
            padded[:n, : self.num_col] = values
            vals_p = async_upload(padded, self.device)
        return async_upload(ids_p, self.device), vals_p, n

    # -- server ops --------------------------------------------------------
    def merge_add_requests(self, requests):
        """Fuse queued host row-Adds into ONE row scatter: concatenate
        (ids, values) across the group and hand back one request;
        ``process_add`` then merges duplicate rows. Linear updaters only — a
        stateful updater applied once to a summed delta is a different
        operator than N sequential applies. Whole-table, device-resident and
        transaction forms stop the scan. ``apply_batch_rows`` bounds the
        fused row count so the id bucket cannot blow up under backlog."""
        if not self._linear:
            return None
        rows_cap = int(config.get_flag("apply_batch_rows"))
        ids_list, vals_list = [], []
        total = 0
        for request in requests:
            if not (isinstance(request, tuple) and len(request) == 3):
                break
            row_ids, values, _option = request
            if row_ids is None or isinstance(values, torch.Tensor):
                break
            row_ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
            values = np.asarray(values, dtype=self.dtype).reshape(
                -1, self.num_col)
            if len(row_ids) != len(values):
                break  # per-message path reports the real error
            if ids_list and rows_cap > 0 and total + len(row_ids) > rows_cap:
                break
            ids_list.append(row_ids)
            vals_list.append(values)
            total += len(row_ids)
        if not ids_list:
            return None
        ids = np.concatenate(ids_list)
        return ((ids, np.concatenate(vals_list), requests[0][2]),
                int(len(ids)), len(ids_list))

    def process_add(self, request):
        if isinstance(request[0], str):
            if request[0] == "transact":
                return self._process_transact(request)
            if request[0] == "transact_named":
                return self._process_transact(self._resolve_named(request))
            log.fatal("Matrix.add: the %r request form is not yet ported",
                      request[0])
        row_ids, values, option = request
        option = option or AddOption()
        worker, scalars = self._option_consts(option)
        if isinstance(values, torch.Tensor):
            # device add: the delta never touches the host. Caller contract:
            # ids unique; pad slots aim at sentinel_row with zero deltas.
            self._process_add_device(row_ids, values, worker, scalars)
            return
        if row_ids is None:
            host = np.asarray(values, dtype=self.dtype).reshape(
                self.num_row, self.num_col)
            delta = np.zeros((self.padded_rows, self.padded_cols), dtype=self.dtype)
            delta[: self.local_rows, : self.num_col] = host[self.row_lo:self.row_hi]
            self._whole_update(self.data, self.states,
                               async_upload(delta, self.device), worker, scalars)
            touched: Optional[np.ndarray] = None
        else:
            # host rows, timed in three sections: the merge, the staging
            # (bucket, pinned copy, upload issue) and the scatter's issue
            with monitor("MATRIX_ADD_MERGE"):
                row_ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
                self._check_row_range(row_ids, "add")
                values = np.asarray(values, dtype=self.dtype).reshape(-1, self.num_col)
                if len(row_ids) != len(values):
                    log.fatal("Matrix.add: %d ids but %d value rows", len(row_ids), len(values))
                # unique ids on every path: the row scatter kernel needs them
                # and a stateful updater applies once per row. Merging on the
                # CPU as well keeps the tests on the host code the card runs.
                row_ids, values = merge_duplicate_rows(row_ids, values)
                pos, local = self.own_rows(row_ids)
                if pos is not None:
                    values = values[pos]  # this rank's rows; the rest are peers'
            if pos is None or len(local):
                with monitor("MATRIX_ADD_STAGE"):
                    ids_p, vals_p, _ = self._bucket_ids(local, values)
                with monitor("MATRIX_ADD_SCATTER"):
                    if self._linear:
                        scatter_add_rows(self.data, ids_p, self._signed(vals_p))
                    else:
                        self._row_update(self.data, self.states, ids_p, vals_p,
                                         worker, scalars)
            touched = row_ids
        if self.is_sparse:
            with self._std_lock:
                if touched is None:
                    self._up_to_date[:, :] = False
                else:
                    self._up_to_date[:, touched] = False

    def _process_add_device(self, row_ids, values: torch.Tensor, worker,
                            scalars) -> None:
        row_ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
        n = len(row_ids)
        if values.dim() != 2 or values.shape[0] != n or values.shape[1] > self.padded_cols:
            log.fatal("Matrix.add(device): %d ids but values of shape %s",
                      n, tuple(values.shape))
        if row_ids.size and (int(row_ids.min()) < 0
                             or int(row_ids.max()) > self.sentinel_row):
            log.fatal("Matrix.add(device): row id out of range [0, %d]",
                      self.sentinel_row)
        self._refuse_sharded("add(device)")
        bucket = max(next_pow2(n), ROW_GROUP)
        ids_p = np.full(bucket, self.local_sentinel, dtype=np.int32)
        ids_p[:n] = row_ids
        vals_p = torch.zeros((bucket, self.padded_cols), dtype=self.torch_dtype,
                             device=self.device)
        vals_p[:n, : values.shape[1]] = values.to(self.device, self.torch_dtype)
        ids_p = async_upload(ids_p, self.device)
        if self._linear:
            scatter_add_rows(self.data, ids_p, self._signed(vals_p))
        else:
            self._row_update(self.data, self.states, ids_p, vals_p, worker,
                             scalars)
        if self.is_sparse:
            with self._std_lock:
                live = row_ids[row_ids < self.num_row]
                self._up_to_date[:, live] = False

    def _check_row_range(self, row_ids: np.ndarray, op: str) -> None:
        """Host-path ids must be in [0, num_row). Worker proxies already
        guard this, so only a routing bug reaches here — and it must die
        loudly instead of misdirecting rows."""
        if row_ids.size and (int(row_ids.min()) < 0
                             or int(row_ids.max()) >= self.num_row):
            log.fatal("Matrix.%s: row id out of range [0, %d) (offset %d "
                      "of the global table) — sharded routers must send "
                      "shard-local ids", op, self.num_row, self.row_offset)

    def _resolve_named(self, request):
        """Rehydrate a named transaction descriptor into the live form:
        the program name resolves to this process's registered function,
        the table ids to its server tables (``runtime/programs.py``)."""
        _, name, other_ids, args, touched = request
        server = Zoo.instance().server
        # the other tables are state holders here, not dispatch points: a
        # leader's lockstep wrapper is peeled off (its descriptor is this
        # table's)
        others = [server.table(tid)._unwrapped() for tid in other_ids]
        return ("transact", resolve_program(name), others, args, touched)

    def _process_transact(self, request):
        """Device transaction: ONE dispatcher op that reads several tables'
        device state, runs a caller-built function over all of it, and
        writes the results back (serialized with all other table traffic).

        request = ("transact", fn, other_servers, args, touched):
        ``fn(datas, states, *args) -> (new_datas, new_states, extra)`` over
        lists ordered [this table, *other_servers]; ``fn`` may update the
        tensors in place and return them. ``extra`` is the reply (stays on
        the device). ``touched`` (per-table id arrays or None) drives
        sparse-staleness invalidation."""
        _, fn, others, args, touched = request
        tables = [self] + list(others)
        datas = [t.data for t in tables]
        states = [t.states for t in tables]
        with monitor("SERVER_PROCESS_TRANSACT"):
            out = fn(datas, states, *args)
        try:
            new_datas, new_states, extra = out
            if (len(new_datas) != len(tables)
                    or len(new_states) != len(tables)):
                raise ValueError("result lists do not match table count")
        except (TypeError, ValueError) as exc:
            log.fatal("transact fn must return (new_datas, new_states, "
                      "extra) matching the %d-table list (%s); an in-place "
                      "fn may already have changed the tables", len(tables), exc)
        for t, d, s in zip(tables, new_datas, new_states):
            t.data, t.states = d, s
        for t, ids in zip(tables, touched or [None] * len(tables)):
            if getattr(t, "is_sparse", False) and ids is not None:
                with t._std_lock:
                    live = ids[ids < t.num_row]
                    t._up_to_date[:, live] = False
        return extra

    def _is_worker(self, option) -> bool:
        """Administrative access (worker id outside [0, num_slots)) must not
        touch any worker's staleness bitmap. num_slots covers the pipelined
        second plane (worker_id + num_workers)."""
        return option is not None and 0 <= option.worker_id < self.num_slots

    def process_get(self, request):
        device_out = False
        if len(request) == 3:  # in-process device-out form
            row_ids, option, device_out = request
        else:
            row_ids, option = request
        if row_ids is None:
            if self.is_sparse and self._is_worker(option):
                return self._sparse_get(option)
            # admin whole-table reads take the dense path
            return self.logical_host(self.updater.access(self.data))
        row_ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
        if not device_out:
            # device gets may carry sentinel-aimed pad ids (the compact
            # training space contract); host gets may not
            self._check_row_range(row_ids, "get")
        if self.multihost is not None:
            if device_out:
                self._refuse_sharded("get(device)")
            rows = self.rows_host(row_ids)
            if self.is_sparse and self._is_worker(option):
                with self._std_lock:
                    self._up_to_date[option.worker_id, row_ids] = True
            return rows
        ids_p, _, n = self._bucket_ids(row_ids, None, ensure_pad=device_out)
        gathered = gather_rows(self.data, ids_p)
        if self.is_sparse and self._is_worker(option):
            with self._std_lock:
                self._up_to_date[option.worker_id, row_ids] = True
        if device_out:
            # rows stay on the device: (bucket, padded_cols), slots >= n are
            # sentinel copies — the caller's compact training space
            return gathered
        return self._host_read(gathered[:n, : self.num_col])

    def _sparse_get(self, option: GetOption):
        """Return only the rows stale for this worker: (ids, rows)."""
        w = option.worker_id
        with self._std_lock:
            stale = np.where(~self._up_to_date[w])[0].astype(np.int32)
            self._up_to_date[w, stale] = True
        if len(stale) == 0:
            return stale, np.zeros((0, self.num_col), dtype=self.dtype)
        if len(stale) == self.num_row:
            return stale, self.logical_host(self.data)
        return stale, self.rows_host(stale)

    def remote_spec(self):
        return {"kind": "matrix", "num_row": self.num_row,
                "num_col": self.num_col, "dtype": self.dtype.str,
                "is_sparse": self.is_sparse,
                "is_pipelined": self.is_pipelined,
                "num_workers": self.num_workers}

    # -- checkpoint --------------------------------------------------------
    def store(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import write_array, write_state_dict
        write_array(stream, self.logical_host(self.data))
        write_state_dict(stream, {
            name: self.logical_host(arr, axis=1)
            for name, arr in self.states.items()})

    def load(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import read_array, read_state_dict
        arr = read_array(stream)
        if arr.size != self.num_row * self.num_col:
            log.fatal("Matrix.load: %d values for a %d x %d table", arr.size,
                      self.num_row, self.num_col)
        self.data.zero_()  # the column pads and the sentinel row
        mine = slice(self.row_lo, self.row_hi)
        logical = arr.reshape(self.num_row, self.num_col)[mine]
        self.data[: self.local_rows, : self.num_col].copy_(
            torch.from_numpy(np.ascontiguousarray(
                logical.astype(self.dtype, copy=False))))
        states = {name: (got[:, mine] if got.ndim == 3
                         and got.shape[1] == self.num_row else got)
                  for name, got in read_state_dict(stream).items()}
        load_states(self.states, states, (self.local_rows, self.num_col))
        if self.is_sparse:
            # staleness is NOT restorable state: it certifies worker-side
            # client caches the snapshot does not cover — a restored
            # table must serve every row fresh once
            with self._std_lock:
                self._up_to_date[:, :] = False

    # -- live migration (shard/reshard.py) ---------------------------------
    def extract_range(self, lo: int, hi: int) -> np.ndarray:
        """Raw values of shard-local rows [lo, hi), logical columns only,
        read to a host copy — the migration transfer unit. The sentinel
        row and the column pads never travel. Updater state is excluded:
        the recipient's starts at zero (the reference's documented reset,
        like a v1 checkpoint restore)."""
        self._refuse_sharded("extract_range")
        return self._host_read(self.data[int(lo):int(hi), : self.num_col])

    def absorb_range(self, start: int, values) -> None:
        """Write raw rows at [start, start+len) into the existing tensor,
        in place — the recipient side of extract_range. Bypasses updaters:
        migrated values are state, not gradients."""
        self._refuse_sharded("absorb_range")
        values = np.asarray(values, dtype=self.dtype).reshape(-1, self.num_col)
        if not values.flags.writeable:  # a decoded wire buffer
            values = values.copy()
        n = values.shape[0]
        if start < 0 or start + n > self.num_row:
            log.fatal("absorb_range [%d, %d) outside [0, %d)",
                      start, start + n, self.num_row)
        self.data[start:start + n, : self.num_col].copy_(
            torch.from_numpy(values))
        if self.is_sparse:
            with self._std_lock:
                self._up_to_date[:, start:start + n] = False


class MatrixWorker(WorkerTable):
    """Client proxy for a 2-D table: whole or row-subset Get/Add; in sparse
    mode keeps a local row cache refreshed with only-stale-rows Gets."""

    # in-process proxies exchange device tensors with the dispatcher
    supports_device_io = True

    def __init__(self, num_row: int, num_col: int, dtype: Any = np.float32,
                 updater_type: str = "", init_value: Optional[np.ndarray] = None,
                 init_range: Optional[Tuple[float, float]] = None,
                 is_sparse: bool = False, seed: int = 0,
                 is_pipelined: Optional[bool] = None,
                 server: Optional[MatrixServer] = None) -> None:
        super().__init__()
        self.num_row = int(num_row)
        self.num_col = int(num_col)
        self.dtype = np.dtype(dtype)
        self.is_sparse = bool(is_sparse)
        self._server_table = server or MatrixServer(
            num_row, num_col, dtype, updater_type, init_value=init_value,
            init_range=init_range, seed=seed, is_sparse=is_sparse,
            is_pipelined=is_pipelined)
        self._register(self._server_table)
        if Zoo.instance().multihost is not None:
            # device IO exchanges tensors with the dispatcher; lockstep
            # descriptors must be host-serializable — host paths only
            self.supports_device_io = False
        self._init_client_state(self._server_table.is_pipelined
                                if self.is_sparse else False,
                                self._server_table.num_workers)

    def _init_client_state(self, pipelined: bool, num_workers: int) -> None:
        """Sparse-mode client caches: one per staleness plane. In pipelined
        mode whole-table Gets alternate planes so an in-flight prefetch and
        the next Get never consume each other's stale sets."""
        self._pipelined = bool(pipelined)
        self._num_workers = int(num_workers)
        self._n_phases = 2 if self._pipelined else 1
        self._caches = [np.zeros((self.num_row, self.num_col), self.dtype)
                        for _ in range(self._n_phases)] if self.is_sparse else []
        self._phase = 0
        self._phase_of: Dict[int, int] = {}  # msg_id -> phase (async gets)
        # rows actually fetched from the server by this proxy
        self.rows_pulled = 0

    # -- get ---------------------------------------------------------------
    def get(self, row_ids: Optional[np.ndarray] = None,
            option: Optional[GetOption] = None) -> np.ndarray:
        option, phase = self._prep_get_option(option, row_ids)
        raw = super().get((self._norm_ids(row_ids), option))
        return self._finish_get(raw, row_ids, phase)

    def get_async(self, row_ids: Optional[np.ndarray] = None,
                  option: Optional[GetOption] = None) -> int:
        option, phase = self._prep_get_option(option, row_ids)
        msg_id = super().get_async((self._norm_ids(row_ids), option))
        self._phase_of[msg_id] = phase
        return msg_id

    def wait_get(self, msg_id: int, row_ids: Optional[np.ndarray] = None) -> np.ndarray:
        phase = self._phase_of.pop(msg_id, 0)
        return self._finish_get(self.wait(msg_id), row_ids, phase)

    def _prep_get_option(self, option: Optional[GetOption],
                         row_ids) -> Tuple[GetOption, int]:
        """Default option + pipelined plane selection: whole-table sparse
        Gets alternate between the worker's two staleness identities
        (worker_id, worker_id + num_workers — reference matrix.cpp:407-418)."""
        phase = 0
        if option is None:
            wid = self._channel.worker_id()
            if (self.is_sparse and self._pipelined and row_ids is None
                    and 0 <= wid < self._num_workers):
                phase = self._phase
                self._phase = 1 - self._phase
                wid += phase * self._num_workers
            option = GetOption(worker_id=wid)
        return option, phase

    def _finish_get(self, raw, row_ids, phase: int = 0) -> np.ndarray:
        if self.is_sparse and row_ids is None and isinstance(raw, np.ndarray):
            # admin-bypass reply (worker id out of range): dense whole table,
            # no staleness bookkeeping — do not touch the client cache
            self.rows_pulled += self.num_row
            return raw
        if self.is_sparse and row_ids is None:
            stale_ids, rows = raw
            cache = self._caches[phase]
            if len(stale_ids):
                cache[stale_ids] = rows
            self.rows_pulled += len(stale_ids)
            return np.array(cache, copy=True)
        if row_ids is None:
            self.rows_pulled += self.num_row
            return raw
        ids = np.asarray(row_ids).reshape(-1)
        self.rows_pulled += len(ids)
        if self.is_sparse:
            # the server marked these rows fresh for this worker (plane 0) —
            # mirror them into the plane-0 cache
            self._caches[0][ids] = raw
        return raw

    # -- device IO (in-process workers only) --------------------------------
    # A worker sharing the process with the table exchanges DEVICE tensors
    # with the dispatcher: rows are gathered on the device and deltas
    # scattered from it, no host copy on either side. Not available on
    # is_sparse tables (their client cache is host-resident).

    def get_device_async(self, row_ids: np.ndarray,
                         option: Optional[GetOption] = None) -> int:
        """Async row pull that stays on the device. The reply (via
        ``wait_device``) is a new ``(bucket, padded_cols)`` tensor whose
        slots ``>= len(row_ids)`` are sentinel copies."""
        if self.is_sparse:
            log.fatal("device IO is not available on is_sparse tables")
        self._require_device_io()
        option, _ = self._prep_get_option(option, row_ids)
        return super().get_async((self._norm_ids(row_ids), option, True))

    def wait_device(self, msg_id: int, row_ids: np.ndarray) -> torch.Tensor:
        raw = self.wait(msg_id)
        self._phase_of.pop(msg_id, None)
        self.rows_pulled += len(np.asarray(row_ids).reshape(-1))
        return raw

    def add_device_async(self, values: torch.Tensor, row_ids: np.ndarray,
                         option: Optional[AddOption] = None) -> int:
        """Async device-resident add. ``values`` is a tensor of shape
        ``(len(row_ids), <=padded_cols)``; live ids unique, pad slots (if
        the caller pads) aim at ``num_row`` (the sentinel) with zero
        deltas."""
        if self.is_sparse:
            log.fatal("device IO is not available on is_sparse tables")
        self._require_device_io()
        option = self._default_add_option(option)
        return super().add_async(
            (np.asarray(row_ids, np.int32).reshape(-1), values, option))

    def transact_device_async(self, fn, others: Sequence["MatrixWorker"],
                              args: tuple = (),
                              touched: Optional[Sequence] = None) -> int:
        """Submit a multi-table device transaction (one dispatcher op):
        ``fn(datas, states, *args) -> (new_datas, new_states, extra)`` over
        the device state of ``[this table, *others]``, with ``extra`` as the
        (device) reply. ``fn`` may update the tensors in place and return
        them.

        ``fn`` may be a NAME registered with
        :func:`multiverso_tpu_torch.runtime.programs.register_program`: the
        request then carries the name and the tables' ids, and the
        dispatcher resolves both when it runs it.

        Plain async server only: round-gated or deferred servers keep
        per-table clocks that a cross-table transaction cannot honor."""
        if self.is_sparse:
            log.fatal("device IO is not available on is_sparse tables")
        named = isinstance(fn, str)
        if not named:
            self._require_device_io()  # closures are in-process only
        server = Zoo.instance().server
        if not (getattr(server, "plain_async", False)
                or (named and getattr(server, "supports_named_transact", False))):
            log.fatal("transact_device_async requires the plain async server")
        other_ids = []
        for o in others:
            st = getattr(o, "_server_table", None)
            if st is None:
                log.fatal("transact_device_async: %r is not an in-process "
                          "table", o)
            if getattr(o, "is_sparse", False) or getattr(st, "is_sparse", False):
                log.fatal("device IO is not available on is_sparse tables")
            other_ids.append((o.table_id, st))
        if named:
            return super().add_async(
                ("transact_named", fn, tuple(tid for tid, _ in other_ids),
                 tuple(args), touched))
        return super().add_async(("transact", fn, [st for _, st in other_ids],
                                  tuple(args), touched))

    @property
    def sentinel_row(self) -> int:
        return self._server_table.sentinel_row

    # -- add ---------------------------------------------------------------
    def _auto_sparse_rows(self, values, row_ids):
        """Worker-side nonzero-row auto-detect (reference matrix.cpp:148-182):
        a whole-table Add to a sparse table ships only the nonzero rows."""
        if row_ids is not None or not self.is_sparse:
            return row_ids, values
        values = np.asarray(values, dtype=self.dtype).reshape(
            self.num_row, self.num_col)
        nz = np.nonzero(values.any(axis=1))[0].astype(np.int32)
        if len(nz) == self.num_row:
            return None, values
        return nz, values[nz]

    def add(self, values: np.ndarray, row_ids: Optional[np.ndarray] = None,
            option: Optional[AddOption] = None) -> None:
        row_ids, values = self._auto_sparse_rows(values, row_ids)
        option = self._default_add_option(option)
        super().add((self._norm_ids(row_ids), values, option))

    def add_async(self, values: np.ndarray, row_ids: Optional[np.ndarray] = None,
                  option: Optional[AddOption] = None) -> int:
        row_ids, values = self._auto_sparse_rows(values, row_ids)
        option = self._default_add_option(option)
        return super().add_async((self._norm_ids(row_ids), values, option))

    # -- helpers -----------------------------------------------------------
    def _norm_ids(self, row_ids) -> Optional[np.ndarray]:
        if row_ids is None:
            return None
        ids = np.asarray(row_ids, dtype=np.int32).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_row):
            log.fatal("Matrix row id out of range [0, %d)", self.num_row)
        return ids

    def _default_add_option(self, option: Optional[AddOption]) -> AddOption:
        if option is None:
            option = AddOption()
            option.worker_id = self._channel.worker_id()
        return option

    def get_device(self) -> torch.Tensor:
        """A copy of the live device table (padding and sentinel row
        included). Not ordered with queued Adds."""
        self._require_device_io()
        return self._server_table.data.clone()
