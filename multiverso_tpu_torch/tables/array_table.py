"""ArrayTable — 1-D dense table (port of ``multiverso_tpu/tables/array_table.py``).

The quick-start table: whole-table Get/Add with the server-side updater
applied on the dispatcher thread. The table is ONE tensor on the runtime's
device; optimizer state tensors live beside it with a leading worker
dimension. Updates write into those tensors in place (where the JAX
package donated its buffers), so every reply that hands out table state is
a copy.

Checkpoints (``store``/``load``) write the data and the updater states at
the logical size, in the JAX package's format; ``load`` writes into the
existing tensors.

Whole-model sync (``ext/``'s device views): the leaf-list methods take a
model as a list of tensors whose sizes total the table's. Per leaf
signature the server keeps a codec: flatten (one ``torch.cat``) and split
(views of one flat tensor). The worker side does both, on its own thread:
a request carries flat tensors, a reply comes back flat and is split into
a :class:`LeafList`. The worker snapshots the caller's leaves into a
fresh flat tensor before it submits, because torch trains in place: a
queued request that held the caller's tensors would read whatever the next
step wrote into them (a deferred apply under the deterministic or BSP
server, a pipelined sync in flight). The request owns that snapshot, so
the dispatcher's share of a sync is the delta made in it, the update in
place (linear updaters), the merged value copied back into it and one
clone for the baseline: beside the table and the caller's own tensors a
sync holds two full-size tensors. Every reply is a fresh tensor set,
distinct from the table and from each other.

Live migration (``extract_range``/``absorb_range``): the transfer reads
the logical elements to host memory, and the recipient writes them into
its existing tensor in place (the JAX table rebinds a fresh array).

In a multi-process lockstep world (``runtime/multihost.py``) each rank
holds elements ``[lo, hi)`` (``Zoo.row_range``) and their updater state:
an Add applies the rank's slice of the replayed delta, a Get or snapshot
assembles the ranks' ranges on the process group, a restore loads each
rank's range. The device and leaf forms are off there
(``supports_device_io`` False): lockstep descriptors carry host data.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable
from multiverso_tpu_torch.updaters import (AddOption, GetOption, SGDUpdater,
                                           Updater, get_updater)
from multiverso_tpu_torch.utils import async_upload, torch_dtype


def _make_whole_update(updater: Updater):
    """One whole-table update closed over the updater:
    ``f(data, states, delta, worker, scalars) -> (data, states)``. It writes
    the updated values into ``data`` and the acting worker's state slices
    in place and returns the same tensors (the JAX version donated them)."""

    if type(updater) in (Updater, SGDUpdater):
        # linear and stateless: in place, with no full-size temporary
        # (the result is the same sum)
        sign = -1 if type(updater) is SGDUpdater else 1

        def linear(data, states, delta, worker, scalars):
            data.add_(delta, alpha=sign)
            return data, states

        return linear

    def f(data, states, delta, worker, scalars):
        w = worker if updater.per_worker_state else 0
        sliced = {k: v[w] for k, v in states.items()}
        new_data, new_sliced = updater.apply(data, sliced, delta, scalars)
        data.copy_(new_data)
        for k in states:
            states[k][w].copy_(new_sliced[k])
        return data, states

    return f


def _make_states(updater: Updater, shape, dtype: torch.dtype, num_workers: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    worker_dim = num_workers if updater.per_worker_state else 1
    return {name: torch.zeros((worker_dim,) + tuple(suffix), dtype=sdtype,
                              device=device)
            for name, (suffix, sdtype) in updater.state_spec(shape, dtype).items()}


class LeafList(list):
    """A model's leaves as views of ONE flat tensor, ``flat`` (padded to the
    table's padded size): what the leaf requests reply. Handed back as a
    baseline, ``flat`` goes out as it is; :meth:`clone` copies the whole
    set with one copy."""

    def __init__(self, flat: torch.Tensor, split: Callable) -> None:
        super().__init__(split(flat))
        self.flat, self._split = flat, split

    def clone(self) -> "LeafList":
        return LeafList(self.flat.clone(), self._split)


class ArrayServer(ServerTable):
    def __init__(self, size: int, dtype: Any = np.float32,
                 updater_type: str = "", num_workers: Optional[int] = None,
                 init_value: Optional[np.ndarray] = None) -> None:
        super().__init__()
        zoo = Zoo.instance()
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch_dtype(self.dtype)
        self.num_workers = num_workers if num_workers is not None else zoo.num_workers
        # this rank's elements [lo, hi) (all of them in one process)
        self.multihost = zoo.multihost
        self.lo, self.hi = zoo.row_range(self.size)
        self.ranges = mesh_lib.shard_ranges(self.size, zoo.size)
        self.local = self.hi - self.lo
        self.padded = self.local
        init = np.zeros(self.padded, dtype=self.dtype)
        if init_value is not None:
            init[: self.local] = np.asarray(
                init_value, dtype=self.dtype).reshape(-1)[self.lo:self.hi]
        self.data = torch.from_numpy(init).to(self.device)
        self.updater = get_updater(self.dtype, updater_type)
        self.states = _make_states(self.updater, (self.padded,),
                                   self.torch_dtype, self.num_workers,
                                   self.device)
        self._update = _make_whole_update(self.updater)
        # leaf signature -> (flatten, split), see leaf_codec
        self._codecs: Dict[tuple, Tuple[Callable, Callable]] = {}

    # -- server ops --------------------------------------------------------
    def merge_add_requests(self, requests):
        """Whole-array host deltas sum into ONE update — linear updaters
        only (a stateful updater applied once to a summed delta is a
        different operator than N sequential applies). The fused add+get
        form (3-tuple), the leaf-list forms and device-resident deltas
        refuse: their replies or payloads are per request."""
        if type(self.updater) not in (Updater, SGDUpdater):
            return None
        total = None
        consumed = 0
        for request in requests:
            if not (isinstance(request, tuple) and len(request) == 2):
                break
            delta, _option = request
            if delta is None or isinstance(delta, torch.Tensor):
                break
            arr = np.asarray(delta, dtype=self.dtype).reshape(-1)
            if arr.size != self.size:
                break  # per-message path reports the real error
            total = arr.astype(self.dtype, copy=True) if total is None \
                else total + arr
            consumed += 1
        if total is None:
            return None
        return (total, requests[0][1]), int(total.size), consumed

    def leaf_codec(self, leaves) -> Tuple[tuple, Callable, Callable]:
        """``(key, flatten, split)`` for a list-of-tensors signature.
        ``flatten`` casts each leaf to the table's dtype and device and
        returns ONE fresh flat tensor, padded to the table's padded size;
        ``split`` cuts a flat tensor's first ``size`` values into views of
        the leaves' shapes (cast back where a leaf's dtype differs). The
        worker side flattens and splits (``ArrayWorker``), so the
        dispatcher's share of a whole-model sync is a handful of tensor
        ops. A racing duplicate build is harmless."""
        key = tuple((tuple(x.shape), x.dtype) for x in leaves)
        codec = self._codecs.get(key)
        if codec is not None:
            return (key,) + codec
        shapes = [shape for shape, _ in key]
        dtypes = [dtype for _, dtype in key]
        sizes = [math.prod(shape) for shape in shapes]
        if sum(sizes) != self.size:
            log.fatal("leaf signature totals %d, table size %d",
                      sum(sizes), self.size)
        device, dtype, pad = self.device, self.torch_dtype, self.padded - self.size

        def flatten(ls) -> torch.Tensor:
            parts = [x.detach().reshape(-1).to(device, dtype) for x in ls]
            if pad or not parts:
                parts.append(torch.zeros(pad, dtype=dtype, device=device))
            return torch.cat(parts)

        def split(flat: torch.Tensor) -> List[torch.Tensor]:
            return [x.view(shape) if dt == dtype else x.view(shape).to(dt)
                    for x, shape, dt in zip(
                        torch.split(flat[: self.size], sizes), shapes, dtypes)]

        self._codecs[key] = (flatten, split)
        return key, flatten, split

    def process_add(self, request) -> Any:
        kind = request[0] if isinstance(request[0], str) else None
        if kind is not None:
            # whole-model requests, their tensors flat and padded:
            # ("leaves", delta, option, key) replies the merged value;
            # ("leaves_sync", new, last, option, key) applies new - last
            # and replies (merged, baseline), two distinct tensors (the
            # caller trains on merged in place and keeps baseline for its
            # next delta); ("leaves_push", new, last, option, key) applies
            # new - last and replies None (round-gated and deferred
            # servers: the caller follows with a gated Get)
            if kind not in ("leaves", "leaves_sync", "leaves_push"):
                log.fatal("ArrayTable: unknown request form %r", kind)
            self._refuse_sharded(kind)
            flats, option = request[1:-2], request[-2]
            for flat in flats:
                if flat.numel() != self.padded:
                    log.fatal("ArrayTable.%s: %d values, table padded size %d",
                              kind, flat.numel(), self.padded)
            # the request owns its first flat (the worker's snapshot): the
            # delta is made in it and the merged reply written into it, so
            # a sync holds the snapshot and the reply's baseline beside
            # the table, and no other full-size copy
            delta = flats[0] if kind == "leaves" else flats[0].sub_(flats[1])
            worker, scalars = self._option_consts(option or AddOption())
            self._update(self.data, self.states, delta, worker, scalars)
            if kind == "leaves_push":
                return None
            merged = delta.copy_(self.updater.access(self.data))
            return merged if kind == "leaves" else (merged, merged.clone())
        want_get = False
        if len(request) == 3:  # fused add+get (device sync path)
            delta, option, want_get = request
        else:
            delta, option = request
        option = option or AddOption()
        if isinstance(delta, torch.Tensor):
            self._refuse_sharded("add(device)")
            # device add: the delta never touches the host
            delta = delta.reshape(-1).to(self.device, self.torch_dtype)
            size = delta.numel()
        else:
            host = np.asarray(delta, dtype=self.dtype).reshape(-1)
            size = host.size
        if size != self.size:
            log.fatal("ArrayTable.add: delta size %d != table size %d",
                      size, self.size)
        if not isinstance(delta, torch.Tensor):
            # a copy: caller may reuse host. This rank's slice only
            delta = async_upload(np.ascontiguousarray(host[self.lo:self.hi]),
                                 self.device)
        worker, scalars = self._option_consts(option)
        self._update(self.data, self.states, delta, worker, scalars)
        if want_get:
            self._refuse_sharded("add+get(device)")
            # fused reply: the post-add global value, still on the device
            return self._device_value()
        return None

    def _device_value(self) -> torch.Tensor:
        """A copy: the next Add updates ``self.data`` in place."""
        return self.updater.access(self.data)[: self.size].clone()

    def process_get(self, request) -> Any:
        if isinstance(request, tuple) and isinstance(request[0], str):
            # ("leaves", option, key): the whole padded value, split into
            # the leaves on the worker side
            self._refuse_sharded("get(leaves)")
            return self.updater.access(self.data).clone()
        if isinstance(request, tuple):  # in-process device-out form
            _option, device_out = request
            if device_out:
                self._refuse_sharded("get(device)")
                return self._device_value()
        return self.logical_host(self.updater.access(self.data))

    def logical_host(self, arr: torch.Tensor) -> np.ndarray:
        """Host copy of an element-shaped tensor's logical part (last
        axis), assembled across the ranks when sharded (collective: on the
        lockstep stream only)."""
        local = self._host_read(arr[..., : self.local])
        if self.multihost is None:
            return local
        return self.multihost.assemble(local, self.ranges, axis=local.ndim - 1)

    def _refuse_sharded(self, what: str) -> None:
        if self.multihost is not None:
            log.fatal("ArrayTable.%s is unsupported on a table whose "
                      "elements are split over a multi-process world", what)

    def remote_spec(self):
        return {"kind": "array", "size": self.size, "dtype": self.dtype.str}

    # -- checkpoint --------------------------------------------------------
    def store(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import write_array, write_state_dict
        write_array(stream, self.logical_host(self.data))
        write_state_dict(stream, {
            name: self.logical_host(arr)
            for name, arr in self.states.items()})

    def load(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import read_array, read_state_dict
        arr = read_array(stream)
        if arr.size != self.size:
            log.fatal("ArrayTable.load: size mismatch %d != %d", arr.size, self.size)
        # in place: functions that closed over the tensors see the restore
        self.data.zero_()
        self.data[: self.local].copy_(torch.from_numpy(np.ascontiguousarray(
            arr.reshape(-1)[self.lo:self.hi].astype(self.dtype, copy=False))))
        states = {name: (got[:, self.lo:self.hi] if got.ndim == 2
                         and got.shape[1] == self.size else got)
                  for name, got in read_state_dict(stream).items()}
        load_states(self.states, states, (self.local,))

    # -- live migration (shard/reshard.py) ---------------------------------
    def extract_range(self, lo: int, hi: int) -> np.ndarray:
        """Raw values of shard-local elements [lo, hi), read to a host
        copy — the migration transfer unit (updater state excluded: the
        recipient's starts at zero, the reference's documented reset)."""
        self._refuse_sharded("extract_range")
        return self._host_read(self.data[int(lo):int(hi)])

    def absorb_range(self, start: int, values) -> None:
        """Write raw values at [start, start+len) in place, bypassing
        updaters — the recipient side of extract_range."""
        self._refuse_sharded("absorb_range")
        values = np.asarray(values, dtype=self.dtype).reshape(-1)
        if not values.flags.writeable:  # a decoded wire buffer
            values = values.copy()
        n = values.size
        if start < 0 or start + n > self.size:
            log.fatal("absorb_range [%d, %d) outside [0, %d)",
                      start, start + n, self.size)
        self.data[start:start + n].copy_(torch.from_numpy(values))


def load_states(states: Dict[str, torch.Tensor], loaded: Dict[str, np.ndarray],
                logical: tuple) -> None:
    """Write checkpointed updater states (logical dims after the worker
    dimension) into the table's state tensors in place, padding zeroed. A
    state missing from the file (a v1 checkpoint) or saved by a world with
    another worker count is left as it is, as in the JAX package."""
    for name, cur in states.items():
        got = loaded.get(name)
        if got is None:
            continue  # v1 checkpoint: that state resets (pre-v2 behavior)
        if got.shape[0] != cur.shape[0]:
            # per-worker state from a world with a different worker
            # count: elastic restarts keep working — reset like v1
            log.info("checkpoint: %s worker dim %d != %d; resetting "
                     "that updater state", name, got.shape[0], cur.shape[0])
            continue
        region = (slice(None),) + tuple(slice(0, n) for n in logical)
        src = torch.from_numpy(np.ascontiguousarray(got))
        if tuple(src.shape) != tuple(cur[region].shape):
            log.fatal("checkpoint: state %s shape %s != %s", name,
                      tuple(src.shape), tuple(cur[region].shape))
        cur.zero_()
        cur[region].copy_(src.to(cur.dtype))


class ArrayWorker(WorkerTable):
    """Client proxy for a 1-D dense table (whole-table Get/Add)."""

    supports_device_io = True

    def __init__(self, size: int, dtype: Any = np.float32,
                 updater_type: str = "",
                 init_value: Optional[np.ndarray] = None,
                 server: Optional[ArrayServer] = None) -> None:
        super().__init__()
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self._server_table = server or ArrayServer(
            size, dtype, updater_type, init_value=init_value)
        self._register(self._server_table)
        if Zoo.instance().multihost is not None:
            # device IO exchanges tensors with the dispatcher; lockstep
            # descriptors must be host-serializable — host paths only
            self.supports_device_io = False

    # -- API (mirrors reference ArrayWorker + python binding handler) -------
    def get(self, option: Optional[GetOption] = None) -> np.ndarray:
        return super().get(option)

    def get_async(self, option: Optional[GetOption] = None) -> int:
        return super().get_async(option)

    def add(self, delta: np.ndarray, option: Optional[AddOption] = None) -> None:
        option = self._default_option(option)
        super().add((delta, option))

    def add_async(self, delta: np.ndarray, option: Optional[AddOption] = None) -> int:
        option = self._default_option(option)
        return super().add_async((delta, option))

    def _default_option(self, option: Optional[AddOption]) -> AddOption:
        if option is None:
            option = AddOption()
            option.worker_id = self._channel.worker_id()
        return option

    # -- device path -------------------------------------------------------
    def get_device(self) -> torch.Tensor:
        """A copy of the live device tensor (padding included). Not ordered
        with queued Adds; use :meth:`get_device_async` for that."""
        self._require_device_io()
        return self._server_table.data.clone()

    def get_device_async(self, option: Optional[GetOption] = None) -> int:
        """Dispatcher-ordered Get whose reply stays on the device: a (size,)
        tensor reflecting every add queued before it."""
        self._require_device_io()
        return super().get_async((option, True))

    def add_device_async(self, delta: torch.Tensor,
                         option: Optional[AddOption] = None) -> int:
        """Async add of a device-resident (size,) delta — no host copy."""
        self._require_device_io()
        option = self._default_option(option)
        return super().add_async((delta, option))

    def sync_device_async(self, delta: torch.Tensor,
                          option: Optional[AddOption] = None) -> int:
        """Fused device add+get: ONE dispatcher hop whose reply is the
        post-add global value on the device."""
        self._require_device_io()
        option = self._default_option(option)
        return super().add_async((delta, option, True))

    def _flat(self, leaves, flatten, snapshot: bool) -> torch.Tensor:
        """The leaves as one flat padded tensor on the table's device. A
        :class:`LeafList` goes out as its own flat tensor, copied when
        ``snapshot``; other leaves are concatenated (a fresh tensor)."""
        flat = getattr(leaves, "flat", None)
        if flat is None:
            return flatten(leaves)
        return flat.clone() if snapshot else flat

    def sync_leaves_async(self, delta_leaves: list,
                          option: Optional[AddOption] = None,
                          last_leaves: Optional[list] = None) -> int:
        """Fused whole-model sync in the caller's own leaf shapes: ONE
        dispatcher hop whose reply is the merged value as a fresh
        :class:`LeafList` on the table's device. The leaf sizes must total
        the table size. Deferred-apply servers reply None; fall back to
        :meth:`get_leaves_async`.

        With ``last_leaves``, ``delta_leaves`` is instead the NEW value:
        the server computes ``new - last`` and replies ``(merged,
        baseline)``, two distinct tensor sets. ``delta_leaves`` is
        snapshotted before this returns; ``last_leaves`` is read on the
        dispatcher, so the caller must not mutate it until the reply."""
        self._require_device_io()
        option = self._default_option(option)
        key, flatten, _ = self._server_table.leaf_codec(delta_leaves)
        new = self._flat(delta_leaves, flatten, snapshot=True)
        if last_leaves is not None:
            last = self._flat(last_leaves, flatten, snapshot=False)
            return super().add_async(("leaves_sync", new, last, option, key))
        return super().add_async(("leaves", new, option, key))

    def push_leaves_async(self, new_leaves: list, last_leaves: list,
                          option: Optional[AddOption] = None) -> int:
        """Reply-free pair push: the server applies ``new - last`` and
        replies None. For round-gated and deferred servers, where a fused
        reply would be discarded anyway: follow with a (gated)
        :meth:`get_leaves_async`. ``new_leaves`` is snapshotted before this
        returns; ``last_leaves`` must stay unmutated until the apply."""
        self._require_device_io()
        option = self._default_option(option)
        key, flatten, _ = self._server_table.leaf_codec(new_leaves)
        return super().add_async((
            "leaves_push", self._flat(new_leaves, flatten, snapshot=True),
            self._flat(last_leaves, flatten, snapshot=False), option, key))

    def get_leaves_async(self, template_leaves: list,
                         option: Optional[GetOption] = None) -> int:
        """Device Get shaped like ``template_leaves`` (only their shapes and
        dtypes are read; meta tensors do): a fresh :class:`LeafList` on
        the table's device."""
        self._require_device_io()
        key, _, _ = self._server_table.leaf_codec(template_leaves)
        return super().get_async(("leaves", option, key))

    def process_reply_get(self, raw: Any, request: Any) -> Any:
        """Leaf requests reply flat tensors; they are split into the
        leaves here, on the caller's thread."""
        if isinstance(request, tuple) and request and isinstance(request[0], str):
            _, split = self._server_table._codecs[request[-1]]
            if isinstance(raw, tuple):
                return tuple(LeafList(flat, split) for flat in raw)
            return LeafList(raw, split)
        return raw
