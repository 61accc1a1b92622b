"""Table layer contracts: WorkerTable (client proxy) and ServerTable (state)
(port of ``multiverso_tpu/tables/base.py``).

A worker proxy sends Get/Add messages through a channel to the dispatcher
and waits on per-request completions (``Get/Add = Wait(XxxAsync(...))``);
the server table owns torch tensors on the runtime's device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import count, monitor
from multiverso_tpu_torch.runtime.message import Message, MsgType, next_msg_id
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.utils import Waiter


#: Orders the pinned allocations of concurrent reads, so that each read's
#: count of new page-locked blocks is its own.
_PIN_LOCK = threading.Lock()
#: The least read that goes through page-locked memory. On an H100 80GB
#: HBM3 (700 W, torch 2.11, a reused block, medians of 10-200 reads) the
#: page-locked read took 63-70 us from 256 B to 64 KiB against 21-29 us
#: pageable (each look at the host allocator's stats costs 16 us), and 87
#: against 127 us at 1 MiB, 0.44 against 1.38 ms at 16 MiB, 4.0 against
#: 110 ms at 200 MB.
_PINNED_READ_MIN_BYTES = 1 << 20


def _pinned_copy(tensor: torch.Tensor) -> Tuple[np.ndarray, int]:
    """(a C-contiguous numpy copy of a CUDA tensor over page-locked host
    memory, 1 if the caching host allocator had to pin a new block for it
    else 0). ``copy_`` compacts a strided view on the device first, then
    moves the bytes in one DMA and waits for it."""
    with _PIN_LOCK:
        made = torch.cuda.host_memory_stats_as_nested_dict()["num_host_alloc"]
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        made = (torch.cuda.host_memory_stats_as_nested_dict()["num_host_alloc"]
                - made)
    host.copy_(tensor)
    return host.numpy(), made


class Completion:
    """One outstanding request: a waiter plus its result slot."""

    __slots__ = ("_waiter", "result", "error")

    def __init__(self) -> None:
        self._waiter = Waiter(1)
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def done(self, result: Any) -> None:
        self.result = result
        self._waiter.notify()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._waiter.notify()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._waiter.wait(timeout):
            raise TimeoutError("table request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class LocalChannel:
    """Default request channel: the in-process dispatcher queue."""

    def __init__(self) -> None:
        self._zoo = Zoo.instance()

    def worker_id(self) -> int:
        return self._zoo.current_worker_id()

    def submit(self, table_id: int, msg_type: MsgType, request: Any,
               msg_id: int, completion: "Completion") -> None:
        msg = Message(src=self.worker_id(), dst=-1, type=msg_type,
                      table_id=table_id, msg_id=msg_id,
                      data=[request, completion])
        self._zoo.server.send(msg)

    def post(self, table_id: int, msg_type: MsgType) -> None:
        """Fire-and-forget control message (Server_Finish_Train)."""
        msg = Message(src=self.worker_id(), dst=-1, type=msg_type,
                      table_id=table_id, msg_id=next_msg_id())
        self._zoo.server.send(msg)


class WorkerTable:
    """Client proxy: issues Get/Add messages, tracks outstanding replies."""

    def __init__(self, channel: Optional[Any] = None) -> None:
        self.table_id: int = -1
        self._channel = channel if channel is not None else LocalChannel()
        self._zoo = Zoo.instance() if channel is None else None
        self._pending: Dict[int, Completion] = {}
        self._pending_request: Dict[int, Any] = {}
        self._lock = threading.Lock()

    # -- wiring ------------------------------------------------------------
    def _register(self, server_table: "ServerTable") -> None:
        self.table_id = self._zoo.register_table(self, server_table)
        server_table.table_id = self.table_id

    # -- async machinery ---------------------------------------------------
    def _submit(self, msg_type: MsgType, request: Any) -> int:
        msg_id = next_msg_id()
        completion = Completion()
        with self._lock:
            self._pending[msg_id] = completion
            self._pending_request[msg_id] = request
        self._channel.submit(self.table_id, msg_type, request, msg_id,
                             completion)
        return msg_id

    def get_async(self, request: Any) -> int:
        return self._submit(MsgType.Request_Get, request)

    def add_async(self, request: Any) -> int:
        return self._submit(MsgType.Request_Add, request)

    def wait(self, msg_id: int) -> Any:
        with self._lock:
            completion = self._pending.pop(msg_id, None)
            request = self._pending_request.pop(msg_id, None)
        if completion is None:
            log.fatal("wait: unknown msg_id %d on table %d", msg_id, self.table_id)
        raw = completion.wait()
        if raw is None:
            return None
        return self.process_reply_get(raw, request)

    def process_reply_get(self, raw: Any, request: Any) -> Any:
        """Post-process a Get reply (reference: ``ProcessReplyGet``).
        Default: identity."""
        return raw

    def _require_device_io(self) -> None:
        """Guard for tensor-exchanging entry points: in-process proxies
        only."""
        if not getattr(self, "supports_device_io", False):
            log.fatal("device IO is in-process only")

    # -- sync wrappers (Get/Add = Wait(Async)) ------------------------------
    # These call _submit directly (not self.get_async) so subclasses can
    # override the async methods with their own signatures safely.
    def get(self, request: Any) -> Any:
        with monitor("WORKER_TABLE_SYNC_GET"):
            return self.wait(self._submit(MsgType.Request_Get, request))

    def add(self, request: Any) -> Any:
        with monitor("WORKER_TABLE_SYNC_ADD"):
            return self.wait(self._submit(MsgType.Request_Add, request))

    def query(self, vecs: Any, k: int, metric: str = "dot") -> Any:
        """Server-side top-k retrieval pushdown: score every row of the
        table against ``vecs`` ((n_q, dim) float32) under ``metric``
        (``dot`` | ``cosine``) and return ``(ids, scores)``, each
        (n_q, k') with k' = min(k, rows), ranked score-descending with
        ties toward the lower id. Served on the dispatcher after every
        Add acknowledged before it was sent, and never clocked: the round
        gates of the BSP, SSP and deterministic servers do not hold it.
        It is serving-lane traffic: drained together with queued Adds, it
        is answered before them (``priority_lanes``).

        Bypasses wait()/process_reply_get: the reply is already the final
        (ids, scores) pair."""
        from multiverso_tpu_torch.query.engine import check_request
        request = check_request((vecs, k, metric))
        with monitor("WORKER_TABLE_SYNC_QUERY"):
            completion = Completion()
            self._channel.submit(self.table_id, MsgType.Request_Query,
                                 request, next_msg_id(), completion)
            return completion.wait()

    def finish_train(self) -> None:
        """Signal end-of-training (reference: ``Server_Finish_Train``)."""
        self._channel.post(self.table_id, MsgType.Server_Finish_Train)


class ServerTable:
    """Device-resident table state on the runtime's ``torch.device``."""

    def _unwrapped(self):
        """This server table with any lockstep wrapper peeled off: the
        identity here; a multihost leader's ``LockstepTable`` forwards it
        to its inner table."""
        return self

    _OPT_CACHE_MAX = 256

    def __init__(self) -> None:
        self.table_id: int = -1
        self.device: torch.device = Zoo.instance().device
        # one shard of a range-partitioned table (shard/partition.py): the
        # member serves SHARD-LOCAL ids in [0, local size) — the router
        # translates — and advertises the offset in its remote directory.
        # 0 = unsharded (or the first shard).
        self.row_offset: int = 0
        # (scalars tuple, worker) -> (worker index, device scalars),
        # LRU-bounded: a repeated AddOption envelope skips the host->device
        # upload; a churning one cannot pin more than _OPT_CACHE_MAX
        # tensors. Locked: the dispatcher and worker threads both call it.
        self._opt_cache: "OrderedDict" = OrderedDict()
        self._opt_cache_lock = threading.Lock()

    def _option_host(self, option):
        """(worker index, scalars envelope as a float32 numpy array) for an
        AddOption: the host form of :meth:`_option_consts`."""
        worker = max(option.worker_id, 0) % max(1, self.num_workers)
        return worker, np.asarray(option.scalars(), np.float32)

    def _option_consts(self, option):
        """(worker index, scalars envelope as a float32 device tensor) for
        an AddOption, cached so identical envelopes upload once. Requires
        ``self.num_workers``. Administrative access (worker id -1) charges
        slot 0."""
        key = (option.scalars(), int(option.worker_id))
        with self._opt_cache_lock:
            cached = self._opt_cache.get(key)
            if cached is not None:
                self._opt_cache.move_to_end(key)
                return cached
        # build outside the lock; a racing duplicate insert is harmless
        worker, scalars = self._option_host(option)
        cached = (worker, torch.from_numpy(scalars).to(self.device))
        with self._opt_cache_lock:
            self._opt_cache[key] = cached
            if len(self._opt_cache) > self._OPT_CACHE_MAX:
                self._opt_cache.popitem(last=False)
        return cached

    def remote_spec(self) -> Optional[Dict[str, Any]]:
        """What a remote client needs to build a matching worker proxy:
        the kind, the LOGICAL shape and the numpy dtype string, exactly as
        the JAX package's tables send them (a client of either package
        builds its proxy from it). The device padding never reaches the
        wire. None = not servable over the wire."""
        return None

    @staticmethod
    def _host_read(tensor: torch.Tensor) -> np.ndarray:
        """Device->host read of table state into a fresh numpy array. Always
        a copy — on the CPU too — so later in-place Adds never show through
        a reply. This rank's part only: a table whose rows are split over a
        multi-process world assembles the logical value from every rank's
        read (``MatrixServer.logical_host``, ``ArrayServer.logical_host``),
        on the lockstep thread only. Timed as ``SERVER_HOST_READ`` (it waits
        for the stream), its bytes counted in ``SERVER_HOST_READ_BYTES``.

        From a CUDA device a read of 1 MiB or more lands in page-locked
        memory from PyTorch's caching host allocator: one DMA, and no page
        faults once a block of the size is cached. The reply's ``base`` is
        the pinned tensor, so its block returns to the cache when the
        caller drops the reply. Counted in ``SERVER_HOST_READ_PINNED_BYTES``,
        and the reads that had to pin a new block in
        ``SERVER_HOST_READ_PIN_NEW``."""
        pinned = tensor.is_cuda and tensor.nbytes >= _PINNED_READ_MIN_BYTES
        with monitor("SERVER_HOST_READ"):
            if pinned:
                host, new_blocks = _pinned_copy(tensor.detach())
            else:
                host = tensor.detach().to("cpu", copy=True).numpy()
        count("SERVER_HOST_READ_BYTES", host.nbytes)
        if pinned:
            count("SERVER_HOST_READ_PINNED_BYTES", host.nbytes)
            count("SERVER_HOST_READ_PIN_NEW", new_blocks)
        return host

    def merge_add_requests(self, requests):
        """Fuse a PREFIX of a drained group of Add requests into ONE request
        (the dispatcher's micro-batch path): return ``(merged_request,
        rows, consumed)`` — ``process_add(merged)`` must equal applying the
        first ``consumed`` requests in turn, up to the commutative-Add
        reordering — or None when even the first request cannot merge.

        Contract: MUST NOT mutate table state; ``process_add(merged)`` must
        validate before it mutates, so a raised error means nothing
        applied. Default: no batching."""
        return None

    def process_add(self, request: Any) -> None:
        raise NotImplementedError

    def process_get(self, request: Any) -> Any:
        raise NotImplementedError

    # Serializable (checkpoint) hooks: run on the dispatcher thread
    # (checkpoint._run_serialized)
    def store(self, stream) -> None:
        raise NotImplementedError

    def load(self, stream) -> None:
        raise NotImplementedError

    # -- live migration hooks (shard/reshard.py) ----------------------------
    # Raw-value slice transfer for key-range migration: extract hands the
    # donor's CURRENT values of a shard-local id range to host memory (no
    # updater involvement, like store()); absorb writes values at a range
    # on the recipient, bypassing updaters — a migrated value is state,
    # not a gradient. Only range-partitionable kinds implement these; the
    # migration planner refuses the rest before ever calling. Both run in
    # the dispatcher-serialised block (Server.run_serialized).
    def extract_range(self, lo: int, hi: int) -> Any:
        log.fatal("live migration is unsupported for %s (no extract_range)",
                  type(self).__name__)

    def absorb_range(self, start: int, values: Any) -> None:
        log.fatal("live migration is unsupported for %s (no absorb_range)",
                  type(self).__name__)
