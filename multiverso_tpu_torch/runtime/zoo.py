"""Zoo — the runtime orchestrator (port of ``multiverso_tpu/runtime/zoo.py``).

A process-wide singleton that owns the node identity, the device that holds
the server tables, the dispatcher, the worker barrier and the table
registry. Membership is static and known at init, so worker and server ids
are arithmetic (:meth:`Zoo._assign_ids`). A process hosts
``local_workers`` worker contexts (threads); the one device is the one
server shard.

``aggregate`` (``MV_Aggregate``) sums a value across the local worker
contexts: numpy arrays and lists of them on the host, tensors and lists of
them on their device. The slots are summed in slot order (the JAX package
sums in the order the threads arrived), and each worker gets its own copy
of a device result (JAX arrays are immutable and shared there; a torch
tensor handed to four workers would be mutated under the other three).

``remote_server`` is the process's :class:`~multiverso_tpu_torch.runtime.
remote.RemoteServer` once ``serve`` ran (stopped with the runtime), and
``_dedup_seeds`` are request ids the next ``serve`` seeds its dedup window
with.

A ``torch.distributed`` world of several processes
(:func:`~multiverso_tpu_torch.runtime.multihost.init_distributed`) runs the
LOCKSTEP protocol (:mod:`multiverso_tpu_torch.runtime.multihost`): rank 0
hosts the real dispatcher and broadcasts every table-executing request
descriptor; the other ranks replay the identical stream, so every rank
issues the same collectives in the same order, and the matrix and array
tables split their rows over the ranks. It requires the same consistency
flags (checked at bring-up) and ``multihost_endpoint`` on every process,
uniform roles, and tables created collectively (same order on every
process) before training traffic. ``aggregate`` then sums across every
rank's workers: the local sum rides the control plane to the leader,
which adds the ranks' sums in rank order and sends the total back.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.multihost import (FollowerServer,
                                                    MultihostRuntime,
                                                    world_of_process)
from multiverso_tpu_torch.runtime.node import Node, Role
from multiverso_tpu_torch.runtime.server import Server, make_server

_thread_local = threading.local()


def _is_device_value(v: Any) -> bool:
    """A tensor, or a non-empty list/tuple of them (a model's leaves): the
    aggregate device path's input shape."""
    return isinstance(v, torch.Tensor) or (
        isinstance(v, (list, tuple)) and bool(v)
        and all(isinstance(x, torch.Tensor) for x in v))


def _host_leaf_sum(values):
    """Per-leaf numpy sums across workers' leaf lists."""
    return [np.asarray(np.sum([np.asarray(v[i]) for v in values], axis=0))
            for i in range(len(values[0]))]


def _device_sum(values):
    """Slot-ordered sum on the values' device: one tensor, or per leaf of
    matching lists of tensors. The result is a fresh tensor set."""
    def total(xs):
        out = xs[0].clone()
        for x in xs[1:]:
            out.add_(x)
        return out

    if isinstance(values[0], torch.Tensor):
        return total(values)
    return [total(xs) for xs in zip(*values)]


def _copy_device(result):
    if isinstance(result, torch.Tensor):
        return result.clone()
    return [x.clone() for x in result]


class Zoo:
    """Process-wide runtime singleton."""

    _instance: Optional["Zoo"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._started = False
        self.node = Node()
        self.device: Optional[torch.device] = None
        self.server: Optional[Server] = None
        self.remote_server: Optional[Any] = None  # runtime.remote.RemoteServer
        # (req_id, worker, msg_id) triples the next serve() seeds its
        # dedup window with (exactly-once across a restart)
        self._dedup_seeds: Optional[List] = None
        self._local_workers = 1
        self._remote_workers = 0
        self._barrier: Optional[threading.Barrier] = None
        self._worker_tables: List[Any] = []
        self._agg_lock = threading.Lock()
        self._agg_slots: Dict[int, Any] = {}
        self._agg_result: Any = None
        self.multihost: Optional[Any] = None  # runtime.multihost.MultihostRuntime
        self._process_index = 0
        self._process_count = 1

    # -- singleton ---------------------------------------------------------
    @classmethod
    def instance(cls) -> "Zoo":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Zoo()
            return cls._instance

    @classmethod
    def _reset_instance(cls) -> None:
        with cls._instance_lock:
            cls._instance = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, argv: Optional[Sequence[str]] = None) -> List[str]:
        if self._started:
            log.fatal("Zoo.start called twice without stop")
        remaining = config.parse_cmd_flags(list(argv) if argv else [])
        self._process_index, self._process_count = world_of_process()
        # resolve the device first: a missing card fails before any thread.
        # `device` is this package's own flag (config.py); mvlint checks
        # flag reads against the JAX package's defines only.
        device = config.get_flag("device")  # mvlint: ignore[flags]
        if (device == "cuda" and self._process_count > 1
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            # a rank per card where there are several; on one card every
            # rank shares it
            device = f"cuda:{self._process_index % torch.cuda.device_count()}"
        self.device = mesh_lib.build_device(device)
        if self._process_count > 1:
            # multi-process world: run the lockstep protocol so every rank
            # issues the same collectives (module docstring, multihost.py)
            endpoint = config.get_flag("multihost_endpoint")
            if not endpoint:
                log.fatal(
                    "multi-process torch.distributed world (world size %d) "
                    "needs -multihost_endpoint=host:port — the lockstep "
                    "control plane rank 0 binds; alternatively scale with "
                    "off-process workers via mvt.serve()/"
                    "mvt.remote_connect()", self._process_count)
            self.multihost = MultihostRuntime(
                self._process_index, self._process_count, endpoint)
            self.multihost.connect()
        self.node.rank = self._process_index
        self.node.role = Role.from_string(config.get_flag("ps_role"))
        self._local_workers = max(1, config.get_flag("local_workers"))
        self._remote_workers = max(0, config.get_flag("remote_workers"))
        self._assign_ids()
        shape = mesh_lib.parse_mesh_shape(config.get_flag("mesh_shape"))
        axes = tuple(a for a in config.get_flag("mesh_axes").split(",") if a)
        # the flags only have to describe the world: one device a rank,
        # each rank's rows from row_range
        mesh_lib.build_mesh(self._process_count, shape=shape,
                            axis_names=axes or ("server",))
        self._barrier = threading.Barrier(self._local_workers)
        if not config.get_flag("ma"):
            # model-averaging mode skips the PS path entirely (reference:
            # `-ma=true` skips StartPS)
            if self.multihost is not None and self.rank != 0:
                self.server = FollowerServer(self.multihost)
            else:
                self.server = make_server(self.num_workers)
                if self.multihost is not None:
                    self.multihost.attach_leader(self.server)
            self.server.start()
        self._started = True
        log.debug("Zoo started: rank=%d/%d workers=%d device=%s",
                  self.rank, self.size, self.num_workers, self.device)
        self.process_barrier()
        return remaining

    def stop(self, finalize_net: bool = True) -> None:
        if not self._started:
            return
        if not (self.multihost is not None
                and self.multihost.poisoned is not None):
            # a poisoned rank can never complete another rendezvous —
            # teardown must still run (close sockets, free tables)
            self.process_barrier()
        if self.remote_server is not None:
            self.remote_server.stop()
            self.remote_server = None
        if self.server is not None:
            self.server.stop()
            if self.server.wal is not None:
                self.server.wal.close()
                self.server.wal = None
            self.server = None
        if self.multihost is not None:
            self.multihost.shutdown()
            self.multihost = None
        self._worker_tables.clear()
        self._started = False
        if finalize_net:
            Zoo._reset_instance()

    def _assign_ids(self) -> None:
        # Static membership: ids are pure arithmetic on (rank, role).
        self.node.worker_id = (
            self.rank * self._local_workers if self.node.is_worker else -1)
        self.node.server_id = self.rank if self.node.is_server else -1

    # -- identity ----------------------------------------------------------
    @property
    def started(self) -> bool:
        return self._started

    @property
    def rank(self) -> int:
        return self._process_index

    @property
    def size(self) -> int:
        return self._process_count

    @property
    def num_workers(self) -> int:
        """Every rank's local worker contexts (only when this node carries
        the worker role) plus expected remote clients."""
        local = (self._process_count * self._local_workers
                 if self.node.is_worker else 0)
        return local + self._remote_workers

    @property
    def remote_workers(self) -> int:
        return self._remote_workers

    @property
    def num_servers(self) -> int:
        """Server shards: one table device per rank."""
        return self._process_count if self.device is not None else 0

    def row_range(self, total: int):
        """This rank's ``[lo, hi)`` of a ``total``-row table that splits
        its rows over the world (``parallel/mesh.table_sharding``); the
        whole table in one process."""
        return mesh_lib.table_sharding(total, self._process_index,
                                       self._process_count)

    @property
    def local_workers(self) -> int:
        return self._local_workers

    def current_worker_id(self) -> int:
        """Global worker id of the calling thread's worker context; -1 on a
        server-only node or inside :meth:`admin`."""
        if not self.node.is_worker:
            return -1
        local = getattr(_thread_local, "worker_slot", 0)
        if local < 0:  # admin context (see admin())
            return -1
        return self.rank * self._local_workers + local

    def bind_worker(self, local_slot: int) -> None:
        if not 0 <= local_slot < self._local_workers:
            log.fatal("bind_worker: slot %d out of range [0,%d)", local_slot,
                      self._local_workers)
        _thread_local.worker_slot = local_slot

    @contextlib.contextmanager
    def admin(self):
        """Administrative (un-clocked) table access for the calling thread:
        ``current_worker_id()`` reports -1 inside."""
        prev = getattr(_thread_local, "worker_slot", None)
        _thread_local.worker_slot = -1
        try:
            yield
        finally:
            if prev is None:
                del _thread_local.worker_slot
            else:
                _thread_local.worker_slot = prev

    def worker_id_to_rank(self, worker_id: int) -> int:
        return worker_id // self._local_workers

    def server_id_to_rank(self, server_id: int) -> int:
        return server_id

    # -- barrier -----------------------------------------------------------
    def barrier(self) -> None:
        """Blocks until every local worker context arrives. Must be called
        from every local worker context when ``local_workers > 1``."""
        if self._barrier is not None and self._local_workers > 1:
            self._barrier.wait()

    def process_barrier(self) -> None:
        """Cross-process rendezvous: real over the multihost control plane,
        a no-op in a single process (kept so lifecycle code reads the same
        as the reference's barrier-after-create shape)."""
        if self.multihost is not None:
            self.multihost.barrier()

    # -- tables ------------------------------------------------------------
    def register_table(self, worker_table: Any, server_table: Any) -> int:
        if self.server is None:
            log.fatal("register_table: PS disabled (ma mode) or Zoo not started")
        if self.multihost is not None and self.rank == 0:
            # leader: every table-executing path must broadcast a lockstep
            # descriptor before it runs — register the wrapper, and point
            # the worker proxy at it so checkpoint/store calls stay safe
            server_table = self.multihost.wrap_table(server_table)
            if hasattr(worker_table, "_server_table"):
                worker_table._server_table = server_table
        table_id = self.server.register_table(server_table)
        self._worker_tables.append(worker_table)
        if self.multihost is not None:
            # table creation is collective (same order on every process);
            # rendezvous here so no process can reference table_id before
            # every process has registered it
            self.multihost.barrier()
        return table_id

    # -- aggregate (model averaging) ----------------------------------------
    def aggregate(self, data: Any) -> Any:
        """In-place-sum semantics of ``MV_Aggregate``: returns the
        elementwise sum of ``data`` across every local worker context —
        and, in a multi-process world, across every rank's workers (the
        reference's ``MPI_Allreduce`` contract,
        ``Test/test_allreduce.cpp:13-16``).

        Host inputs (numpy arrays, or lists of them: a model's leaves) sum
        on the host and every worker gets its own copy. Device inputs (a
        tensor or a list of them) sum on their device and every worker
        gets its own copy there. Mixing host and device values across
        workers in one round is fatal."""
        if _is_device_value(data):
            return self._aggregate_slots(data, _device_sum, _copy_device)
        if (isinstance(data, (list, tuple)) and data
                and all(isinstance(x, np.ndarray) for x in data)):
            # host leaf list: per-leaf sums; scalar lists keep the classic
            # array semantics below. Conversion happens in the reducer,
            # inside the barrier-abort guard: a ragged value must fail
            # loudly, not wedge peers before they deposit
            return self._aggregate_slots(
                data, _host_leaf_sum,
                lambda r: [np.array(x, copy=True) for x in r])
        return self._aggregate_slots(
            data,
            lambda values: np.asarray(
                np.sum([np.asarray(v) for v in values], axis=0)),
            lambda r: np.array(r, copy=True))

    def _aggregate_slots(self, data: Any, reduce_fn, copy) -> Any:
        """Barrier exchange shared by the host and device paths: each
        worker deposits its slot's value, slot 0 reduces them in slot
        order into a fresh result and keeps it; every other worker takes a
        copy. Leaf lists of different lengths fail loudly (inside the
        barrier-abort guard) instead of silently dropping trailing
        leaves. In a multi-process world the reducer's local sum then
        crosses to every rank (``_global_sum``) before anyone picks it
        up."""
        # Key by the calling thread's BOUND slot, not current_worker_id():
        # on a ps_role=server node the worker id is -1 for every thread.
        slot = getattr(_thread_local, "worker_slot", None)
        if slot is None and self._local_workers > 1:
            log.fatal("aggregate: bind a worker slot (mvt.worker(i)) before "
                      "aggregating with local_workers=%d — an unbound thread "
                      "cannot be distinguished from slot 0",
                      self._local_workers)
        slot = slot or 0
        gated = self._barrier is not None and self._local_workers > 1
        with self._agg_lock:
            self._agg_slots[slot] = data
        if gated:
            self._barrier.wait()
        reducer = slot == 0 or not gated
        if reducer:
            try:
                with self._agg_lock:
                    values = [self._agg_slots[s] for s in sorted(self._agg_slots)]
                    self._agg_slots.clear()
                if len({_is_device_value(v) for v in values}) > 1:
                    log.fatal("aggregate: workers mixed host and device "
                              "values in one round")
                lengths = {len(v) for v in values
                           if isinstance(v, (list, tuple))}
                if len(lengths) > 1:
                    log.fatal("aggregate: workers deposited leaf lists of "
                              "different lengths (%s)", sorted(lengths))
                self._agg_result = reduce_fn(values)
                if self.multihost is not None:
                    # the local sum is one process's contribution; the
                    # MV_Aggregate contract is ALL ranks' sum on every rank
                    self._agg_result = self._global_sum(self._agg_result)
            except BaseException:
                # release peers (they see BrokenBarrierError) instead of
                # wedging them on a barrier slot 0 will never reach
                if self._barrier is not None:
                    self._barrier.abort()
                raise
        if gated:
            self._barrier.wait()
        # the reducer's result is fresh; the others copy it before the
        # reducer returns it past the last barrier
        result = self._agg_result if reducer else copy(self._agg_result)
        if gated:
            self._barrier.wait()
        if reducer:
            # every worker took its copy between the barriers: drop the
            # shared result so it does not stay resident until the next round
            self._agg_result = None
        return result

    def _global_sum(self, result: Any) -> Any:
        """Cross-process leg of aggregate: ship this process's local sum
        through the control-plane allreduce and return the all-ranks total
        in the caller's shape. Device values hop through host numpy (the
        control plane carries host bytes only) and come back on their
        device, in their dtype."""
        if _is_device_value(result):
            leaves = (list(result) if isinstance(result, (list, tuple))
                      else [result])
            total = self.multihost.allreduce_host(
                [leaf.detach().cpu().numpy() for leaf in leaves])
            out = [torch.from_numpy(np.asarray(t)).to(leaf.device, leaf.dtype)
                   for t, leaf in zip(total, leaves)]
            return out if isinstance(result, (list, tuple)) else out[0]
        if isinstance(result, list):  # host leaf-list path
            return self.multihost.allreduce_host(result)
        return self.multihost.allreduce_host([np.asarray(result)])[0]
