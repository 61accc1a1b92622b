"""multiverso_tpu_torch — the Multiverso parameter server on PyTorch and CUDA.

The port of :mod:`multiverso_tpu` (the JAX package, which stays as the
reference) to torch tensors on an NVIDIA GPU. Module paths mirror the JAX
package's, so each module's counterpart is found by name. Table state lives
in torch tensors on one device; row Adds and row Gets run hand-written
CUDA kernels (``csrc/rows.cu``) on the card and their plain PyTorch
versions on the CPU.

Public surface (MV_* parity, the part ported so far):

    init / shutdown / barrier / process_barrier
    init_distributed               (form a multi-process lockstep world)
    rank / size / num_workers / num_servers / worker_id / server_id
    worker_id_to_rank / server_id_to_rank / is_master_worker
    set_flag / get_flag / parse_cmd_flags
    create_table("array" | "matrix" | "kv" | "sparse" | "tiered_sparse"
                 | "tiered_kv") / register_table_type
    worker(slot)                   (bind a logical worker context to a thread)
    aggregate                      (MV_Aggregate: a sum across worker contexts)
    query                          (server-side top-k retrieval pushdown)
    serve / remote_connect / stop_serving
                                   (tables served to other processes)
    stats / watermark / digest     (slot-free probes of a serving process)
    stats_all / traces / attribution / chargeback / top
                                   (fleet views: merged stats, stitched
                                    traces, critical-path and per-tenant
                                    attribution, the live fleet table)
    slo_engine / profiler          (the SLO burn-rate engine, the
                                    sampling profiler)
    Timer / register_program / registered_programs
    durable_recover / wal_writer / warm_standby
                                   (write-ahead log, restart recovery,
                                    failover and read replicas)
    audit                          (primary/replica digest comparison)
    autopilot / autotune           (the fleet control loop over a shard
                                    group; the perf-knob tuner)
    serve_sharded / shard_connect / reshard
                                   (shard groups: one serving process per
                                    shard, a routing client, live
                                    split/merge/move)
    cut_fleet / restore_fleet / clone_fleet
                                   (fleet-wide consistent cuts,
                                    point-in-time restore, clones)
    net_bind / net_connect / net_finalize / net
                                   (MV_NetBind / MV_NetConnect raw transport)

``serve`` answers worker processes over TCP (or a shared-memory ring,
``-wire_shm``) with the JAX package's wire format, so a client of either
package reaches a server of either package; ``remote_connect`` gives a
client's worker-table proxies (host arrays in and out; a client needs no
card). Set ``remote_workers`` at init so the round clocks and per-worker
updater state cover the remote clients.

With the ``wal_dir`` flag set ``serve`` logs every remote Add before its
ACK (``durable/``); ``durable_recover`` replays the log into re-created
tables after a crash, ``warm_standby`` tails a primary and takes over its
endpoint when it dies (or, with ``serve_reads()``, answers reads as a
replica that clients reach through ``remote_connect(...,
read_endpoints=..., read_preference="replica"|"hedged")``), and ``audit``
compares the digests of a primary and its replicas.

``serve_sharded`` launches a shard group: one serving process per shard,
each holding its slice of every table on the group's ``device`` (``cuda``
unless ``device="cpu"`` is passed), with its own WAL, lease table, dedup
window and optional standby and read replicas; ``group.connect()`` (or
``shard_connect(endpoint)``) gives a router client whose proxies split
each request by owner and merge the replies. ``reshard(group)`` moves key
ranges under traffic, and ``cut_fleet`` / ``restore_fleet`` take and
restore a consistent cut of the whole group.

``create_table("kv", dtype, capacity=N)`` puts the KV table's keys and
values on the device (``DeviceKVServer``); the tiered kinds keep a hot set
of rows in host memory and spill the rest to disk (``store/``).

Checkpoints live in :mod:`multiverso_tpu_torch.checkpoint` (``store_table``,
``load_table``, ``restore_tables``, ``CheckpointDriver``), as in the JAX
package, over the stream layer of :mod:`multiverso_tpu_torch.io`; their
files load in either package.

``init`` also starts what the observability flags ask for: periodic JSONL
snapshots (``metrics_path``), the time-series sampler, the sampling
profiler (``profile_continuous``), the SLO engine (``slo_spec``) and the
knob tuner (``autotune``); ``shutdown`` stops them.

``init_distributed(coordinator, world, rank)`` on every process, then
``init(multihost_endpoint=...)`` with the same flags, forms a multi-process
lockstep world (``runtime/multihost.py``): rank 0 runs the dispatcher and
the other ranks replay its stream, the matrix and array tables split their
rows over the ranks, ``process_barrier`` crosses processes and
``aggregate`` sums over every rank's workers. Each rank's tables sit on
its card (``cuda``; every rank shares a single card) unless
``device="cpu"`` is asked for; the ranks talk over gloo.

``init`` puts the tables on ``cuda`` unless the caller asks for the CPU
(``init(device="cpu")`` or ``-device=cpu``); it raises when CUDA is absent
and the CPU was not asked for.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Sequence

from multiverso_tpu_torch import log  # noqa: F401  (re-export)
from multiverso_tpu_torch.config import get_flag, parse_cmd_flags, set_flag  # noqa: F401
from multiverso_tpu_torch.dashboard import Dashboard, Timer, monitor  # noqa: F401
from multiverso_tpu_torch.runtime.node import Role  # noqa: F401
from multiverso_tpu_torch.runtime.programs import (  # noqa: F401
    clear_programs, register_program, registered_programs)
from multiverso_tpu_torch.runtime.multihost import init_distributed  # noqa: F401
from multiverso_tpu_torch.runtime.zoo import Zoo

__version__ = "0.1.0"


# -- lifecycle (MV_Init / MV_ShutDown / MV_Barrier) -------------------------

def init(argv: Optional[Sequence[str]] = None, sync: Optional[bool] = None,
         **flag_overrides: Any) -> list:
    """Bring up the runtime. ``argv`` accepts ``-key=value`` tokens (CLI
    parity); keyword overrides hit the same flag registry
    (e.g. ``init(local_workers=4)``, ``init(device="cpu")``). Flags stay
    set after ``shutdown``, as in the reference."""
    if sync is not None:
        set_flag("sync", sync)
    for key, value in flag_overrides.items():
        set_flag(key, value)
    _configure_profiling()  # first: the dispatcher thread is traced too
    try:
        started = Zoo.instance().start(argv)
    except BaseException:
        _stop_profiling(export=False)
        raise
    _configure_native_allocator()
    _start_metrics_logger()
    _start_observability()
    _start_autotune()
    return started


def shutdown(finalize_net: bool = True) -> None:
    """Stop the runtime and forget its named programs: a registered program
    closes over the tables it was built for."""
    _stop_autotune()
    Zoo.instance().stop(finalize_net)
    clear_programs()
    _stop_profiling()
    _stop_metrics_logger()
    _stop_observability()


def _configure_native_allocator() -> None:
    """Plumb the ``allocator_type`` / ``allocator_alignment`` flags into the
    native host pool. The pool lives in the native library: where this
    process has loaded it, the flags go in now; otherwise the library takes
    them when it is first loaded (``native.load``), so ``init`` never
    builds it."""
    from multiverso_tpu_torch import native
    if native.loaded() is not None:
        native.configure_allocator()


_metrics_logger = None


def _start_metrics_logger() -> None:
    """Start the periodic JSONL snapshot thread when the ``metrics_path``
    flag is set (obs/logger.py); idempotent across repeated init()."""
    global _metrics_logger
    path = str(get_flag("metrics_path"))
    if not path or _metrics_logger is not None:
        return
    from multiverso_tpu_torch.obs.logger import MetricsLogger
    _metrics_logger = MetricsLogger(
        path, float(get_flag("metrics_interval_seconds")))


def _stop_metrics_logger() -> None:
    global _metrics_logger
    if _metrics_logger is not None:
        _metrics_logger.close()  # flushes a final snapshot
        _metrics_logger = None


_slo_engine = None


def _start_observability() -> None:
    """Start the observability plane's background halves: the
    time-series sampler (``timeseries_interval_seconds``; <= 0 disables),
    the sampling profiler (``profile_continuous``) and — only when
    ``slo_spec`` declares objectives — the SLO burn-rate engine
    (obs/slo.py). Idempotent across repeated init()."""
    global _slo_engine
    if float(get_flag("timeseries_interval_seconds")) > 0:
        # the windowed views the hot-range detector and the SLOs read
        from multiverso_tpu_torch.obs.timeseries import TIMESERIES
        TIMESERIES.start()
    if bool(get_flag("profile_continuous")):
        from multiverso_tpu_torch.obs.profiler import PROFILER
        PROFILER.hz = max(float(get_flag("profile_hz")), 1e-3)
        PROFILER.max_frames = int(get_flag("profile_max_frames"))
        PROFILER.emit_metrics = True
        PROFILER.start()
    if str(get_flag("slo_spec")).strip() and _slo_engine is None:
        from multiverso_tpu_torch.obs.slo import SLOEngine
        _slo_engine = SLOEngine()
        _slo_engine.start()


def _stop_observability() -> None:
    global _slo_engine
    from multiverso_tpu_torch.obs.timeseries import TIMESERIES
    TIMESERIES.stop()
    from multiverso_tpu_torch.obs.profiler import PROFILER
    PROFILER.stop()
    if _slo_engine is not None:
        _slo_engine.stop()
        _slo_engine = None


_autotuner = None


def _start_autotune() -> None:
    """Start the self-tuning KnobController (tune/) when the
    ``autotune`` flag is set; idempotent across repeated init(). With
    the flag off NOTHING is built — no thread, no TUNE_* metrics, the
    runtime stays bit-identical to an untuned build."""
    global _autotuner
    if not bool(get_flag("autotune")) or _autotuner is not None:
        return
    from multiverso_tpu_torch.tune import KnobController
    _autotuner = KnobController()
    if _autotuner.interval > 0:
        _autotuner.start()


def _stop_autotune() -> None:
    global _autotuner
    if _autotuner is not None:
        _autotuner.stop()
        _autotuner = None


def autotune():
    """The flag-started self-tuning controller
    (:class:`~multiverso_tpu_torch.tune.KnobController`) — None unless
    ``autotune`` was set at init. Tests and drills may also build their
    own ``KnobController`` directly and drive ``tick_now()``."""
    return _autotuner


def slo_engine():
    """The flag-started SLO engine (None unless ``slo_spec`` was set at
    init); tests and dashboards may also build their own
    :class:`~multiverso_tpu_torch.obs.slo.SLOEngine` directly."""
    return _slo_engine


def profiler():
    """The process-wide sampling profiler
    (:data:`~multiverso_tpu_torch.obs.profiler.PROFILER`) — running when
    ``profile_continuous`` was set at init, otherwise idle but usable
    directly (``mvt.profiler().start()`` / ``.sample_once()``)."""
    from multiverso_tpu_torch.obs.profiler import PROFILER
    return PROFILER


_trace_profile = None  # the trace_dir flag's torch.profiler session


def _configure_profiling() -> None:
    """``profile_annotations`` makes every ``dashboard.monitor`` section a
    named ``torch.profiler`` scope; ``trace_dir`` also records a
    ``torch.profiler`` trace of the span from init to shutdown (the
    card's kernels too when CUDA is up), with those scopes in it."""
    global _trace_profile
    trace_dir = str(get_flag("trace_dir"))
    Dashboard.profile_annotations = (bool(get_flag("profile_annotations"))
                                     or bool(trace_dir))
    if trace_dir and _trace_profile is None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # every thread: the dispatcher applies, the workers call
        _trace_profile = profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        _trace_profile.__enter__()


def _stop_profiling(export: bool = True) -> None:
    """End the ``trace_dir`` session and write its trace as
    ``trace_<pid>.json`` (Chrome format); a no-op when none is running."""
    global _trace_profile
    if _trace_profile is None:
        return
    import os
    prof, _trace_profile = _trace_profile, None
    Dashboard.profile_annotations = False
    prof.__exit__(None, None, None)
    if not export:
        return
    trace_dir = str(get_flag("trace_dir"))
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_{os.getpid()}.json"))


def barrier() -> None:
    Zoo.instance().barrier()


def process_barrier() -> None:
    """Cross-process rendezvous: real in a multi-process lockstep world
    (over its control plane), a no-op in a single process."""
    Zoo.instance().process_barrier()


# -- identity ---------------------------------------------------------------

def rank() -> int:
    return Zoo.instance().rank


def size() -> int:
    return Zoo.instance().size


def num_workers() -> int:
    return Zoo.instance().num_workers


def workers_num() -> int:  # python-binding spelling
    return num_workers()


def num_servers() -> int:
    return Zoo.instance().num_servers


def server_num() -> int:  # python-binding spelling
    return num_servers()


def worker_id() -> int:
    return Zoo.instance().current_worker_id()


def server_id() -> int:
    return Zoo.instance().node.server_id


def worker_id_to_rank(wid: int) -> int:
    return Zoo.instance().worker_id_to_rank(wid)


def server_id_to_rank(sid: int) -> int:
    return Zoo.instance().server_id_to_rank(sid)


def is_master_worker() -> bool:
    """Worker 0 seeds shared state (python-binding contract)."""
    return worker_id() == 0


@contextlib.contextmanager
def worker(local_slot: int) -> Iterator[int]:
    """Bind the calling thread to logical worker context ``local_slot``."""
    zoo = Zoo.instance()
    zoo.bind_worker(local_slot)
    try:
        yield zoo.rank * zoo.local_workers + local_slot
    finally:
        zoo.bind_worker(0)


# -- collectives (MV_Aggregate) ---------------------------------------------

def aggregate(data: Any) -> Any:
    """Elementwise sum of ``data`` across every local worker context; every
    caller gets its own copy of the sum (in-place-sum semantics of
    ``MV_Aggregate``).

    Host inputs (numpy arrays, or lists of them: a model's leaves) sum on
    the host. Device inputs (a tensor or a list of them) sum on their
    device, in slot order, and each worker gets its own buffers. Mixing
    host and device values across workers in one round is fatal."""
    return Zoo.instance().aggregate(data)


# Bind the retrieval subpackage NOW so the front door below wins the
# `query` name on this module: once multiverso_tpu_torch.query sits in
# sys.modules, later imports of it (or its engine) never re-assign the
# parent attribute over the function.
from multiverso_tpu_torch import query as _query_plane  # noqa: E402,F401


def query(table: Any, vecs: Any, k: int, metric: str = "dot"):
    """Server-side top-k retrieval pushdown over ``table`` (``query/``):
    score every row against the query matrix ``vecs`` ((n_q, dim)
    float32) under ``metric`` (``dot`` | ``cosine``) and return
    ``(ids, scores)``, each (n_q, k') with k' = min(k, rows), ranked
    score-descending, ties toward the lower id."""
    return table.query(vecs, k, metric=metric)


# -- remote table serving (cross-process PS) ---------------------------------
# The reference's core product: workers in OTHER processes reach tables over
# the network (worker actor → communicator → net → server). The process
# that holds the tables calls serve(); other processes call remote_connect()
# and get worker-table proxies with the same get/add semantics.

def serve(endpoint: str = "127.0.0.1:0") -> str:
    """Start serving this process's tables to remote clients; returns the
    dialable endpoint (pass port 0 for ephemeral). Set the
    ``remote_workers`` flag at init so BSP clocks and per-worker updater
    state cover the remote clients.

    With the ``wal_dir`` flag set, serving is durable: every remote Add is
    write-ahead-logged before its ACK, and any dedup seeds left by
    ``durable_recover()`` (or a standby's replication tail) repopulate the
    idempotent-replay window so exactly-once holds across the restart."""
    zoo = Zoo.instance()
    if not zoo.started or zoo.server is None:
        log.fatal("serve: init() the PS runtime first (not available in ma mode)")
    if not str(get_flag("metrics_role")):
        # fleet identity for labeled Prometheus exposition; replicas and
        # standbys stamp their own role when they start serving
        set_flag("metrics_role", "primary")
    if zoo.remote_server is None:
        wal_dir = str(get_flag("wal_dir"))
        if wal_dir and zoo.server.wal is None:
            from multiverso_tpu_torch.durable.wal import WalWriter
            zoo.server.wal = WalWriter(wal_dir)
        from multiverso_tpu_torch.runtime.remote import RemoteServer
        zoo.remote_server = RemoteServer(zoo)
        if zoo._dedup_seeds:
            zoo.remote_server.seed_dedup(zoo._dedup_seeds)
            zoo._dedup_seeds = None
        try:
            return zoo.remote_server.serve(endpoint)
        except OSError:
            # bind failed (port still held): leave no half-serving state
            # behind so a retry — the standby's failover loop — can call
            # serve() again
            zoo.remote_server.stop()
            zoo.remote_server = None
            raise
    return zoo.remote_server.endpoint


def remote_connect(endpoint: str, timeout: float = 30.0,
                   read_endpoints: Optional[Sequence[str]] = None,
                   read_preference: Optional[str] = None):
    """Connect to a serving process (of either package); returns a
    RemoteClient whose ``.table(table_id)`` / ``.tables()`` give
    worker-table proxies. Needs no ``init`` and no card.

    ``read_endpoints`` (serving read replicas of this primary, see
    ``mvt.warm_standby(...).serve_reads()``) plus a non-primary
    ``read_preference`` (replica|hedged; default: the ``read_preference``
    flag) route Gets through the read tier — bounded-staleness client
    cache, budget-admitted replicas, transparent primary fallback."""
    from multiverso_tpu_torch.runtime.remote import RemoteClient
    return RemoteClient(endpoint, timeout=timeout,
                        read_endpoints=(list(read_endpoints)
                                        if read_endpoints else None),
                        read_preference=read_preference)


def stats(endpoint: str, timeout: float = 10.0):
    """Live stats RPC: pull a serving process's full dashboard —
    monitors, counters, gauges, and latency histograms with caller-side
    p50/p95/p99 — without taking a worker slot. Returns a
    :class:`~multiverso_tpu_torch.obs.metrics.StatsSnapshot`."""
    from multiverso_tpu_torch.runtime.remote import fetch_stats
    return fetch_stats(endpoint, timeout=timeout)


def watermark(endpoint: str, timeout: float = 10.0):
    """Watermark probe (read-replica tier): ``{"role", "watermark",
    "primary_watermark", "lag"}`` for any serving endpoint — a primary
    reports its WAL append sequence (-1 without a WAL), a read replica its
    replay sequence and how many records it trails its primary by.
    Slot-free, like ``stats``."""
    from multiverso_tpu_torch.runtime.remote import fetch_watermark
    return fetch_watermark(endpoint, timeout=timeout)


def stats_all(endpoints: Any, timeout: Optional[float] = None,
              replicas: Optional[Sequence[Sequence[str]]] = None):
    """Fan ``mvt.stats`` across a shard group and merge: counters summed,
    histograms merged by bucket addition (quantiles compute on the union
    of the members' exact counts), with per-shard sub-views kept on
    ``.shards``. ``endpoints``: list of host:port, a comma-separated
    string, or a :class:`~multiverso_tpu_torch.shard.group.ShardGroup` (whose
    read-replica fleets are probed automatically). ``replicas`` — one
    endpoint list per shard — adds per-replica sub-views on
    ``.replicas`` (a dict ``endpoint -> StatsSnapshot``), merged into
    the totals alongside the primaries (replica replay-lag gauges
    REPLICA_WATERMARK / REPLICA_LAG_RECORDS live there).

    Probes run CONCURRENTLY with a per-endpoint timeout (default: the
    ``stats_timeout_seconds`` flag) and the merge is PARTIAL: members
    that do not answer are listed on the result's ``.unreachable``
    instead of failing the whole fan-out — one dead replica must not
    blind the operator to the rest of the fleet. Raises only when NO
    member answered."""
    import threading as _threading
    from multiverso_tpu_torch.obs.metrics import merge_stats
    from multiverso_tpu_torch.shard.partition import parse_shard_endpoints
    if timeout is None:
        timeout = float(get_flag("stats_timeout_seconds"))
    if replicas is None:
        replicas = getattr(endpoints, "replica_endpoints", None)
    endpoints = getattr(endpoints, "endpoints", endpoints)
    primary_eps = list(parse_shard_endpoints(endpoints))
    replica_eps = [str(e) for fleet in (replicas or []) for e in fleet]
    results: dict = {}
    lock = _threading.Lock()

    def probe(ep: str) -> None:
        try:
            snap = stats(ep, timeout=timeout)
        except (OSError, RuntimeError):
            snap = None
        with lock:
            results[ep] = snap

    all_eps = primary_eps + [e for e in replica_eps
                             if e not in primary_eps]
    threads = [_threading.Thread(target=probe, args=(ep,), daemon=True,
                                 name="mv-stats-probe")
               for ep in all_eps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 1.0)
    snaps = [results[e] for e in primary_eps
             if results.get(e) is not None]
    replica_snaps = {e: results[e] for e in replica_eps
                     if results.get(e) is not None}
    unreachable = [e for e in all_eps if results.get(e) is None]
    if not snaps and not replica_snaps:
        raise ConnectionError(
            f"stats_all: no endpoint answered within {timeout:.1f}s "
            f"({', '.join(all_eps)})")
    merged = merge_stats(snaps + list(replica_snaps.values()))
    merged.shards = snaps  # primaries only; replicas get their own view
    merged.replicas = replica_snaps
    merged.unreachable = unreachable
    return merged


def traces(endpoints: Any, timeout: Optional[float] = None,
           req_id: Optional[int] = None):
    """Pull and stitch cross-process traces: one slot-free
    ``Control_Traces`` probe per endpoint plus this process's own trace
    store, clock-corrected and merged into causally-ordered
    :class:`~multiverso_tpu_torch.obs.collector.StitchedTrace` spans
    (docs/observability.md). ``endpoints``: a list of host:port, a
    :class:`~multiverso_tpu_torch.shard.group.ShardGroup`, or a
    :class:`~multiverso_tpu_torch.shard.router.ShardedClient` layout —
    replica fleets are included automatically. Returns the stitched
    spans (all, or just ``req_id``'s), oldest first."""
    from multiverso_tpu_torch.obs.collector import TraceCollector
    eps = _fleet_endpoints(endpoints)
    collector = TraceCollector(eps, timeout=timeout)
    collector.collect()
    return collector.stitch(req_id)


def attribution(endpoints: Any, timeout: Optional[float] = None,
                quantile: Optional[float] = None,
                include_profiles: bool = True):
    """Fleet latency attribution (``mvt.attribution``): pull + stitch the
    fleet's traces, decompose every span into named critical-path
    segments (in-process stage gaps and ``wire:`` boundary crossings),
    and aggregate them into an
    :class:`~multiverso_tpu_torch.obs.critpath.AttributionReport` — the
    "p99 Get: 61% replica apply-lag wait, 22% wire" table. ``quantile``
    (e.g. ``0.99``) restricts aggregation to the slowest tail;
    ``include_profiles`` annotates the report with each process's
    sampling profile over the slot-free ``Control_Profile`` RPC."""
    from multiverso_tpu_torch.obs.critpath import fleet_attribution
    return fleet_attribution(_fleet_endpoints(endpoints), timeout=timeout,
                             quantile=quantile,
                             include_profiles=include_profiles)


def chargeback(endpoints: Any, timeout: Optional[float] = None,
               quantile: Optional[float] = None):
    """Fleet cost attribution BY TENANT (``mvt.chargeback``): pull +
    stitch the fleet's tenant-tagged traces and partition the same
    critical-path segments :func:`attribution` decomposes into a
    per-tenant table — share-of-fleet-time (sums to ~1.0), apply+WAL
    time, p99, bytes pushed, Adds admitted vs shed — the "which tenant
    bought which fraction of the machine" answer
    (docs/observability.md §Chargeback). Returns a
    :class:`~multiverso_tpu_torch.obs.chargeback.ChargebackReport`; call
    ``.display()`` to print it."""
    from multiverso_tpu_torch.obs.chargeback import fleet_chargeback
    return fleet_chargeback(_fleet_endpoints(endpoints), timeout=timeout,
                            quantile=quantile)


def top(endpoints: Any, timeout: Optional[float] = None,
        format: str = "text") -> str:
    """The live fleet view (``mvt.top``): one stats+watermark probe per
    serving endpoint, rendered as a terminal table (or ``format="html"``
    for a browser tab) of per-shard/per-replica roles, watermarks, lag,
    served request counts, Get p99 and burn-alert state, plus the local
    SLO engine's panel when one is running (obs/slo.py)."""
    from multiverso_tpu_torch.obs.slo import fleet_top
    return fleet_top(_fleet_endpoints(endpoints), engine=_slo_engine,
                     timeout=timeout, format=format)


def _fleet_endpoints(endpoints: Any) -> list:
    """Flatten a fleet handle — ShardGroup, layout manifest dict, list,
    or comma-string — into the full serving-endpoint list (primaries
    first, then replica fleets), deduplicated in order."""
    from multiverso_tpu_torch.shard.partition import parse_shard_endpoints
    replicas = getattr(endpoints, "replica_endpoints", None)
    if isinstance(endpoints, dict):  # a layout manifest
        replicas = list((endpoints.get("replicas") or {}).values())
        endpoints = endpoints.get("endpoints", [])
    eps = list(parse_shard_endpoints(
        getattr(endpoints, "endpoints", endpoints)))
    for fleet in (replicas or []):
        eps.extend(str(e) for e in fleet)
    seen: dict = {}
    for e in eps:
        seen.setdefault(e)
    return list(seen)


def stop_serving() -> None:
    """Stop the remote table server while keeping the runtime up. A later
    ``serve()`` binds fresh — the server-restart path: restart,
    ``checkpoint.restore_tables(...)`` (or ``durable_recover()``),
    ``serve()`` on the old endpoint, and reconnecting clients resume."""
    zoo = Zoo.instance()
    if zoo.remote_server is not None:
        zoo.remote_server.stop()
        zoo.remote_server = None
    if zoo.server is not None and zoo.server.wal is not None:
        zoo.server.wal.close()
        zoo.server.wal = None


def durable_recover(tables: Optional[Sequence[Any]] = None,
                    directory: Optional[str] = None):
    """Exactly-once restart recovery: load the manifest snapshot, replay
    the WAL — truncating any torn tail — and stage the replayed req-ids so
    the next ``serve()`` rebuilds its dedup window. Call after
    ``create_table`` (same order as before the crash) and BEFORE
    ``serve()``. Returns the
    :class:`~multiverso_tpu_torch.durable.wal.RecoveryResult`."""
    from multiverso_tpu_torch.durable.wal import recover
    zoo = Zoo.instance()
    directory = directory or str(get_flag("wal_dir"))
    if not directory:
        log.fatal("durable_recover: pass a directory or set the wal_dir "
                  "flag")
    source = list(tables) if tables is not None else list(zoo._worker_tables)
    result = recover(source, directory)
    zoo._dedup_seeds = result.seeds
    return result


def wal_writer():
    """The serving process's WAL writer (None until ``serve()`` runs with
    the ``wal_dir`` flag set) — pass it to ``CheckpointDriver(...,
    wal=mvt.wal_writer())`` so snapshots compact the log."""
    zoo = Zoo.instance()
    return zoo.server.wal if zoo.server is not None else None


def warm_standby(primary_endpoint: str, service_endpoint: str,
                 tables: Optional[Sequence[Any]] = None,
                 lease_seconds: Optional[float] = None,
                 takeover: bool = True):
    """Start a warm standby tailing ``primary_endpoint``'s WAL; on primary
    lease expiry it binds ``service_endpoint`` and clients fail over
    transparently (durable/standby.py). Returns the started
    :class:`~multiverso_tpu_torch.durable.standby.WarmStandby` — call
    ``.serve_reads()`` on it to promote it into a serving read replica.
    ``takeover=False`` builds a pure read replica: several can tail one
    primary without racing to bind its endpoint when it dies."""
    from multiverso_tpu_torch.durable.standby import WarmStandby
    return WarmStandby(primary_endpoint, service_endpoint, tables=tables,
                       lease_seconds=lease_seconds,
                       takeover=takeover).start()


def digest(endpoint: str, timeout: Optional[float] = None):
    """Per-table content digests of any serving endpoint — primary,
    replica, or standby serving reads — at its exact watermark:
    ``{"role", "endpoint", "watermark", "layout_version", "tables":
    {tid: {"digest", "rows"}}}``. Order-independent over (id,
    row-bytes), so primaries and replicas of either package compare equal
    iff their applied state is equal. Slot-free."""
    from multiverso_tpu_torch.runtime.remote import fetch_digest
    if timeout is None:
        timeout = float(get_flag("audit_timeout_seconds"))
    return fetch_digest(endpoint, timeout=timeout)


def audit(fleet, interval: Optional[float] = None,
          manifest: Optional[Dict[str, Any]] = None):
    """The continuous fleet auditor (obs/audit.py): compare
    primary↔replica state digests at a common watermark and check the
    acked-Add conservation ledger across probes; on mismatch fire
    ``AUDIT_DIVERGENCE`` through the flight-recorder path with both
    digests and the watermark vector attached. ``fleet`` is a primary
    endpoint, a list of them, or ``{"endpoints": [...], "replicas":
    [[...], ...]}``. Returns a
    :class:`~multiverso_tpu_torch.obs.audit.FleetAuditor` — already
    running in the background when ``interval`` (or the
    ``audit_interval_seconds`` flag) is > 0; call ``.check()`` yourself
    for a one-shot report."""
    from multiverso_tpu_torch.obs.audit import FleetAuditor
    auditor = FleetAuditor(fleet, interval=interval, manifest=manifest)
    if auditor.interval > 0:
        auditor.start()
    return auditor


def autopilot(group, interval: Optional[float] = None,
              auditor: Any = None, **kwargs: Any):
    """The fleet autopilot (``autopilot/``): a periodic control loop over
    a live :class:`~multiverso_tpu_torch.shard.group.ShardGroup` that
    reads the telemetry plane — per-shard heat, read-tier pressure,
    replica lag, tier hit rates, the SLO burn engine — and reshapes the
    fleet through the crash-safe machinery underneath: hot-shard splits
    and cold-range merges via the MigrationCoordinator (joiners on the
    group's device), live replica add/remove, tier budget rebalance.
    Pass the running ``mvt.audit`` auditor as ``auditor``: any
    ``AUDIT_DIVERGENCE`` freezes the loop until an operator ``.ack()``;
    every decision (and its rejected alternatives) lands in the flight
    recorder. Returns an :class:`~multiverso_tpu_torch.autopilot.Autopilot`
    — already ticking in the background when ``interval`` (or the
    ``autopilot_interval_seconds`` flag) is > 0; call ``.tick_now()``
    for deterministic drills, ``.status()`` for the operator view,
    ``.stop()`` to halt."""
    # the autopilot PACKAGE shares this name: importing it rebinds the
    # attribute to the module, which is callable with these exact
    # semantics (autopilot/__init__.py)
    import multiverso_tpu_torch.autopilot as _ap
    return _ap(group, interval=interval, auditor=auditor, **kwargs)


# -- sharded serving tier (shard/) -------------------------------------------
# Tables range/hash-sharded across serving processes, clients splitting
# requests and merging partial replies. A ShardGroup launches one serving
# process per shard (own WAL, leases, optional warm standby and replicas) on
# the group's device; clients route through a ShardedClient.

def serve_sharded(tables: Sequence[dict], shards: Optional[int] = None,
                  device: Optional[str] = None, **kwargs: Any):
    """Launch a shard group serving ``tables`` (declarative specs, e.g.
    ``[{"kind": "matrix", "num_row": 1 << 20, "num_col": 64}]``) across
    ``shards`` serving processes (default: the ``shards`` flag), each
    holding its tables on ``device`` (default: the ``device`` flag, so
    ``cuda`` unless the caller asks for the CPU). Each shard owns its
    slice of every table, its own lease table and dedup window, its own
    WAL dir (``durable=True``), optionally a warm standby
    (``standby=True``) and ``replicas`` read replicas (default: the
    ``replicas`` flag). Returns the started
    :class:`~multiverso_tpu_torch.shard.group.ShardGroup` — use
    ``.connect()`` for a routing client, ``.endpoints``/``.layout`` for
    bootstrap info, ``.stop()`` to tear down. Does NOT need ``init`` in
    the calling process (the shard children own their runtimes)."""
    from multiverso_tpu_torch.shard.group import ShardGroup
    return ShardGroup(tables, shards=shards, device=device,
                      **kwargs).start()


def reshard(group):
    """An elastic-membership coordinator for a live, durable shard group:
    ``reshard(group).split(k)`` / ``.merge(k)`` / ``.move(k)`` migrate
    key ranges under traffic with zero acknowledged-Add loss — fresh
    joiner processes (on the group's device) catch up over the donors'
    WAL streams, donors fence at a watermark cutover, and clients
    re-route in flight (:mod:`multiverso_tpu_torch.shard.reshard`)."""
    from multiverso_tpu_torch.shard.reshard import MigrationCoordinator
    return MigrationCoordinator(group)


def shard_connect(endpoints: Any = None, timeout: float = 30.0):
    """Connect to an existing shard group (of either package): fetch the
    layout manifest from the first reachable member (``Control_Layout``
    RPC), then build a :class:`~multiverso_tpu_torch.shard.router.
    ShardedClient` whose ``.table(table_id)`` proxies split Get/Add
    across the shards and merge the partial replies bit-identically to a
    single-server run. ``endpoints``: a host:port string, a list of them,
    or None to read the ``shard_endpoints`` flag (validated fail-fast).
    A client needs no ``init`` and no card."""
    from multiverso_tpu_torch.shard.partition import parse_shard_endpoints
    from multiverso_tpu_torch.shard.router import ShardedClient, fetch_layout
    if endpoints is None:
        endpoints = get_flag("shard_endpoints")
    candidates = parse_shard_endpoints(endpoints)
    errors = []
    for endpoint in candidates:
        try:
            layout = fetch_layout(endpoint, timeout=timeout)
            return ShardedClient(layout, timeout=timeout)
        except (OSError, TimeoutError, ConnectionError, RuntimeError) as exc:
            errors.append(f"{endpoint}: {exc!r}")
    log.fatal("shard_connect: no member answered the layout RPC (%s)",
              "; ".join(errors))


def cut_fleet(fleet, cut_id: Optional[str] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
    """Take a watermark-consistent cut of a serving fleet
    (durable/cut.py): fan the slot-free ``Control_Cut`` marker over
    every shard primary — each drains its dispatcher, snapshots at its
    ``WalWriter.seq`` fence, replies fence + digests — and commit the
    atomic fleet manifest under ``<base_dir>/cuts/``. ``fleet`` is a
    ShardGroup or its base_dir. Returns the committed manifest; raises
    (committing NOTHING) if any member failed mid-cut."""
    from multiverso_tpu_torch.durable.cut import cut_fleet as _cut
    return _cut(fleet, cut_id=cut_id, timeout=timeout)


def restore_fleet(manifest=None, base_dir: Optional[str] = None,
                  replicas: int = 0, standby: bool = False,
                  timeout: float = 240.0, device: Optional[str] = None):
    """Point-in-time recovery (durable/cut.py): bring up a fresh
    ShardGroup on ``device`` (default: the ``device`` flag) restored to a
    committed cut — every shard at the SAME manifest's fence, dedup
    windows seeded from the cut's acked-Add ledger. ``manifest`` is a cut
    manifest dict, a fleet base_dir (its LATEST cut), or a manifest path;
    a cut of either package's group restores. Returns the started
    ShardGroup."""
    from multiverso_tpu_torch.durable.cut import restore_fleet as _restore
    return _restore(manifest, base_dir=base_dir, replicas=replicas,
                    standby=standby, timeout=timeout, device=device)


def clone_fleet(source, base_dir: Optional[str] = None, replicas: int = 0,
                timeout: float = 240.0, device: Optional[str] = None):
    """Blue/green bring-up (durable/cut.py): bootstrap a fresh ShardGroup
    on ``device`` (default: the ``device`` flag) from a LIVE fleet — each
    clone shard absorbs one quiesced ``Control_Replicate`` transfer from
    its source primary, then serves under its own WAL lineage. ``source``
    is a ShardGroup, its base_dir, or a cut manifest (endpoints name the
    donors). Returns the started clone group."""
    from multiverso_tpu_torch.durable.cut import clone_fleet as _clone
    return _clone(source, base_dir=base_dir, replicas=replicas,
                  timeout=timeout, device=device)


# -- raw net mode (MV_NetBind / MV_NetConnect / MV_NetFinalize) --------------
# External hosts (the reference's ZMQ Bind/Connect mode,
# include/multiverso/multiverso.h:60-65) drive the transport directly
# without starting the PS runtime.

_raw_net = None


def net_bind(rank: int, endpoint: str) -> str:
    """Listen on ``host:port`` (port 0 → ephemeral); returns the bound
    endpoint."""
    global _raw_net
    from multiverso_tpu_torch.runtime.net import TcpNet
    if _raw_net is None:
        _raw_net = TcpNet()
    return _raw_net.bind(rank, endpoint)


def net_connect(endpoints: Optional[Sequence[str]] = None) -> None:
    """Provide the full rank→endpoint map; connections dial lazily. With no
    argument, the map is read from the ``machine_file`` flag (one host:port
    per line, zmq_net.h:234-254)."""
    if _raw_net is None:
        log.fatal("net_connect: call net_bind first")
    if endpoints is None:
        from multiverso_tpu_torch.runtime.net import parse_machine_file
        path = get_flag("machine_file")
        if not path:
            log.fatal("net_connect: no endpoints given and the machine_file "
                      "flag is empty")
        endpoints = parse_machine_file(path)
    _raw_net.connect(list(endpoints))


def net_finalize() -> None:
    global _raw_net
    if _raw_net is not None:
        _raw_net.finalize()
        _raw_net = None


def net():
    """The raw-net transport (None until net_bind)."""
    return _raw_net


# -- tables -----------------------------------------------------------------

from multiverso_tpu_torch.tables.array_table import ArrayServer, ArrayWorker  # noqa: E402,F401
from multiverso_tpu_torch.tables.kv_table import (  # noqa: E402,F401
    DeviceKVServer, KVServer, KVWorker, TieredKVServer, make_tiered_kv)
from multiverso_tpu_torch.tables.matrix_table import MatrixServer, MatrixWorker  # noqa: E402,F401
from multiverso_tpu_torch.tables.sparse_table import (  # noqa: E402,F401
    SparseWorker, TieredSparseServer, make_tiered_sparse)
from multiverso_tpu_torch.updaters import AddOption, GetOption  # noqa: E402,F401

ArrayTableHandler = ArrayWorker  # python-binding names
MatrixTableHandler = MatrixWorker

_TABLE_TYPES = {
    "array": ArrayWorker,
    "matrix": MatrixWorker,
    "kv": KVWorker,
    "sparse": SparseWorker,
    # beyond-RAM variants (store/)
    "tiered_sparse": make_tiered_sparse,
    "tiered_kv": make_tiered_kv,
}


def create_table(kind: str, *args: Any, **kwargs: Any):
    """``MV_CreateTable`` parity: construct a worker/server table pair (the
    server side registers with the dispatcher automatically)."""
    try:
        cls = _TABLE_TYPES[kind]
    except KeyError:
        log.fatal("unknown table kind %r (have: %s)", kind, sorted(_TABLE_TYPES))
    return cls(*args, **kwargs)


def register_table_type(kind: str, factory: Any) -> None:
    """Table-extension API: apps register custom tables."""
    _TABLE_TYPES[kind] = factory
