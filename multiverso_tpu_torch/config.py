"""Typed flag registry (port of ``multiverso_tpu/config.py``).

Same surface as the JAX package: ``define_*`` registration, ``-name=value``
CLI parsing that compacts argv (``parse_cmd_flags``), programmatic
``set_flag``/``get_flag``, and the ``on_change`` watch seam the dispatcher
uses to follow a live ``apply_batch_msgs``. Only the flags this package
reads are defined; the rest arrive with the modules that read them.

Flags are process-global, matching the reference's static registry, and
separate from the JAX package's registry.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class FlagError(ValueError):
    """Raised on unknown flag access or unparsable flag values."""


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("true", "1", "yes", "on"):
        return True
    if t in ("false", "0", "no", "off"):
        return False
    raise FlagError(f"cannot parse boolean flag value: {text!r}")


@dataclass
class _Flag:
    name: str
    value: Any
    default: Any
    parser: Callable[[str], Any]
    help_text: str


class FlagRegistry:
    """Thread-safe typed flag store. One global instance (`FLAGS`) mirrors the
    reference's static registry; separate instances exist for tests."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._lock = threading.RLock()
        # per-flag change watchers (on_change seam): cached hot-path readers
        # subscribe instead of polling get_flag
        self._watchers: Dict[str, List[Callable[[str, Any], None]]] = {}

    # -- registration ------------------------------------------------------
    def define(self, name: str, default: Any, parser: Callable[[str], Any],
               help_text: str = "") -> None:
        with self._lock:
            if name in self._flags:
                # Re-definition keeps the first registration, like static init.
                return
            self._flags[name] = _Flag(name, default, default, parser, help_text)

    def define_int(self, name: str, default: int, help_text: str = "") -> None:
        self.define(name, int(default), int, help_text)

    def define_bool(self, name: str, default: bool, help_text: str = "") -> None:
        self.define(name, bool(default), _parse_bool, help_text)

    def define_string(self, name: str, default: str, help_text: str = "") -> None:
        self.define(name, str(default), str, help_text)

    def define_double(self, name: str, default: float, help_text: str = "") -> None:
        self.define(name, float(default), float, help_text)

    # -- access ------------------------------------------------------------
    def get(self, name: str) -> Any:
        with self._lock:
            try:
                return self._flags[name].value
            except KeyError:
                raise FlagError(f"unknown flag: {name!r}") from None

    def set(self, name: str, value: Any) -> None:
        """Programmatic set (``MV_SetFlag`` parity). Accepts either the typed
        value or a string to be parsed with the flag's parser."""
        with self._lock:
            try:
                flag = self._flags[name]
            except KeyError:
                raise FlagError(f"unknown flag: {name!r}") from None
            if isinstance(value, str) and not isinstance(flag.default, str):
                new = flag.parser(value)
            else:
                new = type(flag.default)(value)
            changed = new != flag.value
            flag.value = new
        if changed:
            self._notify(name, new)

    def reset(self, name: Optional[str] = None) -> None:
        changed: List[tuple] = []
        with self._lock:
            flags = self._flags.values() if name is None else [self._flags[name]]
            for f in flags:
                if f.value != f.default:
                    changed.append((f.name, f.default))
                f.value = f.default
        for n, v in changed:
            self._notify(n, v)

    # -- change watchers ----------------------------------------------------
    def on_change(self, name: str,
                  callback: Callable[[str, Any], None]) -> Callable[[], None]:
        """Subscribe ``callback(name, new_value)`` to value changes of flag
        ``name`` (fired by set/reset/parse_cmd_flags, only when the value
        actually changes). Returns an unsubscribe function. Callbacks run
        OUTSIDE the registry lock (they may read other flags) and their
        exceptions are swallowed — a broken watcher must not poison set_flag."""
        with self._lock:
            if name not in self._flags:
                raise FlagError(f"unknown flag: {name!r}")
            self._watchers.setdefault(name, []).append(callback)

        def unsubscribe() -> None:
            with self._lock:
                cbs = self._watchers.get(name, [])
                try:
                    cbs.remove(callback)
                except ValueError:
                    pass

        return unsubscribe

    def _notify(self, name: str, value: Any) -> None:
        with self._lock:
            cbs = list(self._watchers.get(name, ()))
        for cb in cbs:
            try:
                cb(name, value)
            except Exception:
                pass

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._flags

    def items(self) -> Dict[str, Any]:
        with self._lock:
            return {k: f.value for k, f in self._flags.items()}

    # -- CLI ---------------------------------------------------------------
    def parse_cmd_flags(self, argv: Optional[List[str]]) -> List[str]:
        """Parse ``-key=value`` / ``--key=value`` tokens; unknown flags and
        non-flag tokens are kept, parsed flags are removed (argv compaction,
        matching the reference parser's contract)."""
        if not argv:
            return []
        remaining: List[str] = []
        for token in argv:
            if token.startswith("-") and "=" in token:
                key, _, raw = token.lstrip("-").partition("=")
                with self._lock:
                    flag = self._flags.get(key)
                    if flag is not None:
                        new = flag.parser(raw)
                        changed = new != flag.value
                        flag.value = new
                if flag is not None:
                    if changed:
                        self._notify(key, new)
                    continue
            remaining.append(token)
        return remaining


# Process-global registry (reference: static registry in configure.cpp).
FLAGS = FlagRegistry()

define_int = FLAGS.define_int
define_bool = FLAGS.define_bool
define_string = FLAGS.define_string
define_double = FLAGS.define_double
get_flag = FLAGS.get
set_flag = FLAGS.set
on_flag_change = FLAGS.on_change
parse_cmd_flags = FLAGS.parse_cmd_flags


define_string("device", "cuda",
              "torch device that holds every server table (one device is "
              "one server shard): 'cuda', 'cuda:<i>' or 'cpu'. init raises "
              "when a CUDA device is asked for and none is present")
define_string("ps_role", "default", "node role: worker|server|default(all)|none")
define_bool("ma", False, "model-averaging mode: skip PS tables, aggregate() only")
define_bool("sync", False, "synchronous (BSP) parameter server")
define_int("ssp_staleness", -1,
           "stale-synchronous-parallel bound: a worker's Get waits until "
           "every unfinished worker is within this many add-rounds of it "
           "(0 = BSP-like read gate; -1 disables). Ignored when sync=True")
define_double("backup_worker_ratio", 0.0,
              "fraction of workers treated as backups: the BSP round gates "
              "ignore the slowest floor(ratio*num_workers) workers' clocks")
define_double("sync_stall_seconds", 30.0,
              "BSP watchdog period: log which workers' clocks are holding a "
              "round when deferred requests make no progress; 0 disables")
define_bool("deterministic", False,
            "async PS applies adds in (round, worker_id) order so the final "
            "table state is bitwise reproducible (DeterministicServer)")
define_int("omp_threads", 4, "host-side worker threads for CPU fallbacks "
           "(the logistic-regression readers' parse pool)")
define_string("updater_type", "default", "server-side optimizer: default|sgd|adagrad|momentum_sgd|dcasgd")
define_bool("is_pipelined", False, "double-buffered pipelined get")
define_int("allocator_alignment", 16, "host buffer alignment (native allocator)")
define_string("allocator_type", "smart", "host allocator: smart|default")
define_int("local_workers", 1, "logical worker contexts hosted by this process")
define_int("remote_workers", 0,
           "expected off-process worker clients (serve() / "
           "remote_connect()); they get worker ids after all local "
           "contexts")
# The multi-process lockstep world (runtime/multihost.py) and its rank
# mesh (parallel/mesh.py), as in the JAX package.
define_string("multihost_endpoint", "",
              "host:port the leader (rank 0 of the torch.distributed "
              "world) binds for the multihost lockstep control plane; same "
              "value on every process")
define_double("multihost_timeout", 120.0,
              "multihost control-plane connect/barrier timeout (seconds); "
              "also the process group's collective timeout")
define_int("multihost_window", 64,
           "max follower-origin table ops in flight to the leader before "
           "the forwarding worker blocks (windowed pipelined control "
           "plane; acks complete out of a reorder buffer). 0 = unbounded")
define_string("multihost_token", "",
              "shared secret authenticating multihost control-plane "
              "handshakes (HMAC-SHA256 over the hello frames); empty gives "
              "integrity-only framing — see docs/multihost.md trust model")
define_string("mesh_shape", "",
              "rank mesh shape, e.g. '2x2'; empty = auto 1-D over the "
              "world's ranks (one device per rank)")
define_string("mesh_axes", "server", "comma-separated mesh axis names")
define_int("apply_batch_msgs", 64,
           "max queued Adds the dispatcher fuses into ONE table apply per "
           "drain (runtime/server.py): the async server drains its queue "
           "each wakeup, groups Adds by table, merges duplicate rows and "
           "applies each group as a single row-scatter kernel launch. "
           "0 = per-message dispatch")
define_int("apply_batch_rows", 16384,
           "max rows one fused matrix apply covers: the merge consumes a "
           "prefix of the drained group up to this many rows and the rest "
           "fuse in the next call — bounds the power-of-two id bucket (and "
           "its zero-padded upload). 0 = unbounded")

# Tiered beyond-RAM storage (store/): hot/cold row tiers for the sparse and
# KV table kinds, as in the JAX package.
define_int("tier_resident_bytes", 64 << 20,
           "hot-tier byte budget per tiered table: row payload bytes kept "
           "RAM-resident; the LRU tail past it is demoted to quantized "
           "cold segments on disk")
define_int("tier_cold_bits", 8,
           "quantization width for cold-tier rows (1/2/4/8, float32 tables "
           "only; lossy by at most step/2 per element); 0 stores raw bytes "
           "(lossless, any dtype)")
define_string("tier_dir", "",
              "cold-tier spill root (one root per process): each tiered "
              "table spills under <tier_dir>/tier<ordinal>, reused and "
              "wiped across restarts. Empty = a fresh temporary directory "
              "per table (the spill lives as long as the process)")
define_int("tier_admit_touches", 2,
           "frequency-sketch touches a cold key needs before a Get promotes "
           "it back to the hot tier (second-chance admission: a one-shot "
           "scan cannot thrash the hot working set); Adds always promote")

# Sampling profiler (obs/profiler.py)
define_double("profile_hz", 50.0,
              "sampling rate of the profiler's frame walker (samples per "
              "second over sys._current_frames()); values <= 0 fall back "
              "to 50")
define_int("profile_max_frames", 24,
           "stack-depth cap per collapsed (flamegraph) stack; deeper "
           "stacks keep their leaf-most frames")

# Serving over the wire (runtime/{wire,shm,net,remote}.py), the fault
# core (fault/), tracing and the flight recorder (obs/trace.py) and the
# overload layer (runtime/admission.py), with the JAX package's names and
# defaults.
define_int("wire_quant_bits", 0,
           "quantize remote ADD deltas to this many bits per value "
           "(1|2|4|8) with client-side error feedback — the OneBitsFilter "
           "slot, generalized; 0 disables")

define_int("wire_coalesce_frames", 64,
           "max frames one vectored send syscall carries on the host wire "
           "(runtime/net.py drain loop): frames queued while a send is in "
           "flight flush together via socket.sendmsg. 0 = legacy per-frame "
           "sendall (also disables the zero-copy queue)")

define_int("wire_coalesce_bytes", 1 << 20,
           "max payload bytes one coalesced send syscall carries; a frame "
           "larger than this still ships alone (never split). 0 = legacy "
           "per-frame sendall")

define_bool("wire_shm", False,
            "negotiate a shared-memory ring transport at connect for "
            "colocated client/server processes (runtime/shm.py): same v3 "
            "framing + CRC + req-id contract as TCP, so dedup/retransmit/"
            "tracing/chaos seams are unchanged; falls back to TCP "
            "transparently when the peer is remote, has the flag off, or "
            "cannot map the segment")

define_int("wire_shm_bytes", 4 << 20,
           "shared-memory ring capacity per direction (bytes, rounded to "
           "a multiple of 8); frames larger than the ring stream through "
           "it in chunks")

define_int("wire_shm_spin", 20,
           "busy-spin iterations of the shm ring wait ladder before it "
           "starts yielding (then sleeping): the latency/CPU-burn knob; "
           "read when a ring is mapped. 0 = yield immediately")

define_string("wire_shm_dir", "",
              "directory for shm ring segment files; empty = /dev/shm "
              "when present, else the system temp dir")

define_string("machine_file", "", "multi-host machine list (external transport)")

define_int("port", 55555, "external transport port")

define_string("fault_spec", "",
              "fault-injection schedule applied to host transports "
              "(fault/inject.py): ';'-separated rules "
              "'action:key=val,key=val' with actions drop|delay|dup|reorder|"
              "partition, predicates src/dst/type/table and limiters "
              "first/after/every/prob (delay takes seconds=). Empty disables")

define_int("fault_seed", 0,
           "seed for probabilistic fault rules (prob=) so chaos runs replay")

define_double("request_retry_seconds", 5.0,
              "remote client retransmit timeout: a correlated request with "
              "no reply after this long is re-sent (exponentially backed "
              "off); the server's req-id dedup window keeps the replay "
              "idempotent. 0 disables retransmission")

define_double("reconnect_deadline_seconds", 20.0,
              "total budget for a remote client's reconnect-and-resume "
              "after a connection loss before pending requests fail; "
              "0 restores the fail-fast posture (no reconnect)")

define_double("retry_base_seconds", 0.05,
              "reconnect backoff base: attempt k sleeps "
              "~base*2^(k-1), jittered, capped by retry_cap_seconds")

define_double("retry_cap_seconds", 2.0,
              "upper bound on a single reconnect backoff sleep")

define_double("heartbeat_seconds", 2.0,
              "remote client lease-renewal period (Control_Heartbeat); "
              "0 disables heartbeats (disable lease eviction too)")

define_double("lease_seconds", 10.0,
              "remote worker lease: the sync watchdog evicts a worker whose "
              "last sign of life (heartbeat or any request) is older than "
              "this, releasing BSP/SSP rounds it was holding; 0 disables")

define_int("dedup_window", 4096,
           "server-side request-id dedup window (entries) bounding the "
           "idempotent-replay cache for retried remote requests")

# Durability subsystem (multiverso_tpu_torch/durable/): WAL + restart
# recovery + warm-standby failover.
define_string("wal_dir", "",
              "durability root: when set, serve() write-ahead-logs every "
              "remote Add (CRC-checksummed records under <wal_dir>/wal/) "
              "before it is ACKed; restart recovery = mv.durable_recover() "
              "(snapshot + WAL replay + dedup-window rebuild), compaction "
              "= CheckpointDriver(..., wal=mv.wal_writer()). Empty disables")
define_string("wal_sync", "batch",
              "WAL durability barrier per append: none (buffered — the "
              "tail can be lost even to a process crash), batch (flush to "
              "the OS — survives kill -9, not power loss; the default), "
              "always (fsync — survives power loss, slowest)")

# Read-replica serving tier (durable/standby.py serve loop + runtime/read.py
# client-side cache and routing).
define_string("read_preference", "primary",
              "where a remote client's Gets go: primary (every Get takes "
              "a primary worker slot — the pre-replica behavior), replica "
              "(round-robin over read replicas whose replay watermark "
              "satisfies the staleness budget, falling back to the "
              "primary when none qualifies), hedged (replica, plus a "
              "second endpoint fired after a p95-derived delay; first "
              "reply wins, the loser is cancelled)")
define_int("read_staleness_records", 1024,
           "staleness budget for replica-served Gets, in WAL records: a "
           "replica may answer only while its replay watermark is within "
           "this many records of the primary's append watermark "
           "(generalized SSP bound — clocks become reads); -1 = unbounded "
           "(any live replica answers)")
define_int("client_cache_bytes", 0,
           "client-side bounded-staleness read cache capacity (bytes, "
           "LRU by table/key): a cached Get is served without touching "
           "the wire while its watermark stays within "
           "read_staleness_records of the newest watermark the client "
           "has observed AND its lease (read_lease_seconds) is live. "
           "0 disables the cache")
define_double("read_lease_seconds", 0.25,
              "client cache entry lease: the blind window during which a "
              "cached read may be re-served without any wire contact "
              "(watermark invalidation still applies the instant a newer "
              "watermark is observed)")
define_double("read_timeout_seconds", 1.0,
              "deadline for one replica read attempt before the client "
              "falls back (next replica, then primary); also the cap on "
              "the hedged second-fire delay")
define_double("read_hedge_ms", 0.0,
              "hedged-read second-fire delay in milliseconds; 0 derives "
              "it from the p95 of recent replica read latencies")

define_string("flight_recorder_path", "",
              "append flight-recorder dumps (event + dashboard snapshot + "
              "the last flight_recorder_traces per-request hop traces, one "
              "JSON object per line) to this file on worker eviction, "
              "standby failover, frame CRC reject, or a client failing all "
              "pending requests. Empty disables dumping")

define_int("flight_recorder_traces", 256,
           "how many recent request traces each flight-recorder dump "
           "includes (the in-memory trace ring holds at least this many)")

define_bool("trace_requests", True,
            "stamp the v4 header's trace flag on every correlated "
            "request, so forwarded/derived frames (router parts, read "
            "confirms, multihost forwards) keep recording under the "
            "originating req_id; hop recording itself is always on for "
            "nonzero req_ids — this flag only controls propagation")

define_bool("trace_read_confirm", True,
            "a traced replica-served Get additionally fires a slot-free "
            "Control_Watermark frame at the primary stamped with the "
            "SAME req_id — the trace then spans client, replica AND the "
            "primary watermark path, and the client's cache horizon "
            "advances off the authoritative append watermark")

define_int("trace_export_max", 256,
           "how many recent traces a Control_Traces reply ships (each "
           "process's trace ring holds 512)")

define_int("flight_recorder_max_bytes", 64 << 20,
           "size cap for the flight_recorder_path file: once it is at "
           "least this large, further dumps are suppressed (counted in "
           "FLIGHT_DUMPS_SUPPRESSED) instead of filling the disk; "
           "0 = unlimited")

define_double("flight_recorder_min_interval_seconds", 0.0,
              "per-REASON rate limit for flight-recorder dumps: a dump "
              "whose reason fired within this many seconds is suppressed "
              "(counted in FLIGHT_DUMPS_SUPPRESSED); 0 disables the "
              "rate limit — a flapping alert should set this to O(10s)")

define_double("audit_interval_seconds", 0.0,
              "period of the continuous fleet auditor (mv.audit): every "
              "interval it pulls Control_Digest from each primary and "
              "replica, compares them at a common watermark and fires "
              "AUDIT_DIVERGENCE through the flight-recorder path on "
              "mismatch; 0 = one-shot checks only (no background thread)")
define_double("audit_timeout_seconds", 30.0,
              "per-endpoint timeout for Control_Digest / Control_Cut "
              "probes: a dead or wedged member lands on the audit "
              "report's unreachable list (or fails the cut) instead of "
              "hanging the coordinator")

define_int("metrics_shard", -1,
           "this process's shard index for Prometheus labels "
           "(mvtpu_*{shard=...}); -1 omits the label")

define_string("metrics_role", "",
              "this process's serving role for Prometheus labels "
              "(primary|replica|standby); empty omits the label. serve() "
              "and replica/standby startup set it when unset")

define_string("trace_dir", "",
              "record a torch.profiler trace of the whole run: started at "
              "init, written at shutdown into this directory as a Chrome "
              "trace (trace_<pid>.json). Empty disables")

define_double("request_deadline_seconds", 0.0,
              "per-request deadline budget clients stamp on correlated "
              "requests (Get/Add/Read); it rides the wire header as "
              "REMAINING microseconds, re-anchored on each receiver's "
              "monotonic clock, and the server dispatcher drops expired "
              "work at drain time with deadline_exceeded instead of "
              "applying it. 0 = no deadline (legacy peers' 0-stamped "
              "frames are likewise never refused)")

define_bool("priority_lanes", True,
            "stably sort each dispatcher drain into lanes: serving reads "
            "(admin/slot-free Gets) > control > training traffic. Stable "
            "within a lane, so per-worker FIFO is preserved; forced off "
            "on the deterministic server (arrival-order WAL contract)")

define_int("admission_queue_limit", 0,
           "dispatcher backlog (messages) above which the admission gate "
           "sheds wire training writes with a truthful 'shed: ...' reply "
           "(serving reads shed only at 4x this limit — brownout before "
           "blackout). 0 disables backlog shedding")

define_string("tenant_quota_spec", "",
              "per-tenant write-admission quotas keyed by table "
              "namespace: ';'-separated "
              "name:tables=<id>|<id>,qps=<rate>[,burst=<cap>] entries — "
              "a tenant that exhausts its token bucket has its own Adds "
              "shed (TENANT_<name>_SHED) without touching other tenants "
              "or the serving lane. Empty = no quotas")

define_double("retry_budget_tokens", 0.0,
              "per-connection retry budget: token bucket capacity spent "
              "by retransmits, read hedges, and layout re-fetches, "
              "refilled retry_budget_ratio per success — under overload "
              "retry pressure decays to the refill rate instead of "
              "storming. A denial defers the retry (never fails the "
              "request) and counts RETRY_BUDGET_DENIALS. 0 = unlimited")

define_double("retry_budget_ratio", 0.1,
              "retry-budget refill per successful reply (tokens); the "
              "steady-state retry rate is bounded at this fraction of "
              "the success rate")

define_int("breaker_failures", 0,
           "consecutive request failures (retransmit timeouts, "
           "connection-loss recoveries) that trip a client connection's "
           "circuit breaker open: writes fail fast with a truthful "
           "'circuit open' error and reads stop falling back to the "
           "primary (replicas keep serving) until a half-open probe "
           "succeeds. 0 disables the breaker")

define_double("breaker_reset_seconds", 5.0,
              "how long a tripped breaker stays open before admitting "
              "one half-open probe; the probe's outcome closes or "
              "re-opens it")

# Time-series recorder (obs/timeseries.py): the hot-range detector reads
# its windows.
define_double("timeseries_interval_seconds", 1.0,
              "seconds between time-series recorder samples of every "
              "registered counter/gauge/histogram; 0 disables the "
              "sampler thread (manual sample_now() still works)")
define_int("timeseries_samples", 600,
           "ring-buffer length per metric in the time-series recorder "
           "(retention = this many * timeseries_interval_seconds)")

# Sharded serving tier (multiverso_tpu_torch/shard/): table partitioning,
# client-side router, shard groups with per-shard failover
# (port of the JAX package's flags: same names, defaults and help).
define_int("shards", 0,
           "shard count for sharded serving (mv.serve_sharded spawns one "
           "serving process per shard); 0 = unsharded single server")
define_string("shard_partitioner", "auto",
              "partitioner for key tables in a shard group: auto|range|"
              "hash (array/matrix rows are always range-partitioned); "
              "unknown values fail fast with the accepted set")
define_string("shard_endpoints", "",
              "comma-separated host:port members of an existing shard "
              "group — mv.shard_connect() bootstraps the layout manifest "
              "from the first reachable member; entries are validated "
              "fail-fast")
# Elastic membership / live key-range migration (shard/reshard.py:
# split/merge/move under traffic; docs/sharding.md §live migration).
define_bool("auto_reshard", False,
            "let the hot-range detector EXECUTE the splits it proposes "
            "(MigrationCoordinator.maybe_autosplit); off, detection only "
            "proposes (RESHARD_PROPOSALS counter + log line)")
define_double("reshard_hot_ratio", 3.0,
              "hot-range detector threshold: a shard proposes for a split "
              "when its request rate exceeds this multiple of the median "
              "shard's rate over the observation window")
define_double("reshard_min_qps", 50.0,
              "hot-range detector floor: shards below this request rate "
              "never propose a split regardless of skew (splitting an "
              "idle group is churn, not balance)")
define_double("reshard_cold_qps", 5.0,
              "cold-range detector ceiling: two ADJACENT shards both "
              "below this request rate propose a merge (the inverse of "
              "the split path — an over-split group wastes processes)")
# Fleet autopilot (multiverso_tpu_torch/autopilot/): the control loop that
# reads the telemetry plane and reshapes the fleet (docs/autopilot.md).
define_double("autopilot_interval_seconds", 5.0,
              "autopilot control-loop tick period; <= 0 disables the "
              "background thread (tick_now() still works for drills)")
define_int("autopilot_hysteresis_ticks", 2,
           "consecutive ticks a condition must hold before the autopilot "
           "acts on it — one noisy sample must not resize the fleet")
define_double("autopilot_cooldown_seconds", 60.0,
              "per-action cooldown after the autopilot executes (or "
              "fails) an action of that kind; re-deciding inside the "
              "window is recorded as a rejected alternative")
define_double("autopilot_window_seconds", 30.0,
              "observation window the autopilot's sensors read rates "
              "and per-shard heat over (also the hot-range detector's "
              "window when the autopilot constructs it)")
define_int("autopilot_max_replicas", 4,
           "ceiling on serving read replicas per shard the autopilot "
           "may scale up to")
define_int("autopilot_min_replicas", 0,
           "floor on serving read replicas per shard the autopilot may "
           "scale down to")
define_double("autopilot_hedge_rate", 5.0,
              "read-tier pressure threshold (hedges + refusals + "
              "primary fallbacks per second): sustained pressure above "
              "this proposes adding a read replica")
define_double("autopilot_scaledown_qps", 1.0,
              "fleet-wide request-rate floor: sustained traffic below "
              "this proposes removing a read replica (down to "
              "autopilot_min_replicas)")
define_double("autopilot_tier_target_hit_rate", 0.90,
              "tiered-store hot-tier hit-rate target: sustained hit "
              "rate below this grows the resident budget by "
              "autopilot_tier_step_bytes (up to autopilot_tier_max_bytes)")
define_int("autopilot_tier_step_bytes", 16 << 20,
           "bytes the autopilot grows/shrinks the tier_resident_bytes "
           "budget by per rebalance action")
define_int("autopilot_tier_max_bytes", 512 << 20,
           "ceiling the autopilot may grow tier_resident_bytes to")
define_bool("autopilot_blue_green", False,
            "rehearse risky topology changes (split/merge) on an "
            "mv.clone_fleet canary before executing them live; off, the "
            "autopilot executes directly through the crash-safe "
            "MigrationCoordinator path")
# Self-tuning runtime (multiverso_tpu_torch/tune/): attribution-driven
# feedback controller that steps the perf knobs above and reverts
# regressions (docs/autotune.md).
define_bool("autotune", False,
            "start the KnobController inside mv.init: a windowed "
            "sense→propose→step→verify loop that reads the profiler's "
            "wait sites + the time-series windows, steps ONE bounded perf "
            "knob at a time (apply_batch_msgs, wire_coalesce_*, "
            "wire_quant_bits, wire_shm_spin, read_hedge_ms, "
            "client_cache_bytes, tier_admit_touches) and reverts any step "
            "whose windowed objective regresses. Off = bit-identical "
            "runtime (no thread, no TUNE_* metrics)")
define_double("autotune_interval_seconds", 2.0,
              "KnobController tick period; <= 0 disables the background "
              "thread (tick_now() still works for drills and bench legs)")
define_double("autotune_window_seconds", 10.0,
              "observation window the tuner's sensors read wait-site "
              "deltas, rates and latency quantiles over (also the "
              "objective's measurement window)")
define_int("autotune_hysteresis_ticks", 2,
           "consecutive ticks a dominant cost must hold before the tuner "
           "steps the mapped knob — one noisy sample must not move a flag")
define_double("autotune_cooldown_seconds", 10.0,
              "per-knob cooldown after a committed or reverted step; "
              "re-proposing inside the window is recorded as a rejected "
              "alternative in the decision trail")
define_int("autotune_verify_ticks", 2,
           "ticks the tuner waits after stepping a knob before comparing "
           "the windowed objective against the pre-step baseline (the "
           "verify phase; no other knob moves while one is in flight)")
define_double("autotune_regress_pct", 5.0,
              "objective regression tolerance: a stepped knob whose "
              "verify-phase objective lands more than this percent below "
              "the pre-step baseline is reverted (TUNE_REVERTS) and its "
              "direction cooled down; within tolerance it commits")
# Read replicas a shard group runs per shard (shard/group.py).
define_int("replicas", 0,
           "serving read replicas per shard in a shard group (each tails "
           "the primary's WAL and answers slot-free watermark-stamped "
           "Gets); 0 = none. Implies durability (replication tails the "
           "WAL)")

# The rest of the observability plane (obs/{logger,collector,critpath,
# chargeback,slo}.py, fault/lockcheck.py), with the JAX package's names
# and defaults.
define_string("metrics_path", "",
              "append periodic JSONL dashboard snapshots (monitors, "
              "counters, gauges, histograms as bucket arrays) to this file "
              "— the format bench.py's load_metrics ingests. Empty disables "
              "the MetricsLogger thread")
define_double("metrics_interval_seconds", 10.0,
              "seconds between metrics_path snapshot lines")
define_string("slo_spec", "",
              "declarative SLOs, ';'-separated: "
              "name:histogram=H,p=0.99,target=SEC[,windows=SHORT/LONG] | "
              "name:counter=C,target=PER_SEC[,windows=...] | "
              "name:gauge=G,target=VALUE. A firing burn alert increments "
              "SLO_BURN_ALERTS and triggers a tagged flight-recorder "
              "dump. Empty disables the engine")
define_double("slo_check_interval_seconds", 5.0,
              "seconds between SLO engine evaluations; 0 disables the "
              "engine thread (manual evaluate_now() still works)")
define_bool("profile_continuous", False,
            "start the process-wide sampling profiler inside mvt.init and "
            "feed PROFILE_* counters/gauges into the dashboard (and so "
            "the time-series recorder) on every sampling pass")
define_bool("profile_on_alert", True,
            "attach a sampling-profiler report to every slo_burn flight "
            "dump: the continuous profiler's report when it is running, "
            "otherwise a short synchronous burst capture (~50ms)")
define_bool("profile_annotations", False,
            "wrap dashboard monitor sections in torch.profiler "
            "record_function scopes so SERVER_PROCESS_* sections show up "
            "by name in profiler traces")
define_double("stats_timeout_seconds", 5.0,
              "per-endpoint timeout for the mvt.stats_all fan-out: a dead "
              "or wedged endpoint lands on the merged snapshot's "
              "unreachable list instead of stalling the whole probe")
define_double("deadline_tighten_ratio", 0.0,
              "floor fraction of request_deadline_seconds the client "
              "shrinks minted deadlines toward while the SLO burn engine "
              "fires (geometric per-mint steps both down and back up, "
              "every transition flight-recorded) so backlog age tracks "
              "the error budget. 0 disables: minting is bit-identical to "
              "the plain request_deadline_seconds path")
