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
define_int("local_workers", 1, "logical worker contexts hosted by this process")
define_int("remote_workers", 0,
           "expected off-process worker clients; they get worker ids after "
           "all local contexts (serving over the wire is not yet ported)")
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
