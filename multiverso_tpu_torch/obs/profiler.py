"""Sampling profiler: the "why is it slow" half of the observability plane
(port of ``multiverso_tpu/obs/profiler.py``).

Two cooperating pieces live here:

* A **wait-site registry** — a per-thread tag (``mark_wait`` /
  ``clear_wait`` / the ``wait_site`` context manager) that blocking code
  paths set around the six canonical places a multiverso thread parks:
  lock acquisition (``fault/lockcheck.py``), socket reads
  (``runtime/net.py:_read_exact``), WAL fsync (``durable/wal.py``),
  dispatcher queue drain (``runtime/server.py``), the shm ring
  backoff ladder (``runtime/shm.py``), and cold-tier segment fetches
  (``store/coldstore.py``).  Of those modules the port has the cold
  store so far; the query engine marks ``query_scan`` too.  Marking
  costs two dict operations under the GIL and is paid whether or not a
  profiler is running, so the hooks are always-on and essentially free.

* A **sampling profiler** — :class:`SamplingProfiler` walks
  ``sys._current_frames()`` at ``profile_hz`` from a daemon thread,
  classifies every thread sample as on-CPU or off-CPU (tagged wait site
  first, then a blocking-top-frame heuristic), and accumulates
  per-thread self-time, per-wait-site seconds, and collapsed
  (flamegraph) stacks.  ``sample_once()`` is the deterministic seam —
  tests drive it directly, the sampler thread is just a clock.  With
  ``emit_metrics`` each pass feeds ``PROFILE_*`` gauges into the
  Dashboard; ``capture_for_alert`` hands a flight dump a profile.  The
  JAX package's continuous mode, time series and SLO engine are not
  ported yet.

The module deliberately imports nothing from ``runtime/`` and imports
``config``/``dashboard`` lazily, so any module — including the lock
wrappers that are patched in before the package finishes importing —
can depend on the registry without cycles.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Canonical wait-site names, in the order they appear in the docs.
WAIT_SITES = (
    "lock_acquire",       # fault/lockcheck.py  _CheckedLock.acquire
    "net_recv",           # runtime/net.py      _read_exact
    "wal_fsync",          # durable/wal.py      WriteAheadLog.append sync
    "dispatcher_drain",   # runtime/server.py   Server._main pop_all
    "shm_ring_spin",      # runtime/shm.py      Ring read/write backoff
    "tier_cold_fetch",    # store/coldstore.py  ColdStore segment read+decode
)

# thread ident -> wait-site name.  Mutated with single dict ops only
# (atomic under the GIL); read by the sampler without a lock.
_WAIT: Dict[int, str] = {}


def mark_wait(site: str) -> Optional[str]:
    """Tag the calling thread as blocked at ``site``; returns the
    previous tag so nested sites restore correctly via ``clear_wait``."""
    ident = threading.get_ident()
    prev = _WAIT.get(ident)
    _WAIT[ident] = site
    return prev


def clear_wait(prev: Optional[str] = None) -> None:
    """Drop the calling thread's wait tag (or restore the outer one)."""
    ident = threading.get_ident()
    if prev is None:
        _WAIT.pop(ident, None)
    else:
        _WAIT[ident] = prev


def current_wait(ident: Optional[int] = None) -> Optional[str]:
    """The wait-site tag for ``ident`` (default: calling thread)."""
    return _WAIT.get(threading.get_ident() if ident is None else ident)


class wait_site:
    """``with wait_site("net_recv"): sock.recv(...)`` — exception-safe
    mark/clear around a single blocking call."""

    __slots__ = ("site", "_prev")

    def __init__(self, site: str) -> None:
        self.site = site

    def __enter__(self) -> "wait_site":
        self._prev = mark_wait(self.site)
        return self

    def __exit__(self, *exc) -> bool:
        clear_wait(self._prev)
        return False


# Top-frame function names that mean "this thread is parked in the
# runtime, not burning CPU" — the fallback when no wait-site tag is set
# (e.g. a thread blocked in Event.wait or selector poll we don't wrap).
_BLOCKING_FRAMES = frozenset({
    "wait", "_wait_for_tstate_lock", "acquire", "select", "poll",
    "epoll", "accept", "recv", "recv_into", "recvfrom", "read",
    "readinto", "sleep", "get", "join", "sendall", "connect",
})


def _frame_label(frame) -> str:
    stem = os.path.splitext(os.path.basename(frame.f_code.co_filename))[0]
    return "%s.%s" % (stem, frame.f_code.co_name)


class SamplingProfiler:
    """Low-overhead statistical profiler over ``sys._current_frames()``.

    All accumulation happens in :meth:`sample_once`, which tests call
    directly; :meth:`start` merely spawns a daemon thread that calls it
    at ``hz``.  Weights are seconds-per-sample (``1/hz``), so the
    per-thread and per-site totals read as wall-clock attributions.
    """

    def __init__(self, hz: Optional[float] = None,
                 max_frames: Optional[int] = None,
                 emit_metrics: bool = False) -> None:
        if hz is None or max_frames is None:
            from multiverso_tpu_torch import config
            if hz is None:
                hz = config.get_flag("profile_hz")
            if max_frames is None:
                max_frames = config.get_flag("profile_max_frames")
        self.hz = float(hz)
        if self.hz <= 0:
            self.hz = 50.0
        self.max_frames = int(max_frames)
        self.emit_metrics = emit_metrics
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_ns = 0
        self._samples = 0
        self._stacks: Dict[str, int] = {}
        self._threads: Dict[str, Dict] = {}
        self._wait_seconds: Dict[str, float] = {}

    # -- lifecycle ----------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def samples(self) -> int:
        return self._samples

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        self._started_ns = time.time_ns()
        self._thread = threading.Thread(
            target=self._run, name="mv-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            self._stop.set()
            thread.join(timeout=2.0)

    def reset(self) -> None:
        with self._lock:
            self._samples = 0
            self._stacks.clear()
            self._threads.clear()
            self._wait_seconds.clear()

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:
                pass  # a torn frame walk must never kill the sampler

    # -- sampling -----------------------------------------------------

    def sample_once(self, weight: Optional[float] = None) -> Dict:
        """Take one sampling pass over every live thread.

        Returns a per-pass summary (``on_cpu``/``off_cpu`` thread counts
        and the wait sites observed) so tests can assert deterministic
        attribution without a sampler thread running.
        """
        w = (1.0 / self.hz) if weight is None else float(weight)
        me = threading.get_ident()
        sampler = self._thread.ident if self._thread is not None else None
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        on_cpu = 0
        off_cpu = 0
        seen_sites: Dict[str, int] = {}
        with self._lock:
            self._samples += 1
            for ident, frame in frames.items():
                if ident == me or ident == sampler:
                    continue
                name = names.get(ident, "tid-%d" % ident)
                site = _WAIT.get(ident)
                if site is None and \
                        frame.f_code.co_name in _BLOCKING_FRAMES:
                    site = "blocked:%s" % frame.f_code.co_name
                info = self._threads.setdefault(
                    name, {"on_cpu": 0.0, "off_cpu": 0.0, "waits": {}})
                if site is None:
                    on_cpu += 1
                    info["on_cpu"] += w
                else:
                    off_cpu += 1
                    info["off_cpu"] += w
                    info["waits"][site] = info["waits"].get(site, 0.0) + w
                    seen_sites[site] = seen_sites.get(site, 0) + 1
                    if not site.startswith("blocked:"):
                        self._wait_seconds[site] = \
                            self._wait_seconds.get(site, 0.0) + w
                stack = self._collapse(name, frame, site)
                self._stacks[stack] = self._stacks.get(stack, 0) + 1
        if self.emit_metrics:
            self._emit(on_cpu, off_cpu)
        return {"on_cpu": on_cpu, "off_cpu": off_cpu, "sites": seen_sites}

    def _collapse(self, thread_name: str, frame, site: Optional[str]) -> str:
        labels: List[str] = []
        f = frame
        while f is not None:
            labels.append(_frame_label(f))
            f = f.f_back
        labels.reverse()  # root first, flamegraph convention
        if len(labels) > self.max_frames:
            labels = labels[-self.max_frames:]
        if site is not None:
            labels.append("[wait:%s]" % site)
        return ";".join([thread_name] + labels)

    def _emit(self, on_cpu: int, off_cpu: int) -> None:
        from multiverso_tpu_torch.dashboard import count, gauge_set
        count("PROFILE_SAMPLES")
        gauge_set("PROFILE_THREADS", on_cpu + off_cpu)
        gauge_set("PROFILE_ON_CPU_THREADS", on_cpu)
        gauge_set("PROFILE_OFF_CPU_THREADS", off_cpu)
        with self._lock:
            waits = dict(self._wait_seconds)
        for site, seconds in waits.items():
            gauge_set(f"PROFILE_WAIT_{site.upper()}_SECONDS", seconds)

    # -- output -------------------------------------------------------

    def collapsed(self, limit: int = 0) -> str:
        """Collapsed-stack (``stack count``) lines, ready for any
        flamegraph renderer; heaviest stacks first."""
        with self._lock:
            items = sorted(self._stacks.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        if limit > 0:
            items = items[:limit]
        return "\n".join("%s %d" % (stack, n) for stack, n in items)

    def wait_seconds(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._wait_seconds)

    def report(self, top_stacks: int = 40) -> Dict:
        """JSON-able snapshot: per-thread self-time, wait-site totals,
        and the heaviest collapsed stacks."""
        with self._lock:
            threads = {
                name: {"on_cpu": info["on_cpu"],
                       "off_cpu": info["off_cpu"],
                       "waits": dict(info["waits"])}
                for name, info in self._threads.items()}
            stacks = sorted(self._stacks.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:top_stacks]
            return {"t_ns": time.time_ns(),
                    "hz": self.hz,
                    "samples": self._samples,
                    "started_ns": self._started_ns,
                    "threads": threads,
                    "wait_seconds": dict(self._wait_seconds),
                    "stacks": [[s, n] for s, n in stacks]}

    def render(self) -> str:
        rep = self.report(top_stacks=10)
        lines = ["profile: %d samples @ %.0f Hz"
                 % (rep["samples"], rep["hz"])]
        for name in sorted(rep["threads"]):
            info = rep["threads"][name]
            total = info["on_cpu"] + info["off_cpu"]
            lines.append("  %-24s %7.3fs self  (%.0f%% off-cpu)"
                         % (name, total,
                            100.0 * info["off_cpu"] / total if total else 0))
            for site, sec in sorted(info["waits"].items(),
                                    key=lambda kv: -kv[1]):
                lines.append("    wait %-20s %7.3fs" % (site, sec))
        return "\n".join(lines)


#: Process-wide profiler (the JAX package starts it from ``mv.init`` under
#: ``profile_continuous``; the port starts it only when a caller does).
PROFILER = SamplingProfiler(hz=50.0, max_frames=24)


def capture_for_alert(profiler: Optional[SamplingProfiler] = None) -> Dict:
    """A profile for a flight dump: the running continuous profiler's
    report if there is one, otherwise a short synchronous burst (~50 ms)
    so even a cold process ships *some* attribution with the alert."""
    p = PROFILER if profiler is None else profiler
    if p.running and p.samples > 0:
        return p.report()
    burst = SamplingProfiler(hz=200.0, max_frames=p.max_frames)
    for _ in range(10):
        burst.sample_once()
        time.sleep(0.005)
    return burst.report()
