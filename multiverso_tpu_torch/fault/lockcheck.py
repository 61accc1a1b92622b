"""Runtime lock-order sanitizer (port of
``multiverso_tpu/fault/lockcheck.py``).

:func:`enable` replaces the ``threading.Lock`` / ``threading.RLock`` /
``threading.Condition`` factories with checked wrappers that maintain,
per thread, the stack of currently-held locks and, globally, a directed
acquisition graph over lock *instances*: acquiring ``B`` while holding
``A`` inserts the edge ``A -> B``.  A cycle in that graph is a lock-order
inversion — the classic precondition for deadlock — and is reported even
when the interleaving that would actually deadlock never happens on this
run.  The sanitizer additionally flags lock-hold-time outliers (a lock
held longer than ``MV_LOCKCHECK_HOLD_SECONDS``, default 10s), which in
this codebase almost always means blocking I/O crept under a registry
lock.

Findings are recorded (see :func:`take_findings`) and dumped through the
flight recorder (``lock_order_cycle`` / ``lock_hold_outlier`` events)
with the acquisition stacks of both ends of the offending edge, so a CI
failure ships the evidence; each also counts ``LOCK_ORDER_CYCLES`` or
``LOCK_HOLD_OUTLIERS``.

Differences from the JAX package's module: the native factories come
from ``_thread`` (and the native ``Condition`` class), never from
whatever ``threading.Lock`` is at import time, so another sanitizer that
patched the factories first (the JAX package's, under ``MV_LOCKCHECK=1``)
is never wrapped twice; :func:`disable` puts back exactly the factories
:func:`enable` found, not the native ones; and a checked lock has
``_at_fork_reinit``, which ``concurrent.futures`` calls on a lock it
creates at import.

Design notes / limitations:

- Wrapping happens at the factory, so only locks created *after*
  :func:`enable` are checked.  Module-level locks created at import time
  stay native; the runtime creates its interesting locks per
  server/client instance, which is the bug class this targets.
- Nodes are lock instances (labelled with their creation site), never
  call sites, so two unrelated locks born on the same line cannot alias
  into a false cycle.  Instance ids are monotonic serials, immune to
  ``id()`` reuse after GC.
- The inner primitive is acquired *before* any bookkeeping and released
  *after*, and the graph's own mutex is a native lock, so the sanitizer
  cannot introduce an ordering of its own.
- ``Condition.wait`` releases the underlying (wrapped) mutex through the
  normal ``release``/``acquire`` protocol, so waits neither leak held
  state nor count toward hold time.
"""

from __future__ import annotations

import _thread
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

from multiverso_tpu_torch.obs.profiler import clear_wait, mark_wait



def _native_condition() -> Any:
    """The native ``Condition`` class, even when the factory is patched: a
    patched factory still builds native conditions (``Event`` holds one)."""
    if isinstance(threading.Condition, type):
        return threading.Condition
    return type(threading.Event()._cond)


_REAL = {
    "Lock": _thread.allocate_lock,
    "RLock": threading._CRLock or threading._PyRLock,
    "Condition": _native_condition(),
}

_STACK_DEPTH = 12      # frames kept per acquisition stack
_MAX_EDGES = 100_000   # graph bound; beyond this, new edges are dropped+counted

_enabled = False
_replaced: Optional[Tuple[Any, Any, Any]] = None  # what enable() patched over


def _hold_threshold() -> float:
    try:
        return float(os.environ.get("MV_LOCKCHECK_HOLD_SECONDS", "10.0"))
    except ValueError:
        return 10.0


class _Graph:
    """Global acquisition graph + findings store.  All state is guarded
    by a *native* lock so instrumentation never recurses into itself."""

    def __init__(self) -> None:
        self.mutex = _REAL["Lock"]()
        self.serial = 0
        self.labels: Dict[int, str] = {}            # lock serial -> site
        self.edges: Dict[int, Set[int]] = {}        # a -> {b, ...}
        self.edge_stacks: Dict[Tuple[int, int], Tuple[str, str]] = {}
        self.edge_count = 0
        self.dropped_edges = 0
        self.cycles: List[Dict[str, Any]] = []
        self.outliers: List[Dict[str, Any]] = []
        self.seen_cycles: Set[Tuple[int, ...]] = set()
        self.tls = threading.local()

    def next_serial(self) -> int:
        with self.mutex:
            self.serial += 1
            return self.serial

    def held(self) -> List[Tuple[int, str, float]]:
        """This thread's held-lock stack: (serial, stack_text, t_acquire)."""
        stack = getattr(self.tls, "held", None)
        if stack is None:
            stack = self.tls.held = []
        return stack

    def _path(self, src: int, dst: int) -> Optional[List[int]]:
        """DFS: a path src -> ... -> dst along recorded edges, or None."""
        seen = {src}
        trail = [(src, iter(self.edges.get(src, ())))]
        parents = {src: -1}
        while trail:
            node, it = trail[-1]
            nxt = next(it, None)
            if nxt is None:
                trail.pop()
                continue
            if nxt in seen:
                continue
            parents[nxt] = node
            if nxt == dst:
                path = [dst]
                while path[-1] != src:
                    path.append(parents[path[-1]])
                path.reverse()
                return path
            seen.add(nxt)
            trail.append((nxt, iter(self.edges.get(nxt, ()))))
        return None


_G = _Graph()


def _site() -> str:
    """file:line of the frame that created the lock (best effort)."""
    for entry in reversed(traceback.extract_stack(limit=8)):
        if "lockcheck" not in (entry.filename or ""):
            return "%s:%d" % (entry.filename, entry.lineno or 0)
    return "<unknown>"


def _stack_text() -> str:
    return "".join(traceback.format_stack(limit=_STACK_DEPTH)[:-2])


def _record_edges(serial: int) -> List[Dict[str, Any]]:
    """Insert held->serial edges; return any *new* cycle reports (the
    flight-recorder dump happens outside the graph mutex)."""
    held = _G.held()
    if not held:
        return []
    acq_stack = _stack_text()
    reports: List[Dict[str, Any]] = []
    with _G.mutex:
        for h_serial, h_stack, _t in held:
            if h_serial == serial:
                continue
            dests = _G.edges.setdefault(h_serial, set())
            if serial in dests:
                continue
            if _G.edge_count >= _MAX_EDGES:
                _G.dropped_edges += 1
                continue
            # Does serial already reach h_serial?  Then closing the edge
            # h_serial -> serial completes a cycle.
            path = _G._path(serial, h_serial)
            dests.add(serial)
            _G.edge_count += 1
            _G.edge_stacks[(h_serial, serial)] = (h_stack, acq_stack)
            if path is not None:
                cyc = tuple(sorted(path + [serial]))
                if cyc in _G.seen_cycles:
                    continue
                _G.seen_cycles.add(cyc)
                nodes = path + [serial]
                report = {
                    "kind": "lock_order_cycle",
                    "thread": threading.current_thread().name,
                    "locks": [_G.labels.get(n, "?") for n in nodes],
                    "closing_edge": [_G.labels.get(h_serial, "?"),
                                     _G.labels.get(serial, "?")],
                    "held_stack": h_stack,
                    "acquire_stack": acq_stack,
                }
                _G.cycles.append(report)
                reports.append(report)
    return reports


def _dump(reports: List[Dict[str, Any]]) -> None:
    for report in reports:
        try:
            from multiverso_tpu_torch.obs.trace import flight_dump
            from multiverso_tpu_torch.dashboard import count
            if report["kind"] == "lock_order_cycle":
                count("LOCK_ORDER_CYCLES")
            else:
                count("LOCK_HOLD_OUTLIERS")
            flight_dump(report["kind"], **{
                k: v for k, v in report.items() if k != "kind"})
        except Exception:  # noqa: BLE001 — telemetry must never throw here
            pass


class _CheckedLock:
    """Wrapper over a native Lock/RLock with acquisition-graph hooks."""

    _reentrant = False

    def __init__(self) -> None:
        self._inner = (_REAL["RLock"] if self._reentrant
                       else _REAL["Lock"])()
        self._serial = _G.next_serial()
        self._depth = 0  # owning-thread reentrancy depth (RLock only)
        with _G.mutex:
            _G.labels[self._serial] = _site()

    # -- threading.Lock protocol -------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            # profiler wait site: a sampled thread parked here is
            # off-CPU in lock contention, not burning cycles
            prev = mark_wait("lock_acquire")
            try:
                got = self._inner.acquire(blocking, timeout)
            finally:
                clear_wait(prev)
        else:
            got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        if self._reentrant:
            self._depth += 1
            if self._depth > 1:      # reentrant re-acquire: no new edge
                return True
        reports = _record_edges(self._serial)
        _G.held().append((self._serial, _stack_text(), time.monotonic()))
        if reports:
            _dump(reports)
        return True

    def release(self) -> None:
        if self._reentrant and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        if self._reentrant:
            self._depth = 0
        self._pop_held()
        self._inner.release()

    def _pop_held(self) -> None:
        held = _G.held()
        now = time.monotonic()
        outlier = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self._serial:
                _serial, stack, t0 = held.pop(i)
                dt = now - t0
                if dt > _hold_threshold():
                    outlier = {
                        "kind": "lock_hold_outlier",
                        "thread": threading.current_thread().name,
                        "lock": _G.labels.get(self._serial, "?"),
                        "held_seconds": round(dt, 3),
                        "threshold": _hold_threshold(),
                        "acquire_stack": stack,
                    }
                break
        if outlier is not None:
            with _G.mutex:
                _G.outliers.append(outlier)
            _dump([outlier])

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # a forked child's copy is free again; concurrent.futures registers
        # this for a lock it creates at import (the JAX package's wrapper
        # lacks it, so importing concurrent.futures.thread fails there)
        self._inner._at_fork_reinit()  # type: ignore[attr-defined]
        self._depth = 0

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return "<mv-checked %s #%d (%s)>" % (
            "RLock" if self._reentrant else "Lock",
            self._serial, _G.labels.get(self._serial, "?"))


class _CheckedRLock(_CheckedLock):
    _reentrant = True

    # threading.Condition's full protocol.  Without these it falls back
    # to an acquire(0) ownership probe, which is wrong for reentrant
    # locks (the probe succeeds for the owner), so they must exist on
    # any RLock handed to a Condition.
    def _is_owned(self) -> bool:
        return self._inner._is_owned()  # type: ignore[attr-defined]

    def _release_save(self) -> Any:
        # Condition.wait fully releases regardless of reentrancy depth.
        depth = self._depth
        self._depth = 0
        self._pop_held()
        return (depth, self._inner._release_save())  # type: ignore[attr-defined]

    def _acquire_restore(self, saved: Any) -> None:
        depth, inner_state = saved
        self._inner._acquire_restore(inner_state)  # type: ignore[attr-defined]
        self._depth = depth
        reports = _record_edges(self._serial)
        _G.held().append((self._serial, _stack_text(), time.monotonic()))
        if reports:
            _dump(reports)


def _make_lock() -> _CheckedLock:
    return _CheckedLock()


def _make_rlock() -> _CheckedRLock:
    return _CheckedRLock()


def _make_condition(lock: Any = None) -> Any:
    return _REAL["Condition"](lock if lock is not None else _make_rlock())


def enable() -> None:
    """Patch the threading lock factories.  Idempotent."""
    global _enabled, _replaced
    if _enabled:
        return
    _enabled = True
    _replaced = (threading.Lock, threading.RLock, threading.Condition)
    threading.Lock = _make_lock            # type: ignore[misc]
    threading.RLock = _make_rlock          # type: ignore[misc]
    threading.Condition = _make_condition  # type: ignore[misc,assignment]


def disable() -> None:
    """Restore the factories :func:`enable` replaced (existing wrapped
    locks keep working)."""
    global _enabled, _replaced
    if not _enabled:
        return
    _enabled = False
    (threading.Lock, threading.RLock,            # type: ignore[misc]
     threading.Condition) = _replaced            # type: ignore[misc]
    _replaced = None


def enabled() -> bool:
    return _enabled


def findings() -> List[Dict[str, Any]]:
    """All recorded cycle + hold-time reports (does not clear)."""
    with _G.mutex:
        return list(_G.cycles) + list(_G.outliers)


def take_findings() -> List[Dict[str, Any]]:
    """Pop and return all recorded reports (per-test consumption)."""
    with _G.mutex:
        out = list(_G.cycles) + list(_G.outliers)
        _G.cycles.clear()
        _G.outliers.clear()
        return out


def reset() -> None:
    """Drop the whole graph and all findings (unit-test isolation)."""
    with _G.mutex:
        _G.edges.clear()
        _G.edge_stacks.clear()
        _G.edge_count = 0
        _G.dropped_edges = 0
        _G.cycles.clear()
        _G.outliers.clear()
        _G.seen_cycles.clear()


def report_text() -> str:
    """Human-readable summary of all current findings."""
    out: List[str] = []
    for f in findings():
        if f["kind"] == "lock_order_cycle":
            out.append("LOCK-ORDER CYCLE (thread %s):\n  locks: %s\n"
                       "  closing edge: %s -> %s\n"
                       "--- stack holding first lock ---\n%s"
                       "--- stack acquiring second lock ---\n%s" %
                       (f["thread"], " -> ".join(f["locks"]),
                        f["closing_edge"][0], f["closing_edge"][1],
                        f["held_stack"], f["acquire_stack"]))
        else:
            out.append("LOCK HOLD OUTLIER (thread %s): %s held %.3fs "
                       "(threshold %.3fs)\n--- acquire stack ---\n%s" %
                       (f["thread"], f["lock"], f["held_seconds"],
                        f["threshold"], f["acquire_stack"]))
    return "\n\n".join(out)
