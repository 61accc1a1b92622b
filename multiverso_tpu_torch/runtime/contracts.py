"""Thread-discipline contracts for the runtime (port of
``multiverso_tpu/runtime/contracts.py``).

The server runtime has exactly one mutating thread per process — the
dispatcher (``Server._main``, thread name ``mv-server``) — and a set of
read-only control RPCs that must stay off the worker-slot/dedup machinery
so they can be served while the dispatcher is wedged.  Those two
invariants were previously enforced only by reviewer memory; this module
turns them into declared contracts:

``@dispatcher_only``
    The decorated function mutates dispatcher-owned state (table applies,
    WAL appends, dedup/lease bookkeeping) and must execute on the
    dispatcher thread — either inside ``Server._main``'s drain loop or
    via ``Server.run_serialized``.  The JAX package's ``tools/mvlint``
    statically walks the call graph from every ``threading.Thread``
    target and flags paths that reach a ``@dispatcher_only`` function
    from any other thread.

``@slot_free``
    The decorated control handler must answer without touching worker
    slots, leases, or the dedup window (so stats/traces/watermark RPCs
    work against a stalled or draining server); the linter flags
    decorated handlers that call into slot/lease/dedup machinery or
    block.

Both decorators are metadata-first: by default they only stamp the
function (``__mv_contract__``) for the linter.  With ``MV_CONTRACT_CHECKS=1``
(or :func:`set_enforce`), ``@dispatcher_only`` additionally asserts at
call time that it is running on a dispatcher thread whenever one exists
in the process — cheap enough for chaos runs, zero risk in production
because the default build never raises.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable[..., Any])

#: Dispatcher threads are named ``mv-server`` (plus suffixes for shard /
#: replica variants).  The runtime names them at spawn; the contract
#: check and the linter both key off this prefix.
DISPATCHER_THREAD_PREFIX = "mv-server"

_enforce = os.environ.get("MV_CONTRACT_CHECKS", "") == "1"


class ContractViolation(AssertionError):
    """A declared thread-discipline contract was broken at runtime."""


def set_enforce(on: bool) -> None:
    """Toggle runtime enforcement (tests; normally via MV_CONTRACT_CHECKS)."""
    global _enforce
    _enforce = bool(on)


def enforcing() -> bool:
    return _enforce


def _on_dispatcher_thread() -> bool:
    return threading.current_thread().name.startswith(
        DISPATCHER_THREAD_PREFIX)


def _dispatcher_alive() -> bool:
    return any(t.name.startswith(DISPATCHER_THREAD_PREFIX)
               for t in threading.enumerate())


def dispatcher_only(fn: F) -> F:
    """Mark ``fn`` as dispatcher-thread-only (see module docstring)."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        # One global-bool read on the hot path; the real check only runs
        # under MV_CONTRACT_CHECKS=1.  A process with no live dispatcher
        # thread (bare-table unit tests, offline WAL tools) is exempt:
        # with no second mutating thread there is nothing to race.
        if _enforce and not _on_dispatcher_thread() and _dispatcher_alive():
            raise ContractViolation(
                "%s is @dispatcher_only but was called from thread %r "
                "while a dispatcher thread is live" %
                (getattr(fn, "__qualname__", fn), threading.current_thread().name))
        return fn(*args, **kwargs)

    wrapper.__mv_contract__ = "dispatcher_only"  # type: ignore[attr-defined]
    return wrapper  # type: ignore[return-value]


def slot_free(fn: F) -> F:
    """Mark ``fn`` as a slot-free control handler (statically checked)."""
    fn.__mv_contract__ = "slot_free"  # type: ignore[attr-defined]
    return fn
