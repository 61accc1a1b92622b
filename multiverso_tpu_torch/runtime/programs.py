"""Named device-program registry (port of ``multiverso_tpu/runtime/programs.py``).

Reference capability (not copied): the reference's multi-table block
protocols shipped closures implicitly — every rank ran the same binary,
so "which code applies this block" never crossed the wire
(``src/communicator.cpp`` RequestParameter/AddDeltaParameter pairs).

A transaction descriptor that must be host-serializable cannot carry a
Python closure. Programs are therefore registered BY NAME, on every
process, before any transaction references them; a descriptor carries the
name plus host arguments, and each process resolves the name to its own
locally-built function. In a multi-process lockstep world
(``runtime/multihost.py``) a named transaction is the one device
transaction that crosses ranks (the leader refuses a closure): every rank
runs it on its own row shards, with host arguments, and the origin's own
run gives the reply. ``mvt.shutdown`` clears the registry, so no
program keeps the tables of a stopped runtime alive. See
:meth:`multiverso_tpu_torch.tables.matrix_table.MatrixWorker.transact_device_async`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from multiverso_tpu_torch import log

_registry: Dict[str, Callable] = {}
_lock = threading.Lock()


def register_program(name: str, fn: Callable, overwrite: bool = True) -> str:
    """Register a device program under ``name``. Registration is
    process-local. Returns the name for chaining."""
    if not isinstance(name, str) or not name:
        log.fatal("register_program: name must be a non-empty string")
    with _lock:
        if name in _registry and not overwrite:
            log.fatal("register_program: %r already registered", name)
        _registry[name] = fn
    return name


def resolve_program(name: str) -> Callable:
    with _lock:
        fn = _registry.get(name)
    if fn is None:
        log.fatal("unknown device program %r — register_program(name, fn) "
                  "must run before a transaction names it; registered: %s",
                  name, sorted(_registry))
    return fn


def registered_programs() -> list:
    with _lock:
        return sorted(_registry)


def clear_programs() -> None:
    """Forget every registered program (``mvt.shutdown`` calls this)."""
    with _lock:
        _registry.clear()
