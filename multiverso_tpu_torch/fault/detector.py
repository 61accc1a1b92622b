"""Liveness: heartbeat/lease tracking for remote workers.

The SSP gate of Ho et al. (NIPS'13) — and BSP before it — is only safe in
production if a dead worker can be evicted from its clock: a crashed peer
otherwise holds every round gate forever. This module is the bookkeeping
half: the RemoteServer registers each remote worker here and renews its
lease on every heartbeat (``Control_Heartbeat``) *and* on every request
frame, so heartbeats only matter while a client idles or blocks. The
recovery half lives in :class:`~multiverso_tpu_torch.runtime.server.SyncServer`:
its stall watchdog calls :meth:`LivenessDetector.reap` each tick and
evicts expired workers from the clock gates on the dispatcher thread.

Local (in-process) workers are never tracked — a thread in this process
cannot silently vanish without taking the server with it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Set


class LivenessDetector:
    """Lease table: worker_id -> last sign of life. ``lease_seconds <= 0``
    disables expiry entirely (registered workers are immortal)."""

    def __init__(self, lease_seconds: float) -> None:
        self.lease_seconds = float(lease_seconds)
        self._last_seen: Dict[int, float] = {}
        self._evicted: Set[int] = set()
        self._lock = threading.Lock()

    # -- lease bookkeeping ---------------------------------------------------
    def register(self, worker_id: int) -> None:
        with self._lock:
            self._last_seen[worker_id] = time.monotonic()

    def beat(self, worker_id: int) -> None:
        """Renew a lease; unknown ids are ignored (a stale frame from a
        deregistered or evicted worker must not resurrect its lease)."""
        with self._lock:
            if worker_id in self._last_seen:
                self._last_seen[worker_id] = time.monotonic()

    def forget(self, worker_id: int) -> None:
        """Graceful deregistration: stop tracking without marking evicted."""
        with self._lock:
            self._last_seen.pop(worker_id, None)

    # -- expiry --------------------------------------------------------------
    def reap(self) -> List[int]:
        """Workers whose lease just expired, each reported exactly once
        (moved to the evicted set); the caller performs the actual clock
        eviction. Empty when leases are disabled."""
        if self.lease_seconds <= 0:
            return []
        now = time.monotonic()
        expired: List[int] = []
        with self._lock:
            for wid, last in list(self._last_seen.items()):
                if now - last > self.lease_seconds:
                    del self._last_seen[wid]
                    self._evicted.add(wid)
                    expired.append(wid)
        return expired

    def is_evicted(self, worker_id: int) -> bool:
        with self._lock:
            return worker_id in self._evicted

    def tracked(self) -> List[int]:
        with self._lock:
            return sorted(self._last_seen)
