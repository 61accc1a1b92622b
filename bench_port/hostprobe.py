"""What the host did over a window, to tell a slow run's cause: the
process's CPU seconds against the wall clock, the machine's steal time
(CPU taken by other guests of its host), and the seconds the garbage
collector ran. Printed on standard error beside the result; no metric
reads them. A reading the machine does not offer is None.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, Optional


def _steal_s() -> Optional[float]:
    """All CPUs' steal time so far, seconds (``/proc/stat``)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return float(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Probe:
    """Readings from construction to :meth:`stop`."""

    def __init__(self) -> None:
        self._gc_s = 0.0
        self._gc_n = 0
        self._gc_t0 = 0.0
        gc.callbacks.append(self._on_gc)
        self._wall = time.perf_counter()
        self._cpu = time.process_time()
        self._steal = _steal_s()

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self._gc_s += time.perf_counter() - self._gc_t0
            self._gc_n += 1

    def stop(self) -> Dict[str, Optional[float]]:
        wall = time.perf_counter() - self._wall
        gc.callbacks.remove(self._on_gc)
        steal = _steal_s()
        return {
            "wall_s": wall,
            "cpu_s": time.process_time() - self._cpu,
            "steal_s": (steal - self._steal
                        if steal is not None and self._steal is not None
                        else None),
            "gc_s": self._gc_s, "gc_runs": self._gc_n,
        }
