"""Periodic JSONL metrics snapshots — the bench/offline-analysis feed
(port of ``multiverso_tpu/obs/logger.py``).

A :class:`MetricsLogger` thread appends one JSON object per interval to
the ``metrics_path`` file: wall-clock timestamp plus the full dashboard
snapshot (monitors, counters, gauges, histograms as bucket arrays). The
format is what ``bench.py``'s :func:`load_metrics` ingests and what
``make metrics-smoke`` asserts over; ``mvt.init`` starts the thread
when the ``metrics_path`` flag is set and ``mvt.shutdown`` writes a
final snapshot and stops it. The files are the JAX package's, line for
line.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import Dashboard


class MetricsLogger:
    """Append ``{"t": epoch_seconds, ...Dashboard.snapshot()}`` JSONL
    lines every ``interval`` seconds. ``close()`` flushes one final
    snapshot so short-lived sessions still leave a record."""

    def __init__(self, path: str, interval: float = 10.0) -> None:
        self.path = path
        self.interval = max(0.05, float(interval))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mv-metrics-logger")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._write()

    def _write(self) -> None:
        try:
            line = json.dumps({"t": time.time(), **Dashboard.snapshot()})
            with self._lock:
                with open(self.path, "a", encoding="utf-8") as fp:
                    fp.write(line + "\n")
        except Exception as exc:  # noqa: BLE001 — telemetry never kills
            log.error("metrics logger: snapshot to %s failed: %r",
                      self.path, exc)

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._write()  # final snapshot: short sessions still leave data


def load_metrics(path: str) -> List[Dict[str, Any]]:
    """Parse a metrics JSONL file back into snapshot dicts (blank lines
    skipped) — the ingestion half of the format contract."""
    snapshots = []
    with open(path, encoding="utf-8") as fp:
        for line in fp:
            line = line.strip()
            if line:
                snapshots.append(json.loads(line))
    return snapshots
