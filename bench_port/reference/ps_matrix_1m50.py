"""Plain reference for ``ps_matrix_1m50``: a matrix table with the default
(linear) updater under the async server is the sum of every acknowledged
Add, and a Get's reply is that sum over the Adds that reached the server
before it. Written in plain PyTorch, float64, from the benchmark's own
record of what it sent; it imports nothing of the program.

What a Get saw: the cycles' barriers order the phases, so the first Get of
cycle ``c`` sees every Add of the cycles before ``c``, and the second Get
sees those of cycle ``c`` too.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch


class Add(NamedTuple):
    worker: int
    cycle: int
    percent: int  # the rows and the worker's delta block of that percent


class Get(NamedTuple):
    worker: int
    cycle: int
    half: int  # 0: before the cycle's Adds, 1: after them
    reply: np.ndarray


class PlainTable:
    """The table written plainly on the device, in ``dtype``: the control,
    put in the program's place with a lower precision than the
    configuration's. One lock orders requests as the dispatcher does."""

    def __init__(self, num_row: int, num_col: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        self.data = torch.zeros((num_row, num_col), dtype=dtype, device=device)
        self._lock = threading.Lock()

    def add(self, values: np.ndarray, row_ids: np.ndarray) -> None:
        ids = torch.from_numpy(np.asarray(row_ids, np.int64)).to(self.data.device)
        vals = torch.from_numpy(values).to(self.data.device, self.data.dtype)
        with self._lock:
            self.data.index_add_(0, ids, vals)
            if self.data.is_cuda:
                torch.cuda.synchronize()

    def get(self, row_ids: np.ndarray = None) -> np.ndarray:
        with self._lock:
            rows = self.data if row_ids is None else self.data[
                torch.from_numpy(np.asarray(row_ids, np.int64)).to(self.data.device)]
            return rows.to(torch.float32).cpu().numpy()


def check(adds: Sequence[Add], gets: Sequence[Get], table: np.ndarray,
          traffic, device) -> Dict[str, float]:
    """``table_gap``: the widest gap between the table read after the window
    and the float64 sum of the acknowledged Adds; ``get_gap``: the widest
    gap of a kept Get's reply from the sum of the Adds before it. Both in
    units of sqrt(1 + the delta rows added to the row): float32 sums of n
    standard-normal rows round by about that much more than one row.
    ``traffic`` holds the rows and deltas of each percent
    (``generate.CycleTraffic``)."""
    dev = torch.device(device)
    f64 = torch.float64
    ids = {n: torch.from_numpy(r.astype(np.int64)).to(dev)
           for n, r in traffic.rows.items()}
    mirror = torch.zeros(table.shape, dtype=f64, device=dev)
    added = torch.zeros(table.shape[0], dtype=f64, device=dev)
    by_cycle: Dict[int, list] = {}
    for a in adds:
        by_cycle.setdefault(a.cycle, []).append(a)
    kept: Dict[tuple, list] = {}
    for g in gets:
        kept.setdefault((g.cycle, g.half), []).append(g)
    last = max([a.cycle for a in adds] + [g.cycle for g in gets] + [-1])
    get_gap = 0.0

    def judge(key) -> float:
        gap = 0.0
        scale = torch.sqrt(added + 1.0)[:, None]
        for g in kept.get(key, []):
            reply = torch.from_numpy(g.reply).to(dev, f64)
            gap = max(gap, float(((reply - mirror).abs() / scale).max()))
        return gap

    for c in range(last + 1):
        get_gap = max(get_gap, judge((c, 0)))
        for a in sorted(by_cycle.get(c, []), key=lambda a: a.worker):
            delta = torch.from_numpy(traffic.deltas[a.worker][a.percent])
            mirror.index_add_(0, ids[a.percent], delta.to(dev, f64))
            added[ids[a.percent]] += 1.0
        get_gap = max(get_gap, judge((c, 1)))
    got = torch.from_numpy(table).to(dev, f64)
    table_gap = float(((got - mirror).abs()
                       / torch.sqrt(added + 1.0)[:, None]).max())
    return {"table_gap": table_gap, "get_gap": get_gap}
