"""The upstream perf harness's cycles on one matrix table (kind ``matrix``).

``workers`` threads in one process, each bound to a worker context of the
port. A cycle is three phases, each closed by a barrier of all workers as
the upstream harness closes them: every worker Gets the whole table; every
worker Adds ``percent`` of the rows; every worker Gets the whole table.
Each waits for its reply, as a PS worker does. A phase's requests all
reach the server between two barriers, so each Get sees exactly the Adds
of the cycles before it (the first Get) or up to its own (the second).
The window closes at the first cycle that would start after its end.

The check after the window: the table read back, and the kept Gets'
replies, against the float64 sum of the Adds before them
(``reference/<config>.py``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch

import counts
import devtrace
import generate
import hostprobe

JOIN_S = 300.0


class Cycles:
    """Drives the workers; keeps what every cycle sent and got back."""

    def __init__(self, table, gen: generate.CycleTraffic, workers: int,
                 bind, ref) -> None:
        self.table, self.gen, self.workers = table, gen, workers
        self.bind = bind  # worker slot -> context manager binding the thread
        self.ref = ref
        self.adds: List = []
        self.gets: List = []
        self.errors: List[BaseException] = []
        self.cycle = 0  # the next cycle's number, over every phase of a run

    def run(self, deadline: Optional[float] = None, cycles: int = 0,
            ranges: bool = False):
        """Cycles until ``deadline`` (host clock), or ``cycles`` cycles.
        Returns (start, end, Adds, Get latencies s, rows moved), the start
        taken when every thread is ready."""
        first = self.cycle
        state = {"stop": False, "cycle": first - 1}
        self.starts: List[float] = []  # each cycle's start, host clock

        def next_cycle() -> None:  # run by one thread at each cycle's barrier
            self.starts.append(time.perf_counter())
            state["cycle"] += 1
            state["stop"] = (time.perf_counter() >= deadline if deadline
                             else state["cycle"] - first >= cycles)

        gate = threading.Barrier(self.workers, action=next_cycle)
        phase = threading.Barrier(self.workers)
        go = threading.Barrier(self.workers + 1)
        per_worker = [([], [], [], [0]) for _ in range(self.workers)]

        def span(name):
            return (torch.profiler.record_function(name) if ranges
                    else contextlib.nullcontext())

        def get(w, c, half, lat, gets, moved):
            keep = self.gen.keep(w)
            t0 = time.perf_counter()
            with span("bench.get"):
                reply = self.table.get()
            lat.append(time.perf_counter() - t0)
            moved[0] += reply.shape[0]
            if keep:
                gets.append(self.ref.Get(w, c, half, reply))

        def loop(w: int) -> None:
            adds, gets, lat, moved = per_worker[w]
            try:
                with self.bind(w):
                    go.wait()
                    while True:
                        gate.wait()
                        if state["stop"]:
                            return
                        c = state["cycle"]
                        n = self.gen.percent(c)
                        get(w, c, 0, lat, gets, moved)
                        phase.wait()
                        ids, delta = self.gen.rows[n], self.gen.deltas[w][n]
                        with span("bench.add"):
                            self.table.add(delta, row_ids=ids)
                        adds.append(self.ref.Add(w, c, n))
                        moved[0] += len(ids)
                        phase.wait()
                        get(w, c, 1, lat, gets, moved)
            except BaseException as exc:  # counted, and fails the run
                self.errors.append(exc)
                gate.abort()
                phase.abort()

        threads = [threading.Thread(target=loop, args=(w,), daemon=True)
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        go.wait()
        start = time.perf_counter()
        stop_by = time.monotonic() + JOIN_S + (deadline - start if deadline else 0)
        for t in threads:
            t.join(timeout=max(0.0, stop_by - time.monotonic()))
        end = time.perf_counter()
        if any(t.is_alive() for t in threads):
            raise TimeoutError("worker threads still running after the window")
        self.cycle = state["cycle"]
        adds = [a for p in per_worker for a in p[0]]
        self.adds += adds
        self.gets += [g for p in per_worker for g in p[1]]
        lat = [x for p in per_worker for x in p[2]]
        moved = sum(p[3][0] for p in per_worker)
        return start, end, adds, lat, moved


def _gaps_ms(starts: List[float]) -> List[float]:
    return [round(1e3 * (b - a), 1) for a, b in zip(starts, starts[1:])]


def run(spec) -> dict:
    cfg, tr, ref = spec.cell.config, spec.cell.traffic, spec.cell.reference
    R, C, W = cfg["num_row"], cfg["num_col"], cfg["workers"]
    dev = torch.device(spec.device)
    gen = generate.CycleTraffic(spec.seed, tr, R, C, W, dev)
    port = spec.system == "port"
    out: dict = {}
    if port:
        import multiverso_tpu_torch as mvt
        from multiverso_tpu_torch.config import FLAGS
        from multiverso_tpu_torch.dashboard import Dashboard
        mvt.init(device=spec.device, local_workers=W,
                 sync=cfg["consistency"] == "bsp")
        table = mvt.create_table("matrix", R, C, np.dtype(cfg["dtype"]),
                                 updater_type=cfg["updater"])
        bind = mvt.worker
    else:  # the control: the plain table in a lower precision
        table = ref.PlainTable(R, C, torch.bfloat16, dev)
        bind = lambda w: contextlib.nullcontext()  # noqa: E731
    try:
        drive = Cycles(table, gen, W, bind, ref)
        # every shape the window uses: one cycle of each percent
        drive.run(cycles=int(tr["warmup_cycles"]))
        warm_starts = drive.starts
        if port:
            Dashboard.reset()
        probe = hostprobe.Probe()
        t0 = time.perf_counter()
        start, end, adds, lat, moved = drive.run(deadline=t0 + spec.seconds)
        out["window_start"] = start
        window = end - start
        row_bytes = C * np.dtype(cfg["dtype"]).itemsize
        out["e2e"] = {"ps_gb_per_s": moved * row_bytes / window / 1e9,
                      "get_all_p50_ms": float(np.median(lat)) * 1e3
                                        if lat else None}
        out["ctx"] = {"window_s": window, "acked_adds": len(adds),
                      "gets": len(lat), "rows_moved": moved,
                      "cycles": len(adds) // W}
        out["diag"] = {"host": probe.stop(),
                       "get_ms_quartiles": [float(q) * 1e3 for q in
                                            np.percentile(lat, [25, 50, 75])]
                                           if lat else None,
                       "warmup_cycle_ms": _gaps_ms(warm_starts),
                       "cycle_ms": _gaps_ms(drive.starts)}
        if port:
            out["ctx"]["dashboard"] = {
                name: (Dashboard.get(name).count, Dashboard.get(name).elapse_ms)
                for name in ("WORKER_TABLE_SYNC_ADD", "WORKER_TABLE_SYNC_GET",
                             "SERVER_PROCESS_ADD_MSG", "SERVER_PROCESS_GET_MSG")}
        out["attempted"] = len(lat) + len(adds) + len(drive.errors)
        if spec.trace:
            sub = []
            out["trace"] = devtrace.profiled(lambda: sub.append(drive.run(
                deadline=time.perf_counter() + float(tr["trace_seconds"]),
                ranges=True)))
            _, _, sub_adds, sub_lat, _ = sub[0]
            out["ctx"]["trace"] = dict(out["trace"], work_bytes=sum(
                counts.add_bytes(gen.rows[a.percent], C) for a in sub_adds)
                + len(sub_lat) * counts.whole_get_bytes(R, C))
        final = table.get()
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
        out["failed"] = len(drive.errors)
    finally:
        if port:
            mvt.shutdown()
            FLAGS.reset()
    del table
    if out["failed"]:
        out["numbers"] = {}
        out["error"] = repr(drive.errors[0])
        return out
    out["numbers"] = ref.check(drive.adds, drive.gets, final, gen, dev)
    return out
