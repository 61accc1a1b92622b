"""ASGD through one ArrayTable: worker threads that train replicas and sync
them through the table, whatever the model.

The reference benchmark's topology (``binding/lua/docs/BENCHMARK.md:39``:
N processes, a sync every batch) with threads in place of MPI ranks. Each
worker runs its own step function on its own batches; its parameters
(``state["params"]``, a tree of tensors) are a device view of the table's
value (``PytreeParamManager.worker_view(device=True)``), and every
``sync_freq`` steps it pushes its delta since the last sync and trains on
from the merged value. Only the parameters cross the table: the rest of a
worker's state (an optimizer's moments, running statistics) stays local,
as the reference's per-process optimizers did.

``models/resnet.py`` and ``models/deepseek_v2.py`` train through it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import count, monitor
from multiverso_tpu_torch.obs.devtime import DeviceTime

#: ``step(state, batch) -> (state, loss)``; it may have a ``flush()``,
#: called once after the worker's last step.
Step = Callable[[dict, Any], tuple]


def _device_timer(device: Any) -> Optional[DeviceTime]:
    """A worker's ``ASGD_SYNC_DEVICE`` timer on a card, None elsewhere."""
    if torch.device(device).type != "cuda":
        return None
    return DeviceTime("ASGD_SYNC_DEVICE")


class ASGDTrainer:
    """``workers`` threads syncing through ONE table, built from ``params``
    (a tree of tensors: the initial value). ``pipeline=True`` makes the
    per-batch syncs the one-round-stale ``sync_pipelined``: the sync
    overlaps the next batch. ``sync_seconds`` holds the worker-side
    seconds of every sync of the last :meth:`run`, all workers together.

    Each sync is the ``ASGD_SYNC`` section on its worker (the host wall of
    the push and the merged value's return) and adds the bytes it moves,
    the pushed value and the returned one, to ``ASGD_SYNC_BYTES``. On a
    card it is also ``ASGD_SYNC_DEVICE``: CUDA events on the worker's
    stream, which the dispatcher shares, around the sync, so the pair
    spans its device work (the snapshot, the delta, the update, the merged
    value and the baseline), harvested without waiting. A pipelined sync's
    pair ends when it returns, before the work it left in flight."""

    def __init__(self, params: Any, workers: int = 1, sync_freq: int = 1,
                 pipeline: bool = False) -> None:
        from multiverso_tpu_torch.ext import PytreeParamManager
        self.workers = workers
        self.sync_freq = sync_freq
        self.pipeline = bool(pipeline)
        self.sync_seconds: list = []
        # ONE manager (one table) for the trainer's lifetime, created here
        # so CheckpointDriver([trainer.manager.table], ...) can be set up
        # before training runs
        self.manager = PytreeParamManager(params)
        self._sync_bytes = 2 * 4 * sum(self.manager._sizes)

    def run(self, make_step: Callable[[int], Step],
            batches: Callable[[int], Iterable],
            local_state: Optional[Callable[[int], dict]] = None,
            timeout: Optional[float] = None) -> Dict[int, dict]:
        """Train every worker to the end of its batches and return each
        slot's final state, its ``params`` synced once more after its last
        step. ``make_step(slot)`` builds the worker's step function on its
        thread, ``batches(slot)`` its batches (iterated on its thread),
        ``local_state(slot)`` its state apart from ``params``. ``timeout``:
        seconds to wait for the workers; one still running then is fatal
        (a wedged round fails instead of hanging)."""
        import multiverso_tpu_torch as mvt
        from multiverso_tpu_torch.runtime.zoo import Zoo

        manager = self.manager
        results: Dict[int, dict] = {}
        errors: Dict[int, BaseException] = {}
        self.sync_seconds = []

        def sync(view, timer, params):
            t0 = time.perf_counter()
            with monitor("ASGD_SYNC"):
                start = timer.begin() if timer is not None else None
                params = (view.sync_pipelined(params) if self.pipeline
                          else view.sync(params))
                if start is not None:
                    timer.end(start)
            self.sync_seconds.append(time.perf_counter() - t0)
            count("ASGD_SYNC_BYTES", self._sync_bytes)
            return params

        def work(slot: int) -> None:
            with mvt.worker(slot):
                view = manager.worker_view(device=True)
                timer = _device_timer(Zoo.instance().device)
                step = make_step(slot)
                state = local_state(slot) if local_state is not None else {}
                state["params"] = view.params   # current global value
                n_batches = 0
                for batch in batches(slot):
                    state, _ = step(state, batch)
                    n_batches += 1
                    if n_batches % self.sync_freq == 0:
                        state["params"] = sync(view, timer, state["params"])
                flush = getattr(step, "flush", None)
                if flush is not None:
                    flush()
                if timer is not None:
                    timer.flush()
                state["params"] = view.sync(state["params"])
                results[slot] = state

        def guarded(slot: int) -> None:
            try:
                work(slot)
            except BaseException as exc:  # reported by run()
                errors[slot] = exc

        threads = [threading.Thread(target=guarded, args=(s,), daemon=True)
                   for s in range(self.workers)]
        for t in threads:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            log.fatal("ASGD workers still running after %s s", timeout)
        for slot in range(self.workers):
            if slot not in results:
                log.fatal("ASGD worker %d died before finishing: %r", slot,
                          errors.get(slot))
        return results

    def global_params(self) -> Any:
        """The table's settled value, as a fresh tree on its device."""
        return self.manager.worker_view(device=True).params
