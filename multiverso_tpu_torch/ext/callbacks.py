"""Training-loop sync callback (port of ``multiverso_tpu/ext/callbacks.py``).

Parity with ``binding/python/multiverso/keras_ext/callbacks.py:20-40``
(``MVCallback(model, freq)``: sync params every ``freq`` batches, barrier at
epoch end), made framework-agnostic: it drives any
:class:`~multiverso_tpu_torch.ext.param_manager.ParamManager`.
"""

from __future__ import annotations

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.ext.param_manager import ParamManager


class MVCallback:
    def __init__(self, manager: ParamManager, freq: int = 1) -> None:
        mvt.log.check(freq >= 1, "sync freq must be >= 1")
        self.manager = manager
        self.freq = int(freq)
        self._batch = 0

    def on_batch_end(self, batch: int = None, logs: dict = None) -> None:
        b = self._batch if batch is None else batch
        self._batch = b + 1
        if b % self.freq == 0:
            self.manager.sync_all_param()

    def on_epoch_end(self, epoch: int = None, logs: dict = None) -> None:
        self.manager.sync_all_param()
        mvt.barrier()
