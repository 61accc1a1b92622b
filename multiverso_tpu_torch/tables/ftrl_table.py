"""FTRL table (port of ``multiverso_tpu/tables/ftrl_table.py``).

The reference's LogisticRegression app defines struct-valued user tables
whose server runs the FTRL-proximal update and whose Get materializes
weights from the per-coordinate accumulators ``(z, n)``
(``Applications/LogisticRegression/src/util/ftrl_sparse_table.h:12-90``).
Here ``z`` and ``n`` are two float32 tensors on the runtime's device and no
weight tensor exists: weights are derived on the device at Get time (the
FTRL closed form). Add ships raw gradients and updates ``z`` and ``n`` in
place with torch ops (the JAX package ran a jitted update on donated
buffers).

Checkpoints store ``z`` and then ``n`` at the logical size, as the JAX
package does; ``load`` writes into the existing tensors.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.tables.base import ServerTable, WorkerTable
from multiverso_tpu_torch.utils import async_upload


def ftrl_weights(z: torch.Tensor, n: torch.Tensor, alpha: float, beta: float,
                 lambda1: float, lambda2: float) -> torch.Tensor:
    """Closed-form FTRL-proximal weights from accumulator state."""
    shrunk = torch.sign(z) * torch.clamp(torch.abs(z) - lambda1, min=0.0)
    denom = (beta + torch.sqrt(n)) / alpha + lambda2
    return -shrunk / denom


class FTRLServer(ServerTable):
    def __init__(self, size: int, alpha: float = 0.1, beta: float = 1.0,
                 lambda1: float = 1.0, lambda2: float = 1.0) -> None:
        super().__init__()
        self.size = int(size)
        self.alpha, self.beta = float(alpha), float(beta)
        self.lambda1, self.lambda2 = float(lambda1), float(lambda2)
        self.padded = mesh_lib.pad_to_multiple(self.size,
                                               Zoo.instance().num_servers)
        self.z = torch.zeros(self.padded, dtype=torch.float32,
                             device=self.device)
        self.n = torch.zeros(self.padded, dtype=torch.float32,
                             device=self.device)

    def _weights(self) -> torch.Tensor:
        return ftrl_weights(self.z, self.n, self.alpha, self.beta,
                            self.lambda1, self.lambda2)

    def process_add(self, request: Tuple[np.ndarray, Any]) -> None:
        grad, _option = request
        grad = np.asarray(grad, np.float32).reshape(-1)
        if grad.size != self.size:
            log.fatal("FTRLTable.add: grad size %d != %d", grad.size, self.size)
        if self.padded != self.size:
            grad = np.pad(grad, (0, self.padded - self.size))
        g = async_upload(grad, self.device)
        w = self._weights()
        g2 = g * g
        sigma = (torch.sqrt(self.n + g2) - torch.sqrt(self.n)) / self.alpha
        # z + g - sigma*w, n + g*g: the JAX update's order of operations
        self.z.add_(g).sub_(sigma * w)
        self.n.add_(g2)

    def process_get(self, request: Any) -> np.ndarray:
        return self._host_read(self._weights()[: self.size])

    def store(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import write_array
        write_array(stream, self._host_read(self.z[: self.size]))
        write_array(stream, self._host_read(self.n[: self.size]))

    def load(self, stream) -> None:
        from multiverso_tpu_torch.checkpoint import read_array
        z = read_array(stream)
        n = read_array(stream)
        if z.size != self.size or n.size != self.size:
            log.fatal("FTRLTable.load: z/n sizes %d/%d != %d", z.size,
                      n.size, self.size)
        for dst, src in ((self.z, z), (self.n, n)):
            dst.zero_()
            dst[: self.size].copy_(torch.from_numpy(
                src.reshape(-1).astype(np.float32)))


class FTRLWorker(WorkerTable):
    """Client proxy: ``add`` ships raw gradients, ``get`` returns the derived
    FTRL weights."""

    def __init__(self, size: int, alpha: float = 0.1, beta: float = 1.0,
                 lambda1: float = 1.0, lambda2: float = 1.0,
                 server: Optional[FTRLServer] = None) -> None:
        super().__init__()
        self.size = int(size)
        self._server_table = server or FTRLServer(size, alpha, beta,
                                                  lambda1, lambda2)
        self._register(self._server_table)

    def get(self) -> np.ndarray:
        return super().get(None)

    def get_async(self) -> int:
        """The pipelined pull of ``PSLogReg`` (the JAX package's proxy has
        no argument-free form, so its dense FTRL model cannot pipeline)."""
        return super().get_async(None)

    def add(self, grad: np.ndarray) -> None:
        super().add((grad, None))

    def add_async(self, grad: np.ndarray) -> int:
        return super().add_async((grad, None))
