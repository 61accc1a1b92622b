"""Logistic / softmax / FTRL regression, the reference's second application
(port of ``multiverso_tpu/models/logreg.py``).

The reference's LogisticRegression app: linear / sigmoid / softmax / FTRL
objectives, L1/L2 regularizers, dense or sparse features, local or
parameter-server mode with sync-frequency pulls and a double-buffered
pipeline, and custom user tables (``Applications/LogisticRegression/src/``).

The gradients stay closed-form torch ops: a dense product, or a padded
sparse gather/segment-dot whose scatter back is ``index_add_``. Sparse
minibatches are static-shape ``(B, max_nnz)`` index/value pads (index -1
masks a slot). The PS path uses the array table (dense, sgd updater), the
sparse-key table (``config.sparse``: pushes are O(nnz)), the dense FTRL
table or the sparse FTRL table, with ``sync_frequency`` pulls and an
optional prefetch (``pipeline``).

:class:`LogReg` keeps its weights on ``cuda`` unless the caller asks for
the CPU; :class:`PSLogReg` keeps its replica on the runtime's device.
Both update their weight tensor in place.

Config files and streaming minibatch readers are in ``models/lr_io.py``;
:func:`load_libsvm` reads any registered stream scheme, and plain local
files through the native multithreaded reader (:func:`load_libsvm_native`,
``native/text_reader.cpp``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import monitor
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.zoo import Zoo


@dataclass(frozen=True)
class LogRegConfig:
    input_size: int                 # feature count (bias handled separately)
    output_size: int = 1            # 1 → sigmoid/ftrl; >1 → softmax
    objective: str = "sigmoid"      # "sigmoid" | "softmax" | "ftrl"
    regular: str = "none"           # "none" | "l1" | "l2"
    regular_coef: float = 0.0
    lr: float = 0.1
    minibatch: int = 256
    sparse: bool = False
    max_nnz: int = 64               # padded nnz per sparse sample
    # PS-mode knobs (reference: ps_model.cpp)
    use_ps: bool = False
    sync_frequency: int = 1
    pipeline: bool = False
    # app updater (reference configure.h:91 "[default] [sgd] [ftrl]"):
    # "default" subtracts the RAW gradient (lr unused); "sgd" scales by a
    # decayed lr: max(1e-3, lr - updates/(lr_coef*minibatch)); "ftrl" = the
    # optimizer lives in the FTRL table (objective "ftrl").
    updater_type: str = "sgd"
    lr_coef: float = 1e6
    # FTRL hyperparameters
    alpha: float = 0.1
    beta: float = 1.0
    lambda1: float = 1.0
    lambda2: float = 1.0
    seed: int = 0


def _dense_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w: (O, I+1) with bias column; x: (B, I)."""
    return x @ w[:, :-1].T + w[:, -1]


def _sparse_logits(w: torch.Tensor, idx: torch.Tensor,
                   val: torch.Tensor) -> torch.Tensor:
    """idx/val: (B, N) padded with idx=-1 (masked: bias only). w gathered
    per nonzero: (B, N, O)."""
    mask = (idx >= 0).to(val.dtype)
    rows = torch.clamp(idx, min=0).long()
    w_feat = w[:, :-1].T[rows]                      # (B, N, O)
    contrib = torch.einsum("bn,bno->bo", val * mask, w_feat)
    return contrib + w[:, -1]


def _grad_and_loss(config: LogRegConfig):
    """``(w, batch) -> (grad, loss)`` for the configured objective, closed
    form (no autograd)."""
    softmax = config.output_size > 1 and config.objective == "softmax"

    def from_logits(logits, y):
        if softmax:
            logp = torch.log_softmax(logits, dim=1)
            y = y.long()
            loss = -logp.gather(1, y[:, None]).mean()
            dlogits = (torch.exp(logp) - F.one_hot(y, logits.shape[1]).to(
                logits.dtype)) / y.shape[0]
        else:
            yf = y.to(logits.dtype).reshape(logits.shape)
            p = torch.sigmoid(logits)
            eps = 1e-7
            loss = -(yf * torch.log(p + eps)
                     + (1 - yf) * torch.log(1 - p + eps)).mean()
            dlogits = (p - yf) / y.shape[0]
        return loss, dlogits

    if not config.sparse:
        def gl(w, batch):
            x, y = batch["x"], batch["y"]
            logits = _dense_logits(w, x)
            loss, dlogits = from_logits(logits, y)
            dlogits = dlogits.reshape(x.shape[0], -1)
            grad_w = dlogits.T @ x                  # (O, I)
            grad_b = dlogits.sum(dim=0)             # (O,)
            return torch.cat([grad_w, grad_b[:, None]], dim=1), loss
        return gl

    def gl_sparse(w, batch):
        idx, val, y = batch["idx"], batch["val"], batch["y"]
        logits = _sparse_logits(w, idx, val)
        loss, dlogits = from_logits(logits, y)
        dlogits = dlogits.reshape(idx.shape[0], -1)   # (B, O)
        mask = (idx >= 0).to(val.dtype)
        rows = torch.clamp(idx, min=0).long()
        # grad for feature f in sample b: val[b,n] * dlogits[b,:]
        contrib = torch.einsum("bn,bo->bno", val * mask, dlogits)
        grad_w = torch.zeros((w.shape[1] - 1, w.shape[0]), dtype=w.dtype,
                             device=w.device).index_add_(
            0, rows.reshape(-1), contrib.reshape(-1, dlogits.shape[1]))
        grad_b = dlogits.sum(dim=0)
        return torch.cat([grad_w.T, grad_b[:, None]], dim=1), loss

    return gl_sparse


def _check_updater_type(config: LogRegConfig) -> None:
    if config.objective not in ("sigmoid", "softmax", "ftrl"):
        log.fatal("objective %r not in sigmoid|softmax|ftrl",
                  config.objective)
    if config.regular not in ("none", "l1", "l2"):
        log.fatal("regular %r not in none|l1|l2", config.regular)
    if config.updater_type not in ("default", "sgd", "ftrl"):
        log.fatal("updater_type %r not in default|sgd|ftrl",
                  config.updater_type)
    if config.updater_type == "ftrl" and config.objective != "ftrl":
        log.fatal("updater_type=ftrl requires objective=ftrl (the FTRL "
                  "optimizer lives in the table)")


def _effective_lr(config: LogRegConfig, updates: int,
                  override: Optional[float]) -> float:
    """Reference SGDUpdater::Process decay; 'default' subtracts raw. The
    1e-3 decay floor never RAISES the rate above the configured lr."""
    if override is not None:
        return override
    if config.updater_type == "default":
        return 1.0
    floor = min(1e-3, config.lr)
    return max(floor, config.lr - updates / (config.lr_coef * config.minibatch))


def _regularizer_grad(config: LogRegConfig):
    if config.regular == "l2":
        return lambda w: config.regular_coef * w
    if config.regular == "l1":
        return lambda w: config.regular_coef * torch.sign(w)
    return lambda w: torch.zeros_like(w)


def _to_device(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class LogReg:
    """Local-mode model: weights on one device, an SGD train step of torch
    ops (reference ``Model``; see :class:`PSLogReg` for ``PSModel``). The
    initial weights are numpy draws from ``config.seed``, as in the JAX
    package, so both start equal."""

    def __init__(self, config: LogRegConfig, device: str = "cuda") -> None:
        if config.objective == "ftrl" and not config.use_ps:
            log.fatal("ftrl objective runs through the FTRL table (use_ps=True)")
        _check_updater_type(config)
        self.config = config
        self.device = mesh_lib.build_device(str(device))
        self._updates = 0
        rng = np.random.default_rng(config.seed)
        self.w = torch.from_numpy(
            rng.normal(0, 0.01, (config.output_size, config.input_size + 1))
            .astype(np.float32)).to(self.device)
        self._gl = _grad_and_loss(config)
        self._reg = _regularizer_grad(config)

    def _logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.config.sparse:
            return _sparse_logits(self.w, batch["idx"], batch["val"])
        return _dense_logits(self.w, batch["x"])

    # -- API ---------------------------------------------------------------
    def update(self, batch: Dict[str, np.ndarray],
               lr: Optional[float] = None) -> float:
        with monitor("LOGREG_UPDATE"):
            batch = _to_device(batch, self.device)
            lr = _effective_lr(self.config, self._updates, lr)
            grad, loss = self._gl(self.w, batch)
            self.w.sub_(lr * (grad + self._reg(self.w)))
            self._updates += 1
            return float(loss)

    def load_weights(self, w: np.ndarray) -> None:
        """Warm start (reference: init_model_file, ps_model.cpp:116-154)."""
        self.w = torch.from_numpy(np.array(w, np.float32).reshape(
            self.config.output_size, self.config.input_size + 1)).to(self.device)

    def predict(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        logits = self._logits(_to_device(batch, self.device))
        if self.config.output_size > 1:
            return torch.argmax(logits, dim=1).cpu().numpy()
        return (torch.sigmoid(logits) > 0.5).to(torch.int32).reshape(-1).cpu().numpy()

    def test(self, batch: Dict[str, np.ndarray]) -> float:
        pred = self.predict(batch)
        return float((pred == np.asarray(batch["y"]).reshape(-1)).mean())

    def weights(self) -> np.ndarray:
        return self.w.cpu().numpy()


class PSLogReg(LogReg):
    """Parameter-server mode: weights live in an array table (dense), a
    sparse-key table keyed by feature id (``config.sparse``: pushes are
    O(nnz)), or an FTRL table (dense accumulators or sparse struct-valued);
    the local replica, on the runtime's device, syncs every
    ``sync_frequency`` minibatches, optionally through a prefetch
    (reference: ``ps_model.cpp:172-271``)."""

    def __init__(self, config: LogRegConfig) -> None:
        _check_updater_type(config)
        self.config = config
        self.device = Zoo.instance().device
        self._updates = 0
        self._n = config.output_size * (config.input_size + 1)
        self._bias_key = config.input_size
        self._gl = _grad_and_loss(config)
        self._reg = _regularizer_grad(config)
        # table selection (reference: CreateTable in ps_model.cpp). Sparse
        # tables carry one OUTPUT COLUMN per feature key (width =
        # output_size), so a touched feature ships output_size floats.
        if config.sparse:
            from multiverso_tpu_torch.tables.sparse_table import (
                SparseWorker, make_sparse_ftrl)
            mvt.register_table_type("sparse", SparseWorker)
            mvt.register_table_type("sparse_ftrl", make_sparse_ftrl)
            keys = config.input_size + 1  # + bias key
            if config.objective == "ftrl":
                self.table = mvt.create_table(
                    "sparse_ftrl", keys, width=config.output_size,
                    alpha=config.alpha, beta=config.beta,
                    lambda1=config.lambda1, lambda2=config.lambda2)
            else:
                self.table = mvt.create_table(
                    "sparse", keys, width=config.output_size,
                    updater_type="sgd")
        elif config.objective == "ftrl":
            from multiverso_tpu_torch.tables.ftrl_table import FTRLWorker
            mvt.register_table_type("ftrl", FTRLWorker)
            self.table = mvt.create_table(
                "ftrl", self._n, alpha=config.alpha, beta=config.beta,
                lambda1=config.lambda1, lambda2=config.lambda2)
        else:
            self.table = mvt.create_table(
                "array", self._n, np.float32, updater_type="sgd")
        self._set_w(self._pull())
        self._batches_since_sync = 0
        self._pending_get: Optional[int] = None
        self._pending_adds: list = []

    def _set_w(self, w: np.ndarray) -> None:
        self.w = torch.from_numpy(w).to(self.device)

    def _to_w(self, raw) -> np.ndarray:
        """The dense (O, I+1) replica from a table reply."""
        o, cols = self.config.output_size, self.config.input_size + 1
        if self.config.sparse:
            keys, vals = raw
            w = np.zeros((o, cols), np.float32)
            if len(keys):
                w[:, keys] = vals.T
            return w
        return np.array(raw, np.float32).reshape(o, cols)

    def _pull(self) -> np.ndarray:
        return self._to_w(self.table.get())

    def update(self, batch: Dict[str, np.ndarray],
               lr: Optional[float] = None) -> float:
        lr = _effective_lr(self.config, self._updates, lr)
        self._updates += 1
        idx_np = np.asarray(batch["idx"]) if self.config.sparse else None
        grad, loss = self._gl(self.w, _to_device(batch, self.device))
        push = grad + self._reg(self.w)
        if self.config.sparse:
            # O(nnz) push: only the minibatch's touched feature columns (+
            # bias) cross to the host. Regularization is LAZY in sparse
            # mode: a feature decays only when a batch touches it
            touched = np.unique(idx_np[idx_np >= 0]).astype(np.int64)
            keys = np.concatenate([touched, [self._bias_key]])
            cols = push[:, torch.from_numpy(keys).to(self.device)].T.cpu().numpy()
            if self.config.objective == "ftrl":
                mid = self.table.add_async(keys, cols)  # server runs FTRL
            else:
                mid = self.table.add_async(keys, lr * cols)  # sgd updater: -=
        elif self.config.objective == "ftrl":
            mid = self.table.add_async(push.cpu().numpy().reshape(-1))
        else:
            # the sgd updater applies data -= delta: ship the lr-scaled
            # gradient
            mid = self.table.add_async(lr * push.cpu().numpy().reshape(-1))
        self._pending_adds.append(mid)
        self._batches_since_sync += 1
        if self._batches_since_sync >= self.config.sync_frequency:
            self._sync()
        return float(loss)

    def _sync(self) -> None:
        self._batches_since_sync = 0
        # reclaim the outstanding Add completions (the dispatcher applied
        # them before any later Get: FIFO)
        for mid in self._pending_adds:
            self.table.wait(mid)
        self._pending_adds.clear()
        with monitor("PS_LOGREG_PULL"):
            if self.config.pipeline and self._pending_get is not None:
                raw = self.table.wait(self._pending_get)
                self._set_w(self._to_w(raw))
                self._pending_get = self.table.get_async()
            elif self.config.pipeline:
                self._pending_get = self.table.get_async()
                self._set_w(self._pull())
            else:
                self._set_w(self._pull())

    def finish(self) -> None:
        for mid in self._pending_adds:
            self.table.wait(mid)
        self._pending_adds.clear()
        if self._pending_get is not None:
            self.table.wait(self._pending_get)
            self._pending_get = None
        self._set_w(self._pull())

    def load_weights(self, w: np.ndarray) -> None:
        """Warm start THROUGH the table so every worker sees it (reference
        PSModel::Load pushes the loaded model as a delta). Not available
        for FTRL tables: their z/n cannot be derived from weights."""
        if self.config.objective == "ftrl":
            log.fatal("init model into an FTRL table is unsupported "
                      "(optimizer state is not derivable from weights)")
        o, cols = self.config.output_size, self.config.input_size + 1
        w = np.asarray(w, np.float32).reshape(o, cols)
        delta = self._pull() - w  # sgd-family tables apply data -= delta
        if self.config.sparse:
            self.table.add(np.arange(cols, dtype=np.int64), delta.T)
        else:
            self.table.add(delta.reshape(-1))
        self._set_w(self._pull())


def make_model(config: LogRegConfig, device: str = "cuda") -> LogReg:
    """Reference factory (``Model::Get`` on use_ps): local vs PS model.
    ``device`` places a local model; a PS model follows the runtime."""
    return PSLogReg(config) if config.use_ps else LogReg(config, device)


# -- data ------------------------------------------------------------------

def parse_libsvm_line(line: str, max_nnz: int) -> Tuple[int, np.ndarray, np.ndarray]:
    parts = line.split()
    label = int(float(parts[0]))
    idx = np.full(max_nnz, -1, np.int32)
    val = np.zeros(max_nnz, np.float32)
    for i, tok in enumerate(parts[1:max_nnz + 1]):
        k, _, v = tok.partition(":")
        idx[i] = int(k)
        val[i] = float(v) if v else 1.0
    return label, idx, val


def load_libsvm_native(path: str, max_nnz: int = 64
                       ) -> Optional[Dict[str, np.ndarray]]:
    """Native multithreaded libsvm parse (``native/text_reader.cpp``, the
    analog of the reference's C++ sample readers, ``reader.cpp``). The
    output is byte-identical to the Python parser's. Returns None where
    the file is not a plain local file or the parse fails (a malformed
    label, an index out of int32): the Python path then reports the line.
    The library is built at first use; a failed build raises."""
    import ctypes
    import os

    from multiverso_tpu_torch import native
    lib = native.load()
    if not os.path.isfile(path):
        return None
    res = native.LibsvmResult()
    # os.fsencode: filenames with surrogate escapes (non-UTF-8 on-disk
    # names) must round-trip, not raise UnicodeEncodeError
    if lib.MVTR_ParseLibsvmFile(os.fsencode(path), int(max_nnz),
                                ctypes.byref(res)) != 0:
        return None
    try:
        n = int(res.n_rows)
        if not n:
            return {"y": np.zeros(0, np.int32),
                    "idx": np.full((0, max_nnz), -1, np.int32),
                    "val": np.zeros((0, max_nnz), np.float32)}
        return {"y": np.ctypeslib.as_array(res.labels, (n,)).astype(np.int32),
                "idx": np.ctypeslib.as_array(res.indices, (n, max_nnz))
                .astype(np.int32),
                "val": np.ctypeslib.as_array(res.values, (n, max_nnz))
                .astype(np.float32)}
    finally:
        lib.MVTR_FreeResult(ctypes.byref(res))


def load_libsvm(path: str, max_nnz: int = 64) -> Dict[str, np.ndarray]:
    """Load a LibSVM-format file into padded sparse batch arrays. ``path``
    is a URI: any registered Stream scheme works. Plain local files take
    the native reader; where it declines, the Python parser runs."""
    if "://" not in path:
        native = load_libsvm_native(path, max_nnz)
        if native is not None:
            return native
    from multiverso_tpu_torch.io import TextReader
    labels, idxs, vals = [], [], []
    reader = TextReader(path)
    try:
        while (line := reader.get_line()) is not None:
            if not line.strip():
                continue
            y, idx, val = parse_libsvm_line(line, max_nnz)
            labels.append(y)
            idxs.append(idx)
            vals.append(val)
    finally:
        reader.close()
    if not labels:  # empty/all-blank file
        return {"y": np.zeros(0, np.int32),
                "idx": np.full((0, max_nnz), -1, np.int32),
                "val": np.zeros((0, max_nnz), np.float32)}
    return {"y": np.array(labels, np.int32), "idx": np.stack(idxs),
            "val": np.stack(vals)}


def minibatches(data: Dict[str, np.ndarray], batch_size: int,
                rng: Optional[np.random.Generator] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(data["y"])
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for i in range(0, n - batch_size + 1, batch_size):
        sl = order[i:i + batch_size]
        yield {k: v[sl] for k, v in data.items()}
