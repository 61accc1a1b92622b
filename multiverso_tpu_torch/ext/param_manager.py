"""Model parameter managers: a whole model's params in ONE ArrayTable (port
of ``multiverso_tpu/ext/param_manager.py``).

Parity with ``binding/python/multiverso/theano_ext/param_manager.py:9-90``
(``MVModelParamManager``) and its lasagne/keras subclasses: flatten every
parameter into a single 1-D table; ``sync_all_param()`` pushes the delta
since the last sync and writes the merged global value back into the model.

* :class:`PytreeParamManager` keeps the JAX package's name for its twin: it
  manages a nested dict/list/tuple of tensors (for example a module's
  ``dict(named_parameters())``), flattened with dict keys sorted, as JAX
  flattens a pytree. The manager owns the current tree (``.params``) and
  ``sync()`` returns the merged one.
* :class:`TorchParamManager` — a ``torch.nn.Module``, written back in place
  (the Torch-Lua binding's per-parameter handlers, ``binding/lua/``).

The per-worker views (:meth:`PytreeParamManager.worker_view`) sync in the
table's device leaf forms (``sync_leaves_async`` and friends): the model
never leaves the device. In a multi-process lockstep world the table's
device IO is off and the views take the host path; the table is seeded
once per world (the master worker is rank 0's slot 0) behind a
``process_barrier``.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.tables.array_table import LeafList
from multiverso_tpu_torch.utils import torch_dtype


def admin_seed(table, flat=None):
    """Master-seed a freshly created table and read its settled value, all
    as ADMINISTRATIVE (un-clocked) traffic. Setup must not be charged to a
    worker's round budget: under BSP an unbound thread defaults to slot 0
    and a gated Get would wedge the round gate before training starts.
    Master-ness is decided BEFORE entering admin (inside, the thread has
    no worker identity at all). ``flat=None`` skips the seeding add (the
    table already carries state)."""
    from multiverso_tpu_torch.runtime.zoo import Zoo
    zoo = Zoo.instance()
    is_master = mvt.is_master_worker()
    with zoo.admin():
        if flat is not None and is_master:
            table.add(flat)
        zoo.process_barrier()
        return table.get()


def tree_flatten(tree: Any) -> Tuple[list, Any]:
    """``(leaves, treedef)`` of a nested dict/list/tuple; every other value
    is a leaf. Dict keys are taken sorted (JAX's order), so a dict built in
    another insertion order flattens the same. Two trees have the same
    structure iff their treedefs compare equal."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node),
                    tuple(walk(x) for x in node))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: Sequence) -> Any:
    """The tree of ``treedef`` (from :func:`tree_flatten`) over ``leaves``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind, keys, children = node
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, children)}
        built = [build(c) for c in children]
        return tuple(built) if kind == "tuple" else built

    return build(treedef)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class ParamManager:
    """Base manager. Subclasses implement :meth:`get_all_param_values` /
    :meth:`set_all_param_values` over lists of numpy arrays
    (``param_manager.py:43-59`` contract)."""

    def __init__(self) -> None:
        values = self.get_all_param_values()
        self._shapes = [v.shape for v in values]
        self._dtypes = [v.dtype for v in values]
        self._sizes = [int(v.size) for v in values]
        flat = np.concatenate(
            [np.asarray(v, dtype=np.float32).reshape(-1) for v in values]
        ) if values else np.zeros(0, np.float32)
        # master-only Add into a zero table (see sharedvar.py)
        self._table = mvt.create_table("array", flat.size, np.float32)
        self._last_synced = admin_seed(self._table, flat)
        self._set_from_flat(self._last_synced)

    # -- subclass surface ---------------------------------------------------
    def get_all_param_values(self) -> List[np.ndarray]:
        raise NotImplementedError

    def set_all_param_values(self, values: Sequence[np.ndarray]) -> None:
        raise NotImplementedError

    # -- internals ----------------------------------------------------------
    def _flat(self) -> np.ndarray:
        values = self.get_all_param_values()
        if not values:
            return np.zeros(0, np.float32)
        return np.concatenate(
            [np.asarray(v, dtype=np.float32).reshape(-1) for v in values])

    def _set_from_flat(self, flat: np.ndarray) -> None:
        out, n = [], 0
        for shape, dtype, size in zip(self._shapes, self._dtypes, self._sizes):
            out.append(flat[n:n + size].reshape(shape).astype(dtype))
            n += size
        self.set_all_param_values(out)

    @property
    def table(self):
        return self._table

    # -- API ----------------------------------------------------------------
    def sync_all_param(self) -> None:
        """Push local delta, pull merged params, write back into the model
        (``param_manager.py:70-83``)."""
        current = self._flat()
        self._table.add(current - self._last_synced)
        self._last_synced = self._table.get()
        self._set_from_flat(self._last_synced)

    sync = sync_all_param


class PytreeParamManager(ParamManager):
    """Manage a nested dict/list/tuple of tensors (the JAX package's
    pytree manager, over torch). Leaves keep their device and dtype."""

    def __init__(self, params: Any) -> None:
        self._leaves, self._treedef = tree_flatten(params)
        self._devices = [leaf.device if isinstance(leaf, torch.Tensor)
                         else torch.device("cpu") for leaf in self._leaves]
        super().__init__()

    @property
    def params(self) -> Any:
        return tree_unflatten(self._treedef, self._leaves)

    @params.setter
    def params(self, tree: Any) -> None:
        leaves, treedef = tree_flatten(tree)
        if treedef != self._treedef:
            mvt.log.fatal("pytree structure changed across sync")
        self._leaves = leaves

    def get_all_param_values(self) -> List[np.ndarray]:
        return [_host(leaf) for leaf in self._leaves]

    def set_all_param_values(self, values: Sequence[np.ndarray]) -> None:
        self._leaves = [torch.from_numpy(np.array(v)).to(dev)
                        for v, dev in zip(values, self._devices)]

    def sync(self, params: Any = None) -> Any:
        """Functional spelling: ``params = manager.sync(params)``."""
        if params is not None:
            self.params = params
        self.sync_all_param()
        return self.params

    sync_all_param = ParamManager.sync_all_param

    def worker_view(self, device: bool = False) -> "PytreeWorkerSync":
        """Per-worker syncer over this manager's SHARED table. Each view
        owns its own last-synced baseline, which is the reference's actual
        topology — every process tracked its own delta base
        (``param_manager.py:70-83`` ran once per process). Sharing one
        manager between threads instead makes worker A's push subtract
        worker B's freshly-merged work. Views need no lock: table add/get
        are dispatcher-serialized.

        ``device=True`` keeps the whole sync on the table's device (the
        table's leaf forms): no host copy of the model per sync."""
        return PytreeWorkerSync(self, device=device)


class PytreeWorkerSync:
    """See :meth:`PytreeParamManager.worker_view`. Starts from the current
    global table value; ``sync(tree)`` pushes this worker's delta and
    returns the merged global tree.

    On the device the view's baselines are tensor sets the server replied
    with: nothing else references them, and the view never mutates them,
    so a queued request may read them later. Trees it hands out are fresh
    tensor sets the caller may train on in place."""

    def __init__(self, manager: "PytreeParamManager",
                 device: bool = False) -> None:
        from multiverso_tpu_torch.runtime.zoo import Zoo
        self._treedef = manager._treedef
        self._shapes = manager._shapes
        self._dtypes = [torch_dtype(d) for d in manager._dtypes]
        self._sizes = manager._sizes
        self._devices = manager._devices
        self._table = manager.table
        self._zoo = Zoo.instance()
        # pipelined-sync state (sync_pipelined/drain): the outstanding
        # push's handle, and the baseline matching what the caller is
        # currently computing FROM (one reply behind _last)
        self._inflight = None
        self._last_handed = None
        self._device = bool(device) and getattr(
            self._table, "supports_device_io", False)
        if self._device:
            template = [torch.empty(s, dtype=d, device="meta")
                        for s, d in zip(self._shapes, self._dtypes)]
            with self._zoo.admin():  # setup read: un-clocked
                self._last = self._table.wait(
                    self._table.get_leaves_async(template))
        else:
            with self._zoo.admin():
                self._last = self._table.get()

    def _unflatten(self, flat) -> Any:
        if self._device:
            return tree_unflatten(self._treedef, list(flat))
        leaves, n = [], 0
        for shape, dtype, size, dev in zip(self._shapes, self._dtypes,
                                           self._sizes, self._devices):
            # a copy: the caller may train on it in place, and _last is
            # the next delta's base
            leaves.append(torch.from_numpy(
                np.array(flat[n:n + size]).reshape(shape)).to(dev, dtype))
            n += size
        return tree_unflatten(self._treedef, leaves)

    @staticmethod
    def _copy(leaves: list) -> list:
        if isinstance(leaves, LeafList):
            return leaves.clone()       # one copy of the flat tensor
        return [x.clone() for x in leaves]

    @property
    def params(self) -> Any:
        if self._inflight is not None:
            mvt.log.fatal("a pipelined sync is outstanding; call drain() "
                          "before reading params")
        if self._device:  # hand out copies: callers train in place
            return self._unflatten(self._copy(self._last))
        return self._unflatten(self._last)

    def _leaves(self, tree: Any) -> list:
        leaves, treedef = tree_flatten(tree)
        if treedef != self._treedef:
            mvt.log.fatal("pytree structure changed across sync")
        return leaves

    def sync(self, tree: Any) -> Any:
        leaves = self._leaves(tree)
        if self._device:
            last = self._last
            if self._inflight is not None:
                # mixing after sync_pipelined: consume the outstanding
                # reply, but the delta base for THIS push must stay the
                # value the caller computed FROM (_last_handed) — rebasing
                # onto the drained merged value would subtract peers'
                # (and our own in-flight) work from the delta
                self._table.wait(self._inflight)
                self._inflight = None
                last = self._last_handed
                self._last_handed = None
            if not getattr(self._zoo.server, "plain_async", False):
                # BSP (a fused reply samples at apply time and cannot honor
                # the round-gated Get contract) or deferred apply
                # (deterministic: the fused reply would be None):
                # reply-free pair push, then a properly gated Get
                self._table.wait(self._table.push_leaves_async(leaves, last))
                merged = self._table.wait(self._table.get_leaves_async(leaves))
                # the baseline keeps its own buffers: the caller trains on
                # the returned tree in place
                self._last = self._copy(merged)
                return self._unflatten(merged)
            # one dispatcher hop: the server computes new - last, applies
            # the update and replies (merged, baseline)
            merged, self._last = self._table.wait(
                self._table.sync_leaves_async(leaves, last_leaves=last))
            return self._unflatten(merged)
        flat = np.concatenate(
            [np.asarray(_host(l), dtype=np.float32).reshape(-1) for l in leaves]
        ) if leaves else np.zeros(0, np.float32)
        self._table.add(flat - self._last)
        self._last = self._table.get()
        return self._unflatten(self._last)

    def sync_pipelined(self, tree: Any) -> Any:
        """One-round-stale sync that never blocks on the server: submits
        this round's push and returns the PREVIOUS round's merged value
        (the reference's double-buffer prefetch shape,
        ``ps_model.cpp:236-271``, applied to ASGD). The local delta is
        never lost — it is in flight.

        Delta bookkeeping needs TWO baselines: the push's ``last`` must be
        the value the worker actually computed FROM (the tree handed out
        two calls ago), not the latest merged value — using the latest
        would subtract the worker's own in-flight push from its next
        delta. Falls back to blocking :meth:`sync` on servers that gate
        or defer (BSP/deterministic), where rounds cannot overlap."""
        if not self._device or not getattr(self._zoo.server,
                                           "plain_async", False):
            return self.sync(tree)
        leaves = self._leaves(tree)
        handed = self._last_handed
        first = handed is None
        merged_prev = baseline_prev = None
        if first:
            # first call hands back the view's init value, a copy the
            # caller may train on; the init value itself stays the base of
            # this push and of the next one (nothing mutates a baseline)
            handed = baseline_prev = self._last
            merged_prev = self._copy(handed)
        handle = self._table.sync_leaves_async(leaves, last_leaves=handed)
        if not first:
            # the async Server never replies None (gated/deferred servers
            # were routed to sync() above and cannot change mid-run)
            merged_prev, baseline_prev = self._table.wait(self._inflight)
        self._inflight = handle
        self._last_handed = baseline_prev
        return self._unflatten(merged_prev)

    def drain(self) -> Any:
        """Complete an outstanding :meth:`sync_pipelined` push and return
        the up-to-date merged tree (call once after the training loop)."""
        inflight = self._inflight
        if inflight is None:
            return self.params
        merged, self._last = self._table.wait(inflight)
        self._inflight = None
        self._last_handed = None
        return self._unflatten(merged)


class TorchParamManager(ParamManager):
    """Manage a ``torch.nn.Module``'s parameters, written back in place."""

    def __init__(self, module: Any) -> None:
        self._module = module
        super().__init__()

    @property
    def module(self) -> Any:
        return self._module

    def get_all_param_values(self) -> List[np.ndarray]:
        return [p.detach().cpu().numpy() for p in self._module.parameters()]

    def set_all_param_values(self, values: Sequence[np.ndarray]) -> None:
        with torch.no_grad():
            for p, v in zip(self._module.parameters(), values):
                p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
