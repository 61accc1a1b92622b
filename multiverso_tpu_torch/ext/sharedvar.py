"""Shared-variable wrapper over an ArrayTable (port of
``multiverso_tpu/ext/sharedvar.py``).

Parity with ``binding/python/multiverso/theano_ext/sharedvar.py:12-99``
(``MVSharedVariable`` / ``mv_shared`` / ``sync_all_mv_shared_vars``): a
host value of any shape is mirrored into a 1-D table; ``sync()`` adds the
local delta since the last sync and pulls the merged value. Only the master
worker's ``init_value`` seeds the table (``sharedvar.py:24-25`` contract).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

import multiverso_tpu_torch as mvt


class SharedArray:
    """A host array mirrored into an ArrayTable. The value is a plain
    ndarray; framework glue lives in
    :mod:`multiverso_tpu_torch.ext.param_manager`."""

    def __init__(self, value: Any, dtype: Any = np.float32,
                 table=None) -> None:
        value = np.asarray(value, dtype=dtype)
        self._shape = value.shape
        self._dtype = value.dtype
        from multiverso_tpu_torch.ext.param_manager import admin_seed
        if table is None:
            # seed via a master-only Add into a zero table (the reference's
            # scheme, sharedvar.py:24-25); admin_seed runs it un-clocked
            # (BSP-safe) and settles the initial value
            table = mvt.create_table("array", value.size, self._dtype)
            initial = admin_seed(table, value.reshape(-1))
        else:
            initial = admin_seed(table)
        self._table = table
        self._last_synced = initial.reshape(self._shape)
        self._value = self._last_synced.copy()

    @property
    def value(self) -> np.ndarray:
        return self._value

    @value.setter
    def value(self, new: Any) -> None:
        new = np.asarray(new, dtype=self._dtype)
        if new.shape != self._shape:
            mvt.log.fatal("SharedArray shape mismatch: %s vs %s",
                          new.shape, self._shape)
        self._value = new

    @property
    def table(self):
        return self._table

    def sync(self) -> np.ndarray:
        """Push ``value - last_synced`` and pull the merged global value."""
        self._table.add((self._value - self._last_synced).reshape(-1))
        merged = self._table.get().reshape(self._shape)
        self._value = merged.copy()
        self._last_synced = merged
        return self._value

    # reference spelling
    mv_sync = sync


shared_vars: List[SharedArray] = []


def mv_shared(value: Any, dtype: Any = np.float32) -> SharedArray:
    """Create a :class:`SharedArray` and record it in the global registry
    (``sharedvar.py:79-88``)."""
    sv = SharedArray(value, dtype)
    shared_vars.append(sv)
    return sv


def sync_all_shared_vars() -> None:
    """Sync every registry entry (``sync_all_mv_shared_vars`` parity)."""
    for sv in shared_vars:
        sv.sync()
