"""Tiered beyond-RAM table storage (port of ``multiverso_tpu/store/``).

``TieredStore`` keeps a table's hot rows RAM-resident under
``tier_resident_bytes`` and spills the cold tail to quantized,
CRC-framed on-disk segments (``ColdStore``); the sparse and KV server
tables plug it in behind their normal ``process_add``/``process_get``
contracts (``tables/sparse_table.py``, ``tables/kv_table.py``). Host-only:
nothing of it lives on the device, in either package."""

from multiverso_tpu_torch.store.coldstore import ColdStore
from multiverso_tpu_torch.store.tiered import (
    DEMOTE_BATCH_ROWS, FrequencySketch, TieredStore)

__all__ = ["ColdStore", "DEMOTE_BATCH_ROWS", "FrequencySketch",
           "TieredStore"]
