"""Durability subsystem: write-ahead logging, exactly-once restart
recovery, and warm-standby failover (port of ``multiverso_tpu/durable/``).

A crash of the serving process used to discard every acknowledged Add
since the last snapshot, and the req-id dedup window died with the
process. This package closes that:

* :mod:`~multiverso_tpu_torch.durable.wal` — per-table write-ahead log
  over the Stream layer (CRC-checksummed, length-prefixed records appended
  on the dispatcher thread before an Add is ACKed), snapshot-coupled
  segment rotation/compaction, and ``recover()`` = snapshot + WAL replay +
  dedup-window reconstruction, so exactly-once holds ACROSS restarts. The
  files are the JAX package's byte for byte.
* :mod:`~multiverso_tpu_torch.durable.standby` — a warm-standby server
  that tails the primary's WAL over a replication stream, detects primary
  death by lease expiry, and binds the service endpoint so client
  reconnect logic resumes against it transparently; ``serve_reads()``
  makes it a read replica.

Not yet ported: ``durable/migrate.py`` (``RangeTailer``,
``translate_add``) and ``durable/cut.py``, which serve the shard group
(``shard/``) and arrive with it.
"""

import os as _os

from multiverso_tpu_torch.durable.wal import (  # noqa: F401
    RecoveryResult, WalRecord, WalWriter, read_manifest, recover)
from multiverso_tpu_torch.durable.standby import WarmStandby  # noqa: F401


def shard_wal_dir(root: str, shard: int) -> str:
    """Per-shard durability root under a shard group's base directory:
    ``<root>/shard<k>``. One WAL + snapshot lineage per shard — a shard's
    crash/recovery/compaction never touches its peers' logs, and a
    restarted member finds its own manifest by shard id alone."""
    return _os.path.join(str(root), f"shard{int(shard)}")
