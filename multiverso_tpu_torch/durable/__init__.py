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
* :mod:`~multiverso_tpu_torch.durable.migrate` — range-filtered WAL
  tailing for live key-range migration (shard/reshard.py): a joining
  shard absorbs a quiesced raw-value transfer of exactly the migrating
  ranges, then tails the donor's record stream — translating donor ids to
  its own — up to the cutover watermark.
* :mod:`~multiverso_tpu_torch.durable.cut` — watermark-consistent fleet
  cuts, point-in-time restore and blue/green clones of a shard group.
"""

import os as _os

from multiverso_tpu_torch.durable.wal import (  # noqa: F401
    RecoveryResult, WalRecord, WalWriter, read_manifest, recover)
from multiverso_tpu_torch.durable.standby import WarmStandby  # noqa: F401
from multiverso_tpu_torch.durable.migrate import (  # noqa: F401
    RangeTailer, translate_add)


def shard_wal_dir(root: str, shard: int) -> str:
    """Per-shard durability root under a shard group's base directory:
    ``<root>/shard<k>``. One WAL + snapshot lineage per shard — a shard's
    crash/recovery/compaction never touches its peers' logs, and a
    restarted member finds its own manifest by shard id alone."""
    return _os.path.join(str(root), f"shard{int(shard)}")
