"""Sharded serving tier — table partitioning, client-side routing, shard
groups with independent failover (port of ``multiverso_tpu/shard/``; the
layout manifest and every frame are the JAX package's, so a router of
either package drives a group of either package). Each shard process keeps
its slice of every table in torch tensors on the group's device.

The reference Multiverso scaled its parameter server horizontally by
range-sharding every table across MPI/ZMQ server ranks, with clients
splitting each request by range and merging the partial replies (the
``Partition``/``ProcessReplyGet`` pair in ``include/multiverso/
table_interface.h``); Li et al. (OSDI'14) make sharded server groups the
core of the PS architecture. This package rebuilds that capability on the
PR 1-3 substrate so throughput scales with server count while every shard
keeps its own retry/dedup window, lease table, WAL, and warm standby:

* :mod:`~multiverso_tpu_torch.shard.partition` — pluggable partitioners
  (contiguous row ranges for array/matrix tables, a stable 64-bit hash
  for KV/sparse keys) plus the serializable layout manifest clients and
  recovery bootstrap from.
* :mod:`~multiverso_tpu_torch.shard.router` — :class:`ShardedClient`, a drop-in
  for :class:`~multiverso_tpu_torch.runtime.remote.RemoteClient` that splits
  Get/Add requests across per-shard ``RemoteClient``\\ s, issues the
  sub-requests in parallel, and merges the partial replies bit-identically
  to a single-server run.
* :mod:`~multiverso_tpu_torch.shard.group` — :class:`ShardGroup`, a launcher
  that starts one serving process per shard (each with its own WAL dir
  and optional warm standby) and publishes the layout manifest.
* :mod:`~multiverso_tpu_torch.shard.reshard` — elastic membership:
  :class:`MigrationCoordinator` executes live key-range **split / merge /
  move** against a running durable group (fresh joiner processes catch up
  over the donors' WAL streams, donors fence at a watermark cutover, the
  layout version bumps and clients re-route in flight — zero acknowledged
  Adds lost), plus :class:`HotRangeDetector`, which proposes splits from
  the live per-shard traffic telemetry.

Operator story: ``docs/sharding.md``.
"""

from multiverso_tpu_torch.shard.partition import (  # noqa: F401
    HashPartitioner, RangePartitioner, make_partitioner,
    partitioner_from_spec, stable_hash64)
from multiverso_tpu_torch.shard.router import (  # noqa: F401
    ShardLayout, ShardedClient, fetch_layout)
from multiverso_tpu_torch.shard.group import ShardGroup  # noqa: F401
from multiverso_tpu_torch.shard.reshard import (  # noqa: F401
    HotRangeDetector, MigrationCoordinator, MigrationError, MigrationPlan,
    plan_merge, plan_move, plan_split)
