"""Request/Reply message model for the host-side dispatcher.

Reference capability (not copied): ``Message``/``MsgType`` wire protocol —
8-int header (src, dst, type, table_id, msg_id) + blob payload, with a
reply constructor that negates the type
(``include/multiverso/message.h:13-66``).

A copy of ``multiverso_tpu/runtime/message.py``. In-process there is no
wire — requests travel from worker contexts to the dispatcher through a
queue, and the "payload" is numpy arrays or torch tensors. The type taxonomy (and its sign convention:
positive → server-bound request, negative → worker-bound reply, >=32 →
control) is preserved because the consistency machinery (sync server clocks,
barrier) and the external C-API bridge both dispatch on it.
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional


class MsgType(enum.IntEnum):
    # server-bound requests (positive, < 32)
    Request_Get = 1
    Request_Add = 2
    # slot-free read (read-replica tier, durable/standby.py +
    # runtime/read.py): a Get that takes NO worker slot, NO lease and NO
    # dedup entry — served by replicas and by the primary's admin path,
    # with the request's staleness budget and the reply's replay
    # watermark riding the header's watermark field
    Request_Read = 3
    Server_Execute = 30  # run a callable on the dispatcher thread (admin)
    Server_Finish_Train = 31
    # worker-bound replies (negative)
    Reply_Get = -1
    Reply_Add = -2
    Reply_Read = -3
    Reply_Error = -5  # request failed server-side / peer connection lost
    # stale-layout refusal (shard/reshard.py migration cutover): the
    # request carried a layout version older than the shard's installed
    # layout, so its routing may be wrong — the server REFUSES before
    # applying and ships the new manifest in the reply payload so the
    # router re-fetches and re-routes without an extra Control_Layout
    # round trip. Reply-only by design: no positive wire type requests a
    # refusal — it is the error arm of Request_Get/Request_Add
    Reply_WrongShard = -6  # mvlint: ignore[msg-pairs]
    # control plane (>= 32 request, <= -32 reply).  Value 33 (the
    # reference repo's Control_Barrier) is retired: barriers are
    # threading.Barrier in-process and multihost.barrier() across hosts,
    # so the wire type was dead — do not reuse the value.
    Control_Register = 34
    Control_Reply_Register = -34
    # graceful client close frees its worker slot; fire-and-forget by
    # design — the closing side cannot wait on a reply from a socket it
    # is tearing down
    Control_Deregister = 35  # mvlint: ignore[msg-pairs]
    # remote worker lease renewal (fault/detector.py); fire-and-forget —
    # a lease beat that needed an ACK would turn the liveness plane into
    # a second request plane
    Control_Heartbeat = 36  # mvlint: ignore[msg-pairs]
    # warm-standby replication (durable/standby.py): a standby subscribes
    # with Control_Replicate, receives a quiesced full-state transfer in
    # the reply, then tails the primary's WAL as Control_Wal_Record frames
    Control_Replicate = 37
    Control_Reply_Replicate = -37
    # one-way replication stream: per-record ACKs would serialize the
    # primary's apply path on the standby's RTT; loss is detected by seq
    # gaps at the standby instead
    Control_Wal_Record = 38  # mvlint: ignore[msg-pairs]
    # live stats RPC (obs/): mv.stats(endpoint) pulls a remote server's
    # full dashboard — monitors, counters, gauges, histograms serialized
    # as bucket arrays — without registering a worker slot
    Control_Stats = 39
    Control_Reply_Stats = -39
    # shard layout RPC (shard/): any member of a shard group answers with
    # the group's layout manifest (endpoints + per-table partitioner
    # specs) so clients bootstrap from one known endpoint
    Control_Layout = 40
    Control_Reply_Layout = -40
    # shared-memory transport negotiation (runtime/shm.py): a dialing
    # client offers a ring-segment pair right after connect; the server
    # maps it and accepts (or refuses — the client falls back to TCP).
    # Handled INSIDE the transport (runtime/net.py) — these frames never
    # reach the mailbox/dispatcher.
    Control_Shm = 41
    Control_Reply_Shm = -41
    # watermark probe (read-replica tier): any serving process answers
    # with its role and watermark position — primary: WAL append seq;
    # replica: replay seq + the primary append seq it has observed —
    # slot-free like the stats probe
    Control_Watermark = 42
    Control_Reply_Watermark = -42
    # trace pull RPC (obs/collector.py): any serving process ships the
    # recent contents of its per-request trace store — req_id -> hops —
    # plus its wall clock at reply time, so a TraceCollector can estimate
    # per-process clock offsets and stitch cross-process spans. Slot-free
    # like the stats/watermark probes.
    Control_Traces = 43
    Control_Reply_Traces = -43
    # live key-range migration (shard/reshard.py + durable/migrate.py): a
    # joining shard subscribes to a donor's WAL restricted to the
    # migrating id ranges; the reply carries a quiesced raw-value
    # transfer of exactly those ranges plus the donor's WAL watermark,
    # and the subscriber then tails Control_Wal_Record frames like a
    # standby (filtering to its ranges client-side)
    Control_Migrate = 44
    Control_Reply_Migrate = -44
    # migration cutover RPC: install the attached manifest (layout
    # version bump — the donor starts refusing stale-stamped requests
    # with Reply_WrongShard) and answer with the WAL seq after the
    # dispatcher drain: every acknowledged Add is <= that watermark, so
    # the recipient is caught up once its replay reaches it. Also the
    # rollback vehicle: aborting a migration re-installs the old
    # topology under a HIGHER version through the same RPC
    Control_Migrate_Cutover = 45
    Control_Reply_Migrate_Cutover = -45
    # profile pull RPC (obs/profiler.py + obs/critpath.py): any serving
    # process ships its sampling-profiler report — per-thread self-time,
    # wait-site seconds, collapsed stacks — so a collector can attach
    # "why is it slow" attribution to stitched traces. Slot-free like
    # the stats/watermark/traces probes: profiling a wedged server is
    # exactly when every slot is taken
    Control_Profile = 46
    Control_Reply_Profile = -46
    # consistent-cut marker RPC (durable/cut.py): a fleet coordinator
    # fans this over every shard primary; the shard drains its
    # dispatcher, snapshots every table at its WAL fence into a
    # cut_<id>/ directory OUTSIDE the compaction lineage, and replies
    # the fence + per-table digests. The coordinator commits the atomic
    # fleet manifest only after every member answered — a shard killed
    # mid-cut (the MV_CUT_KILL drill) fails the whole cut and the
    # previous manifest stays the recovery point
    Control_Cut = 47
    Control_Reply_Cut = -47
    # state-digest probe (obs/audit.py): any serving process — primary,
    # replica, standby serving reads — answers with an order-independent
    # per-table content digest at its current watermark, computed under
    # its dispatcher seam so the (digest, watermark) pair is exact.
    # Slot-free like the stats/watermark probes: auditing a wedged or
    # diverged server is exactly when every slot is taken
    Control_Digest = 48
    Control_Reply_Digest = -48
    # retrieval query plane (multiverso_tpu/query/ + docs/serving.md §8):
    # a slot-free top-k scoring request — query matrix + k + metric
    # (dot|cosine) ride the payload; like Request_Read it takes NO worker
    # slot, NO lease and NO dedup entry (queries are idempotent reads),
    # is served by replicas under the same staleness-budget admission
    # (the budget rides the request's watermark field), and the reply's
    # watermark is the serving process's replay/append position. The
    # value pair sits OUTSIDE the <32 request band on purpose: control-
    # band framing keeps the v4/v5 wire headers untouched while the
    # dispatch ladders treat it as a data request.
    Request_Query = 49
    Reply_Query = -49

    @property
    def is_server_bound(self) -> bool:
        return 0 < self.value < 32

    @property
    def is_worker_bound(self) -> bool:
        return self.value < 0

    @property
    def is_control(self) -> bool:
        return abs(self.value) >= 32


_msg_id_counter = itertools.count(1)
_msg_id_lock = threading.Lock()


def next_msg_id() -> int:
    with _msg_id_lock:
        return next(_msg_id_counter)


@dataclass
class Message:
    src: int = -1
    dst: int = -1
    type: MsgType = MsgType.Request_Get
    table_id: int = -1
    msg_id: int = 0
    # Idempotency key for retried wire requests (fault/retry.py): a remote
    # client stamps every correlated request with a session-unique id so the
    # server's dedup window applies a replayed Add exactly once. 0 = not
    # replayable (in-process messages, raw-channel frames, fire-and-forget
    # control traffic). Distinct from msg_id, which stays the reply
    # correlation key.
    req_id: int = 0
    # WAL-record position (read-replica tier, docs/serving.md). On a
    # reply/record frame: the sender's watermark — a primary stamps its
    # append sequence, a replica its replay sequence, a Control_Wal_Record
    # the record's own sequence (gap detection). On a Request_Read: the
    # client's staleness budget in records (-1 = unbounded). -1 elsewhere.
    watermark: int = -1
    # Trace flag: ride-along bit in the v4 header (the high bit of the
    # channel byte — no version bump). A traced request asks every hop it
    # crosses — router, shard primary, replica, standby, multihost
    # forward — to keep recording under its req_id AND to preserve the
    # flag on any frame it derives (forwards, confirms). Replies inherit
    # it via create_reply. Hop recording itself stays keyed on
    # req_id != 0; the flag's job is propagation and the read tier's
    # primary watermark-confirm leg.
    trace: bool = False
    # Absolute deadline in LOCAL time.monotonic() seconds (0.0 = none).
    # Never crosses a process boundary as an absolute instant — the wire
    # header (runtime/net.py v5) carries the REMAINING budget in
    # microseconds, and each receiver re-anchors it against its own
    # monotonic clock, so wall-clock skew between hosts cannot expire (or
    # resurrect) a request. Each hop that re-encodes the frame decrements
    # the budget by its own queueing + transit time for free. Consumers:
    # the server dispatcher drops expired work at drain time
    # (deadline_exceeded) instead of burning an apply nobody awaits;
    # forwarding hops (shard router parts, read-tier forwards) copy it
    # onto derived requests. 0.0 ("legacy peer / no deadline") is never
    # refused. Replies don't carry it — by reply time the wait is over.
    deadline: float = 0.0
    data: List[Any] = field(default_factory=list)
    # Host clock (time.perf_counter) at which Server.send queued this
    # message; 0.0 = never queued. Local to this process, never on the
    # wire: the dispatcher's SERVER_QUEUE_WAIT_* sections time from it to
    # the start of the message's apply.
    sent_at: float = 0.0

    def create_reply(self) -> "Message":
        """Reply retraces the path: swap src/dst, negate type."""
        return Message(
            src=self.dst,
            dst=self.src,
            type=MsgType(-int(self.type)),
            table_id=self.table_id,
            msg_id=self.msg_id,
            req_id=self.req_id,
            trace=self.trace,
        )
