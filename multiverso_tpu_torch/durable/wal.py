"""Write-ahead log + exactly-once restart recovery for served tables (port
of ``multiverso_tpu/durable/wal.py``; host-only, the bytes are the JAX
package's, so a log written by either package recovers in the other).

Reference capability (not copied): Li et al. (OSDI'14) make replayable
logging the core of parameter-server fault tolerance — every applied
update is re-derivable from a snapshot plus a replay log. The reference
code base never shipped that layer (its ``Store/Load`` hooks were
point-in-time only); this module is the rebuild's version, riding the
same Stream/FileSystem seam the checkpoint layer uses, so the log lands
on any registered scheme (``file://`` local, ``mvfs://`` remote).

Layout under the durability root (the ``wal_dir`` flag)::

    <root>/MANIFEST                      # {"generation": g, "first_segment": s}
    <root>/gen_<g>/table_<id>.mvckpt     # snapshot generation g
    <root>/wal/seg<SSSSSSSS>.t<id>.mvwal # per-table log segments

Record format (within a segment, after a small segment header)::

    u32 crc32(body) | u32 body_len | body
    body = i64 req_id | i32 worker | i64 msg_id | i32 nblobs | blobs...

Blobs are the Add's RAW wire blobs (runtime/wire.py encoding — sparse /
quantized payloads ride as-is), serialized with the checkpoint array
framing. Appends happen on the dispatcher thread immediately before the
add is applied, so **WAL order equals apply order** and replay reproduces
the table bit-for-bit; the append completes before the ACK leaves, so an
acknowledged Add is always either in the log or in the snapshot.

The MANIFEST is the atomic commit point for compaction: a snapshot
rotates the log, stores every table into a fresh generation directory,
then commits ``{generation, first_segment}`` with a tmp+rename — only
after that are older segments and generations retired. A crash at ANY
point leaves the manifest naming a complete (snapshot, log-suffix) pair.

Recovery (:func:`recover`) loads the manifest generation's snapshot,
replays segments ``>= first_segment`` — truncating at the first
bad-checksum/torn record — and returns the replayed ``(req_id, worker,
msg_id)`` triples so the serving layer can rebuild its idempotent-replay
window: a client retransmitting an Add that was logged before the crash
gets a synthesized ACK instead of a second apply.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.checkpoint import (
    _run_serialized, load_table, read_array, write_array)
from multiverso_tpu_torch.dashboard import count, gauge_set, observe
from multiverso_tpu_torch.obs.profiler import clear_wait, mark_wait
from multiverso_tpu_torch.obs.trace import hop
from multiverso_tpu_torch.runtime.contracts import dispatcher_only

_SEG_MAGIC = b"MVWL"
_SEG_VERSION = 1
_SEG_HDR = struct.Struct("<4sBiq")  # magic, version, table_id, segment
_REC_HDR = struct.Struct("<II")     # crc32(body), body length
_REC_BODY = struct.Struct("<qiqi")  # req_id, worker, msg_id, nblobs
_SEG_NAME = re.compile(r"^seg(\d{8})\.t(\d+)\.mvwal$")
_SYNC_LEVELS = ("none", "batch", "always")


@dataclass
class WalRecord:
    """One logged Add: identity triple + the raw wire blobs."""

    table_id: int
    req_id: int
    worker: int
    msg_id: int
    blobs: List[np.ndarray]


def _encode_record(req_id: int, worker: int, msg_id: int,
                   blobs: List[np.ndarray]) -> bytes:
    buf = mv_io.MemoryStream()
    buf.write(_REC_BODY.pack(req_id, worker, msg_id, len(blobs)))
    for arr in blobs:
        write_array(buf, np.asarray(arr))
    body = buf.getvalue()
    return _REC_HDR.pack(zlib.crc32(body), len(body)) + body


def _read_segment(data: bytes, path: str
                  ) -> Tuple[Optional[List[WalRecord]], int, bool]:
    """Parse one segment's bytes -> (records, valid_byte_length, clean).
    ``records`` is None when the segment header itself is unreadable;
    ``clean`` is False when a torn/bad-checksum tail was cut off."""
    if len(data) < _SEG_HDR.size:
        return None, 0, False
    magic, version, table_id, _segment = _SEG_HDR.unpack_from(data, 0)
    if magic != _SEG_MAGIC or version != _SEG_VERSION:
        log.error("wal: %s has a bad segment header (magic %r v%d)",
                  path, magic, version)
        return None, 0, False
    records: List[WalRecord] = []
    off = _SEG_HDR.size
    while off < len(data):
        if off + _REC_HDR.size > len(data):
            return records, off, False  # torn record header
        crc, blen = _REC_HDR.unpack_from(data, off)
        body = data[off + _REC_HDR.size: off + _REC_HDR.size + blen]
        if len(body) < blen or zlib.crc32(body) != crc:
            return records, off, False  # torn or corrupt body
        req_id, worker, msg_id, nblobs = _REC_BODY.unpack_from(body, 0)
        stream = mv_io.MemoryStream(body)
        stream.seek(_REC_BODY.size)
        blobs = [read_array(stream) for _ in range(nblobs)]
        records.append(WalRecord(table_id, req_id, worker, msg_id, blobs))
        off += _REC_HDR.size + blen
    return records, off, True


# -- manifest -----------------------------------------------------------------

def read_manifest(directory: str) -> Dict[str, int]:
    """The committed recovery point; defaults for a fresh root."""
    fs = mv_io.fs_for(directory)
    path = mv_io.join(directory, "MANIFEST")
    if not fs.exists(path):
        return {"generation": -1, "first_segment": 0}
    with mv_io.get_stream(path, "r") as stream:
        return json.loads(stream.read().decode("utf-8"))


def _write_manifest(directory: str, generation: int,
                    first_segment: int) -> None:
    fs = mv_io.fs_for(directory)
    path = mv_io.join(directory, "MANIFEST")
    tmp = path + ".tmp"
    with mv_io.get_stream(tmp, "w") as stream:
        stream.write(json.dumps({"generation": generation,
                                 "first_segment": first_segment}).encode())
        stream.sync()
    fs.replace(tmp, path)


def _list_segments(fs, wal_dir: str) -> List[Tuple[int, int, str]]:
    """Sorted (segment, table_id, filename) for every segment file."""
    out = []
    for name in fs.listdir(wal_dir):
        match = _SEG_NAME.match(name)
        if match:
            out.append((int(match.group(1)), int(match.group(2)), name))
    return sorted(out)


# -- writer -------------------------------------------------------------------

class WalWriter:
    """Per-table append log under ``<directory>/wal/``.

    ``append`` runs on the dispatcher thread (the caller guarantees it),
    so records within a table are totally ordered with applies; the lock
    only guards against lifecycle calls (rotate/close, observers) from
    other threads. Observers — the standby replication fan-out — see every
    record after it is durable per the sync policy, i.e. the standby never
    holds a record the log could lose.
    """

    def __init__(self, directory: str, sync: Optional[str] = None) -> None:
        self.directory = directory
        self._fs = mv_io.fs_for(directory)
        self._fs.makedirs(directory)
        self.wal_dir = mv_io.join(directory, "wal")
        self._fs.makedirs(self.wal_dir)
        self.sync = (sync if sync is not None
                     else str(config.get_flag("wal_sync"))).strip().lower()
        if self.sync not in _SYNC_LEVELS:
            log.fatal("wal_sync must be one of %s, got %r",
                      "|".join(_SYNC_LEVELS), self.sync)
        manifest = read_manifest(directory)
        self.generation = int(manifest["generation"])
        self.first_segment = int(manifest["first_segment"])
        existing = [seg for seg, _tid, _n in
                    _list_segments(self._fs, self.wal_dir)]
        # resume appending into the highest live segment (restart path)
        self.segment = max(existing) if existing else self.first_segment
        self._streams: Dict[int, mv_io.Stream] = {}
        self._observers: List[Callable] = []
        self._lock = threading.Lock()
        self._closed = False
        # append watermark: records appended by THIS writer, monotonic
        # within the process. The read-replica tier's staleness unit: the
        # primary advertises it on replies/heartbeats, each replicated
        # record carries its own sequence, and a replica's replay
        # watermark is the last sequence it applied (docs/serving.md).
        # Starts at 0 per incarnation — replicas adopt the primary's
        # stamps at subscribe time, and clients treat a watermark
        # REGRESSION (new primary after failover/restart) as a full
        # cache flush, so cross-incarnation continuity is not required.
        self.seq = 0
        # replay debt: bytes appended since the last committed snapshot
        # (restart recovery replays roughly this much). Starts at 0 on a
        # resumed log — the gauge tracks THIS process's contribution.
        self._backlog_bytes = 0

    # -- append path ---------------------------------------------------------
    def _seg_path(self, table_id: int, segment: int) -> str:
        return mv_io.join(self.wal_dir,
                          f"seg{segment:08d}.t{table_id}.mvwal")

    def _stream_for(self, table_id: int) -> mv_io.Stream:
        stream = self._streams.get(table_id)
        if stream is None:
            path = self._seg_path(table_id, self.segment)
            fresh = not self._fs.exists(path)
            stream = mv_io.get_stream(path, "a")
            if not stream.good():
                log.fatal("wal: cannot open segment %s", path)
            if fresh:
                stream.write(_SEG_HDR.pack(_SEG_MAGIC, _SEG_VERSION,
                                           table_id, self.segment))
            self._streams[table_id] = stream
        return stream

    @dispatcher_only
    def append(self, req_id: int, worker: int, table_id: int, msg_id: int,
               blobs: List[np.ndarray]) -> int:
        """Append one record; returns its sequence number (the append
        watermark after this record)."""
        t0 = time.perf_counter()
        record = _encode_record(req_id, worker, msg_id, blobs)
        with self._lock:
            if self._closed:
                log.error("wal: append after close (req %d dropped from "
                          "the log; the table still applies it)", req_id)
                return self.seq
            stream = self._stream_for(table_id)
            stream.write(record)
            if self.sync == "batch":
                stream.flush()
            elif self.sync == "always":
                t_sync = time.perf_counter()
                # profiler wait site: the fsync parks the dispatcher on
                # the disk, the canonical off-CPU wait of durable mode
                _prev_wait = mark_wait("wal_fsync")
                try:
                    stream.sync()
                finally:
                    clear_wait(_prev_wait)
                # the fsync dominates wal_sync=always appends — its own
                # distribution separates disk stalls from encode cost
                observe("WAL_FSYNC_SECONDS", time.perf_counter() - t_sync)
            self._backlog_bytes += len(record)
            self.seq += 1
            seq = self.seq
            observers = list(self._observers)
        count("WAL_APPENDS")
        observe("WAL_APPEND_SECONDS", time.perf_counter() - t0)
        gauge_set("WAL_BACKLOG_BYTES", self._backlog_bytes)
        hop(req_id, "wal_append")
        for observer in observers:
            observer(seq, req_id, worker, table_id, msg_id, blobs)
        return seq

    def add_observer(self, fn: Callable) -> None:
        """``fn(seq, req_id, worker, table_id, msg_id, blobs)`` after each
        durable append — the replication fan-out seam."""
        with self._lock:
            self._observers.append(fn)

    # -- compaction (driven by CheckpointDriver snapshots) -------------------
    def rotate(self) -> int:
        """Close the current segments and start the next; returns the NEW
        segment index — the replay floor for a snapshot taken now."""
        with self._lock:
            self._close_streams()
            self.segment += 1
            return self.segment

    def commit_snapshot(self, generation: int, first_segment: int) -> None:
        """Atomically switch the recovery point to (generation,
        first_segment), then retire everything older. Called only after
        the generation's snapshot files are fully on disk."""
        _write_manifest(self.directory, generation, first_segment)
        old_generation = self.generation
        self.generation = generation
        self.first_segment = first_segment
        retired = 0
        for seg, _tid, name in _list_segments(self._fs, self.wal_dir):
            if seg < first_segment:
                try:
                    self._fs.remove(mv_io.join(self.wal_dir, name))
                    retired += 1
                except OSError as exc:
                    log.error("wal: could not retire %s: %r", name, exc)
        for gen in range(max(0, old_generation), generation):
            self._remove_generation(gen)
        with self._lock:
            self._backlog_bytes = 0
        gauge_set("WAL_BACKLOG_BYTES", 0)
        count("SNAPSHOT_COMPACTIONS")
        log.debug("wal: compacted to generation %d / segment %d "
                  "(%d segment file(s) retired)", generation, first_segment,
                  retired)

    def _remove_generation(self, generation: int) -> None:
        gen_dir = mv_io.join(self.directory, f"gen_{generation}")
        for name in self._fs.listdir(gen_dir):
            try:
                self._fs.remove(mv_io.join(gen_dir, name))
            except OSError:
                pass
        uri = mv_io.URI.parse(gen_dir)
        if uri.scheme == "file":
            try:
                os.rmdir(uri.path)
            except OSError:
                pass

    # -- lifecycle -----------------------------------------------------------
    def _close_streams(self) -> None:
        for stream in self._streams.values():
            try:
                if self.sync != "none":
                    stream.sync()
                stream.close()
            except OSError as exc:
                log.error("wal: segment close failed: %r", exc)
        self._streams.clear()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._close_streams()


# -- recovery -----------------------------------------------------------------

@dataclass
class RecoveryResult:
    """What :func:`recover` did — and the dedup seeds serve() needs."""

    tables_restored: int = 0
    records_replayed: int = 0
    segments_truncated: int = 0
    # replayed (req_id, worker, msg_id) in replay order: the serving
    # layer rebuilds its idempotent-replay window from these
    seeds: List[Tuple[int, int, int]] = field(default_factory=list)


def _truncate_local(path: str, valid: int) -> None:
    """Physically cut a torn/corrupt tail so later tails (standby resync,
    the next recovery) never re-read garbage. Local scheme only — remote
    schemes just stop replaying at the tear."""
    uri = mv_io.URI.parse(path)
    if uri.scheme != "file":
        return
    try:
        with open(uri.path, "r+b") as fp:
            fp.truncate(valid)
    except OSError as exc:
        log.error("wal: could not truncate %s at %d: %r", path, valid, exc)


def recover(tables: List[Any], directory: str) -> RecoveryResult:
    """Exactly-once restart recovery: manifest snapshot + WAL replay.

    Call after the restarted process re-created its tables (same order,
    so table ids match) and BEFORE ``serve()``; pass the returned seeds
    to the serving layer (``mv.durable_recover`` does both). Replay
    applies each record's decoded request directly via ``process_add`` on
    the dispatcher thread, in log order — which equals the original apply
    order — so the recovered table is bit-identical to the pre-crash
    state for every logged Add. On the card each replayed row Add runs
    the ``scatter_add_rows`` kernel, as a live one does. A fused
    micro-batch is logged Add by Add and replayed so: its duplicate rows
    sum in another order, which is bitwise the same for integer-valued
    deltas (and for a primary that does not fuse, ``apply_batch_msgs``
    0), and may differ in the last bit otherwise.
    """
    from multiverso_tpu_torch.runtime import wire

    fs = mv_io.fs_for(directory)
    manifest = read_manifest(directory)
    result = RecoveryResult()
    by_id: Dict[int, Any] = {}
    for table in tables:
        server_table = getattr(table, "_server_table", table)
        by_id[int(getattr(server_table, "table_id", 0))] = server_table

    if manifest["generation"] >= 0:
        gen_dir = mv_io.join(directory, f"gen_{manifest['generation']}")
        for table_id, server_table in by_id.items():
            path = mv_io.join(gen_dir, f"table_{table_id}.mvckpt")
            if fs.exists(path):
                load_table(server_table, path)
                result.tables_restored += 1

    wal_dir = mv_io.join(directory, "wal")
    dead: set = set()  # tables whose log tore mid-history: stop replaying
    for seg, table_id, name in _list_segments(fs, wal_dir):
        if seg < int(manifest["first_segment"]):
            continue  # pre-snapshot leftover; retired at next compaction
        if table_id in dead:
            log.error("wal: skipping %s — an earlier segment of table %d "
                      "was truncated, later records would leave a gap",
                      name, table_id)
            continue
        path = mv_io.join(wal_dir, name)
        with mv_io.get_stream(path, "r") as stream:
            data = stream.read()
        records, valid, clean = _read_segment(data, path)
        if records is None:
            log.error("wal: %s is unreadable — skipped", name)
            dead.add(table_id)
            continue
        if not clean:
            result.segments_truncated += 1
            count("WAL_TRUNCATED_TAIL")
            dead.add(table_id)  # only a final tear is crash-consistent
            _truncate_local(path, valid)
            log.error("wal: %s had a torn/corrupt tail at byte %d — "
                      "truncated, %d record(s) kept", name, valid,
                      len(records))
        server_table = by_id.get(table_id)
        if server_table is None:
            log.error("wal: %s references unknown table %d — skipped "
                      "(tables must be re-created in the original order)",
                      name, table_id)
            continue

        def replay(server_table=server_table, records=records):
            for record in records:
                server_table.process_add(wire.decode(record.blobs))
            return len(records)

        replayed = _run_serialized(replay)
        count("WAL_REPLAYED", replayed)
        result.records_replayed += replayed
        result.seeds.extend((r.req_id, r.worker, r.msg_id) for r in records)
    log.info("durable recovery from %s: %d table(s) restored, %d record(s) "
             "replayed, %d truncated tail(s)", directory,
             result.tables_restored, result.records_replayed,
             result.segments_truncated)
    return result
