"""Checkpoint / resume: table Store/Load over the Stream layer + a periodic
driver (port of ``multiverso_tpu/checkpoint.py``).

Reference capability (not copied): every ``ServerTable`` is ``Serializable``
with ``Store(Stream*)/Load(Stream*)`` over the URI/Stream IO layer
(``include/multiverso/table_interface.h:61-75``).

Format, byte for byte the JAX package's: a self-describing binary frame
per array (``MVTC``, dtype string, ndim, dims, native-endian bytes), the
``MVS2`` updater-state trailer after a dense table's data frame, and the
key-sorted records of the host-dict tables. A snapshot written by either
package loads in the other. ``CheckpointDriver`` snapshots every N steps
or every N seconds to ``<uri>/table_<id>.mvckpt``.

Table state is read on the dispatcher thread (``_run_serialized``), after
every Add queued before the snapshot; the tables' host reads synchronise
with the device, so the bytes follow every launched scatter and upload.
Loads write into the tables' existing tensors, so functions that closed
over them (registered programs, device transactions) see the restored
values.

``CheckpointDriver(wal=mvt.wal_writer())`` switches to the durable
protocol of ``durable/wal.py``: one dispatcher-serialised block rotates
the log, stores every table into ``gen_<g>/``, commits the MANIFEST and
retires older segments and generations.

In a multi-process lockstep world (``runtime/multihost.py``) snapshots and
restores drive from the leader (rank 0) only. A snapshot broadcasts a
``store`` descriptor: every rank takes part in the collective device-to-
host read of its rows, the leader writes the file, and the followers write
to a null sink. A restore reads the file on the leader and broadcasts its
bytes: every rank loads its own row range from them.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch import log
from multiverso_tpu_torch.dashboard import observe

_MAGIC = b"MVTC"


def to_numpy(arr) -> np.ndarray:
    """A host numpy array of ``arr`` (numpy, or a tensor read to the host).
    A tensor dtype with no numpy counterpart (bfloat16, the float8 types)
    is fatal: the frame records numpy's dtype string."""
    if isinstance(arr, torch.Tensor):
        try:
            return arr.detach().to("cpu").numpy()
        except TypeError:
            log.fatal("checkpoint: dtype %s has no numpy counterpart",
                      arr.dtype)
    return np.asarray(arr)


def write_array(stream: mv_io.Stream, arr) -> None:
    arr = np.ascontiguousarray(to_numpy(arr))
    dt = arr.dtype.str.encode("ascii")
    stream.write(_MAGIC)
    stream.write(struct.pack("<B", len(dt)))
    stream.write(dt)
    stream.write(struct.pack("<B", arr.ndim))
    stream.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
    # native-endian bytes, as ndarray.tobytes() gives them, without the copy
    stream.write(arr.reshape(-1).view(np.uint8))


_STATE_MAGIC = b"MVS2"


def write_state_dict(stream: mv_io.Stream, states) -> None:
    """Updater-state trailer (v2 checkpoints): name-keyed arrays after the
    data frame, so AdaGrad/momentum/DCASGD accumulators survive a
    restore."""
    stream.write(_STATE_MAGIC)
    names = sorted(states)
    stream.write(struct.pack("<i", len(names)))
    for name in names:
        nb = name.encode("utf-8")
        stream.write(struct.pack("<B", len(nb)))
        stream.write(nb)
        write_array(stream, states[name])


def read_state_dict(stream: mv_io.Stream) -> dict:
    """Read the v2 trailer; {} for v1 checkpoints (data-only), whose
    updater state resets on restore."""
    magic = stream.read(4)
    if magic != _STATE_MAGIC:
        return {}
    (count,) = struct.unpack("<i", stream.read(4))
    states = {}
    for _ in range(count):
        (nlen,) = struct.unpack("<B", stream.read(1))
        name = stream.read(nlen).decode("utf-8")
        states[name] = read_array(stream)
    return states


def read_array(stream: mv_io.Stream) -> np.ndarray:
    magic = stream.read(4)
    if magic != _MAGIC:
        log.fatal("checkpoint: bad magic %r", magic)
    (dtlen,) = struct.unpack("<B", stream.read(1))
    dtype = np.dtype(stream.read(dtlen).decode("ascii"))
    (ndim,) = struct.unpack("<B", stream.read(1))
    shape = struct.unpack(f"<{ndim}q", stream.read(8 * ndim))
    count = int(np.prod(shape)) if ndim else 1
    data = stream.read(count * dtype.itemsize)
    if len(data) != count * dtype.itemsize:
        log.fatal("checkpoint: truncated array (%d of %d bytes)", len(data),
                  count * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def _require_leader(verb: str) -> None:
    """Multihost: snapshot/restore drive from the leader only — a follower
    calling a raw table's store/load would run the collective read OUTSIDE
    the lockstep replay stream and desynchronize the world. The leader's
    lockstep wrapper broadcasts it to the followers."""
    from multiverso_tpu_torch.runtime.zoo import Zoo
    zoo = Zoo.instance()
    if zoo.rank != 0:
        log.fatal("checkpoint %s must run on the multihost leader (rank 0);"
                  " this is rank %d — followers participate via lockstep "
                  "replay automatically", verb, zoo.rank)


def _run_serialized(fn):
    """Execute ``fn`` on the dispatcher thread, serialized with table
    traffic: a snapshot must follow every Add queued before it (async and
    deferred adds complete to the caller before the update runs). Runs
    inline when no dispatcher exists."""
    from multiverso_tpu_torch.runtime.zoo import Zoo

    server = Zoo.instance().server
    if server is None or not hasattr(server, "run_serialized"):
        return fn()
    # unbounded: a timeout would close the caller's stream while the
    # dispatcher is mid-write, leaving a truncated snapshot behind
    return server.run_serialized(fn, timeout=None)


def store_table(table, address: str) -> None:
    """Store one table (worker or server handle) to a URI. Atomic: the
    bytes land in a temp sibling and commit with a rename, so a crash
    mid-write never leaves a truncated snapshot at the final name."""
    _require_leader("snapshot")
    t0 = time.perf_counter()
    server = getattr(table, "_server_table", table)
    fs = mv_io.fs_for(address)
    tmp = f"{address}.tmp-{os.getpid()}"
    with mv_io.get_stream(tmp, "w") as stream:
        _run_serialized(lambda: server.store(stream))
    fs.replace(tmp, address)
    # per-table store cost (device->host read + stream write + rename)
    observe("CHECKPOINT_STORE_SECONDS", time.perf_counter() - t0)


def load_table(table, address: str) -> None:
    _require_leader("restore")
    t0 = time.perf_counter()
    server = getattr(table, "_server_table", table)
    with mv_io.get_stream(address, "r") as stream:
        _run_serialized(lambda: server.load(stream))
    observe("CHECKPOINT_RESTORE_SECONDS", time.perf_counter() - t0)


def _table_path(directory: str, table) -> str:
    server = getattr(table, "_server_table", table)
    return mv_io.join(directory,
                      f"table_{getattr(server, 'table_id', 0)}.mvckpt")


def restore_tables(tables: List, directory: str) -> int:
    """Load the latest ``CheckpointDriver`` snapshot for each table found
    under ``directory``; returns how many tables were restored. A
    restarted process re-creates its tables in the same order (so table
    ids match the snapshot's) and calls this before training on."""
    fs = mv_io.fs_for(directory)
    restored = 0
    for table in tables:
        path = _table_path(directory, table)
        if fs.exists(path):
            load_table(table, path)
            restored += 1
    return restored


class CheckpointDriver:
    """Periodic snapshot driver over a set of tables.

    ``interval_steps``: snapshot on every Nth ``step()`` call;
    ``interval_seconds``: or on a wall-clock timer thread. Snapshots are
    written to ``<directory>/table_<id>.mvckpt`` with an atomic rename.
    ``directory`` is a URI: any registered scheme works.

    ``wal``: a :class:`multiverso_tpu_torch.durable.wal.WalWriter`
    (``mvt.wal_writer()`` on a serving process) switches snapshots to the
    durable protocol — one dispatcher-serialized block that rotates the
    log, stores every table into a fresh ``gen_<g>/`` directory, commits
    the MANIFEST, and retires segments/generations older than the
    snapshot. Restart recovery for that layout is ``mvt.durable_recover``
    (snapshot + WAL replay), not :meth:`restore`.
    """

    def __init__(self, tables: List, directory: str,
                 interval_steps: Optional[int] = None,
                 interval_seconds: Optional[float] = None,
                 wal=None) -> None:
        self.tables = list(tables)
        self.directory = directory
        self.wal = wal
        if wal is not None and wal.directory != directory:
            # one root holds MANIFEST + gen_<g>/ + wal/ — recovery reads
            # them as a unit, so a split layout could never be replayed
            log.fatal("CheckpointDriver: directory %r must equal the WAL "
                      "root %r (MANIFEST, snapshots and segments are one "
                      "recovery unit)", directory, wal.directory)
        self.interval_steps = interval_steps
        self.interval_seconds = interval_seconds
        self._fs = mv_io.fs_for(directory)
        self._step = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fs.makedirs(directory)
        if interval_seconds:
            self._thread = threading.Thread(target=self._timer_loop, daemon=True)
            self._thread.start()

    def _timer_loop(self) -> None:
        while not self._stop.wait(self.interval_seconds):
            try:
                self.snapshot()
            except Exception as exc:  # a failed store must not kill the timer
                log.error("checkpoint: periodic snapshot to %s failed (%r); "
                          "will retry next interval", self.directory, exc)

    def step(self) -> None:
        self._step += 1
        if self.interval_steps and self._step % self.interval_steps == 0:
            self.snapshot()

    def snapshot(self) -> None:
        with self._lock:
            if self.wal is not None:
                self._durable_snapshot()
                return
            for table in self.tables:
                store_table(table, _table_path(self.directory, table))
            log.debug("checkpoint: snapshot of %d tables -> %s",
                      len(self.tables), self.directory)

    def _durable_snapshot(self) -> None:
        """Snapshot + log compaction as ONE dispatcher-serialized block:
        no add can land between the rotation and the stores, so segments
        >= the rotation point contain exactly the post-snapshot adds.
        The MANIFEST commit is the atomic switch; a crash anywhere in
        here leaves the previous (generation, first_segment) pair live
        and fully replayable."""
        def run():
            first_segment = self.wal.rotate()
            generation = self.wal.generation + 1
            gen_dir = mv_io.join(self.directory, f"gen_{generation}")
            self._fs.makedirs(gen_dir)
            for table in self.tables:
                store_table(table, _table_path(gen_dir, table))
            self.wal.commit_snapshot(generation, first_segment)
        _run_serialized(run)
        log.debug("checkpoint: durable snapshot of %d tables -> %s "
                  "(generation %d)", len(self.tables), self.directory,
                  self.wal.generation)

    def restore(self) -> bool:
        """Load the latest snapshot; returns False when none exists."""
        with self._lock:
            return restore_tables(self.tables, self.directory) > 0

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
