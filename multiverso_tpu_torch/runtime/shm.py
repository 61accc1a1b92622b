"""Shared-memory ring transport for colocated client/server processes
(port of ``multiverso_tpu/runtime/shm.py``).

The dominant local deployment (serving process + client processes on ONE
host) pays the full TCP tax per frame: two kernel copies, a syscall each
way, and loopback scheduling latency. This module supplies the receive-side
mirror of the send coalescing in ``runtime/net.py``: a pair of single-producer/single-
consumer byte rings in a file-backed shared mapping, one per direction,
carrying the SAME v3 frame stream ``runtime/net.py`` puts on a TCP socket.
Because the ring is just a byte stream with identical framing + CRC +
req-id contract, everything layered above the transport — dedup windows,
retransmit, per-request tracing, and the ChaosNet corrupt/drop seams —
works unchanged; the only difference is that a frame crosses the host as
one memcpy instead of two syscalls.

Negotiation (runtime/net.py drives it; this module is mechanism only):

* the DIALING side creates the two ring files, initializes both headers,
  and sends a ``Control_Shm`` offer (paths + capacity) as the first frame
  on the fresh TCP connection;
* the accepting side maps the files and answers ``Control_Reply_Shm``
  over TCP; on refusal (flag off, unmappable path — i.e. a non-colocated
  peer) the client keeps the TCP path, transparently;
* after the accept lands, the client UNLINKS both files — both sides hold
  live mappings, so the segments outlive the names and nothing can leak
  even through ``kill -9`` on either side.

The TCP connection stays up as the liveness channel: a peer death is
detected by the socket (exactly like the pure-TCP path), which closes the
rings; ring waiters poll closed flags and fail fast.

Ring layout (little-endian, 64-byte header, data region follows)::

    0  u32 magic 'MVSM'    8  u64 capacity (bytes, multiple of 8)
    4  u32 version         16 u64 head — bytes ever written (producer)
                           24 u64 tail — bytes ever read   (consumer)
                           32 u32 writer_closed
                           36 u32 reader_closed

Single writer, single reader (callers lock around multi-writer use): the
producer copies payload THEN bumps ``head``; the consumer copies THEN bumps
``tail``. Aligned 8-byte stores through a ``memoryview.cast('Q')`` are
single machine stores on the platforms this runs on, and CPython cannot
reorder them across bytecodes, so the counters are safe without locks.
Waiters spin briefly, then back off to bounded sleeps — an idle connection
costs a few hundred wakeups/second, a hot one never leaves the spin.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
import time
from typing import Any, List

from multiverso_tpu_torch import config
from multiverso_tpu_torch.obs.profiler import clear_wait, mark_wait

MAGIC = 0x4D56534D  # 'MVSM'
VERSION = 1
HEADER_SIZE = 64

# counter/flag slots in the 64-byte header (indices into cast views)
_Q_CAPACITY = 1   # u64 index (byte 8)
_Q_HEAD = 2       # u64 index (byte 16)
_Q_TAIL = 3       # u64 index (byte 24)
_I_MAGIC = 0      # u32 index (byte 0)
_I_VERSION = 1    # u32 index (byte 4)
_I_WRITER_CLOSED = 8   # u32 index (byte 32)
_I_READER_CLOSED = 9   # u32 index (byte 36)

# Wait policy: a short pure spin, a few yields (``sleep(0)`` releases
# the GIL and hands the core to the producer — a hot pure-python spin
# would hold the GIL for whole 5 ms switch intervals and starve the very
# thread producing the data), then real sleeps quickly. Real sleeps are
# load-bearing, not just polite: they remove the poller from the
# runqueue, so on core-constrained hosts (1-core containers, packed
# serving boxes) the dispatcher's compute is not taxed by a yield
# carousel; the cost is ≤ one sleep quantum of extra latency. The ladder
# caps at 1 ms — an idle connection costs ~1k cheap wakeups/second.
_SPIN = 20
_YIELD = 60
_SLEEP_BASE = 100e-6
_SLEEP_MAX = 1e-3

# The spin budget is a live knob (``wire_shm_spin``): the autotuner backs
# it off toward 0 when shm_ring_spin wait dominates the profile. Updated
# through the config watch seam — the wait path itself never takes the
# registry lock.
_spin_live = [max(0, int(config.get_flag("wire_shm_spin")))]


def _on_spin_change(_name: str, value) -> None:
    _spin_live[0] = max(0, int(value))


config.FLAGS.on_change("wire_shm_spin", _on_spin_change)

_counter_lock = threading.Lock()
_counter = [0]

_shm_metrics_cache = None


def _shm_metrics():
    """SHM metric objects resolved once — the registry lock must not sit
    on the per-frame path (mirrors net._send_metrics; Dashboard.reset
    zeroes objects in place so cached references stay live)."""
    global _shm_metrics_cache
    if _shm_metrics_cache is None:
        from multiverso_tpu_torch.dashboard import Dashboard
        _shm_metrics_cache = (Dashboard.counter("SHM_TX_FRAMES"),
                              Dashboard.counter("SHM_TX_BYTES"),
                              Dashboard.counter("SHM_RX_FRAMES"),
                              Dashboard.counter("SHM_RING_FULL_WAITS"))
    return _shm_metrics_cache


def shm_dir() -> str:
    """Segment-file directory: the ``wire_shm_dir`` flag, else /dev/shm
    (a tmpfs — the mapping never touches disk), else the temp dir."""
    configured = str(config.get_flag("wire_shm_dir"))
    if configured:
        return configured
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return tempfile.gettempdir()


def make_segment_paths() -> tuple:
    """A fresh (c2s, s2c) path pair, collision-free across processes
    (pid + per-process counter + random suffix in the name)."""
    with _counter_lock:
        _counter[0] += 1
        n = _counter[0]
    tag = f"mvtpu-shm-{os.getpid()}-{n}-{os.urandom(4).hex()}"
    base = os.path.join(shm_dir(), tag)
    return base + ".c2s", base + ".s2c"


def _sleep_for(idle: int) -> None:
    # the ladder keeps its shape under a live spin budget: yield band
    # width and sleep ramp are unchanged, only the spin edge moves
    spin = _spin_live[0]
    yield_end = spin + (_YIELD - _SPIN)
    if idle < spin:
        return
    if idle < yield_end:
        time.sleep(0)
        return
    time.sleep(min(_SLEEP_BASE * (1 << min((idle - yield_end) // 64, 4)),
                   _SLEEP_MAX))


class Ring:
    """One direction of the channel: an SPSC byte ring over a file-backed
    mapping. ``create`` initializes the header (the dialing side does this
    for both rings); ``open`` maps and validates an existing one."""

    def __init__(self, mm: mmap.mmap, path: str) -> None:
        self._mm = mm
        self._view = memoryview(mm)
        self._q = self._view[:HEADER_SIZE].cast("Q")
        self._i = self._view[:HEADER_SIZE].cast("I")
        self.capacity = int(self._q[_Q_CAPACITY])
        self._data = self._view[HEADER_SIZE:HEADER_SIZE + self.capacity]
        self.path = path
        self._disposed = False

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, path: str, capacity: int) -> "Ring":
        capacity = max(1 << 12, int(capacity)) & ~7  # >=4KiB, 8-aligned
        size = HEADER_SIZE + capacity
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)  # the mapping keeps the file alive
        view = memoryview(mm)
        q = view[:HEADER_SIZE].cast("Q")
        i = view[:HEADER_SIZE].cast("I")
        q[_Q_CAPACITY] = capacity
        q[_Q_HEAD] = 0
        q[_Q_TAIL] = 0
        i[_I_WRITER_CLOSED] = 0
        i[_I_READER_CLOSED] = 0
        i[_I_VERSION] = VERSION
        i[_I_MAGIC] = MAGIC  # last: a reader seeing the magic sees a
        # fully-initialized header
        q.release()
        i.release()
        view.release()
        return cls(mm, path)

    @classmethod
    def open(cls, path: str) -> "Ring":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        ring = cls(mm, path)
        if (ring._i[_I_MAGIC] != MAGIC or ring._i[_I_VERSION] != VERSION
                or HEADER_SIZE + ring.capacity > size):
            ring.dispose()
            raise OSError(f"shm: {path} is not a valid ring segment")
        return ring

    # -- state ---------------------------------------------------------------
    @property
    def writer_closed(self) -> bool:
        return bool(self._i[_I_WRITER_CLOSED])

    @property
    def reader_closed(self) -> bool:
        return bool(self._i[_I_READER_CLOSED])

    def close_writer(self) -> None:
        if not self._disposed:
            self._i[_I_WRITER_CLOSED] = 1

    def close_reader(self) -> None:
        if not self._disposed:
            self._i[_I_READER_CLOSED] = 1

    def dispose(self) -> None:
        """Release the mapping (best effort: a racing blocked peer thread
        may still hold a view — then the GC finishes the job later)."""
        self._disposed = True
        try:
            self._data.release()
            self._q.release()
            self._i.release()
            self._view.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass

    # -- producer ------------------------------------------------------------
    def write(self, buf) -> int:
        """Append ``buf`` to the stream; blocks while the ring is full
        (slow-reader backpressure — the sendall analog). Frames larger
        than the ring stream through in chunks. Raises OSError once either
        side closed."""
        src = memoryview(buf)
        if src.ndim != 1 or src.itemsize != 1:
            src = src.cast("B")
        n = len(src)
        written = 0
        idle = 0
        cap = self.capacity
        q = self._q
        data = self._data
        _prev_wait = None
        try:
            while written < n:
                if self._disposed or self.reader_closed or (
                        self.writer_closed and not written):
                    raise OSError("shm: ring closed")
                head = q[_Q_HEAD]
                free = cap - (head - q[_Q_TAIL])
                if free == 0:
                    if idle == 0:
                        _shm_metrics()[3].add(1)  # SHM_RING_FULL_WAITS
                        # profiler wait site: backpressure from a slow
                        # reader — marked across the whole idle stretch
                        _prev_wait = mark_wait("shm_ring_spin")
                    idle += 1
                    _sleep_for(idle)
                    continue
                if idle:
                    clear_wait(_prev_wait)
                idle = 0
                chunk = min(n - written, free)
                pos = head % cap
                first = min(chunk, cap - pos)
                data[pos:pos + first] = src[written:written + first]
                if chunk > first:
                    data[:chunk - first] = \
                        src[written + first:written + chunk]
                q[_Q_HEAD] = head + chunk  # AFTER the copy: release bytes
                written += chunk
        finally:
            if idle:
                clear_wait(_prev_wait)
        return n

    # -- consumer ------------------------------------------------------------
    def read_exact(self, n: int) -> bytes:
        """Blocking read of exactly ``n`` stream bytes (the ``_read_exact``
        socket analog). ConnectionError once the writer closed and the
        stream is drained."""
        out = bytearray(n)
        got = 0
        idle = 0
        cap = self.capacity
        q = self._q
        data = self._data
        _prev_wait = None
        try:
            while got < n:
                if self._disposed or self.reader_closed:
                    raise ConnectionError("shm: ring closed")
                tail = q[_Q_TAIL]
                avail = q[_Q_HEAD] - tail
                if avail == 0:
                    if self.writer_closed:
                        raise ConnectionError("shm: peer closed")
                    if idle == 0:
                        # profiler wait site: spinning for the peer's
                        # next frame — the shm analog of net_recv
                        _prev_wait = mark_wait("shm_ring_spin")
                    idle += 1
                    _sleep_for(idle)
                    continue
                if idle:
                    clear_wait(_prev_wait)
                idle = 0
                chunk = min(n - got, avail)
                pos = tail % cap
                first = min(chunk, cap - pos)
                out[got:got + first] = data[pos:pos + first]
                if chunk > first:
                    out[got + first:got + chunk] = data[:chunk - first]
                q[_Q_TAIL] = tail + chunk  # AFTER the copy: free the space
                got += chunk
        finally:
            if idle:
                clear_wait(_prev_wait)
        return bytes(out)


class ShmChannel:
    """One negotiated connection's ring pair + the send lock. ``tx``/``rx``
    are from THIS side's perspective. The channel object doubles as the
    reply token (``msg._conn``) for frames that arrived over it, so
    ``send_via``-style reply paths address it exactly like a socket."""

    def __init__(self, tx: Ring, rx: Ring, label: str = "") -> None:
        self.tx = tx
        self.rx = rx
        self.label = label
        self.closed = False
        self._lock = threading.Lock()

    def send_segments(self, segments: List[Any], nbytes: int) -> int:
        """Write one frame's iovec segments contiguously into the stream
        (the lock keeps concurrent senders' frames from interleaving)."""
        tx_frames, tx_bytes, _rx, _wait = _shm_metrics()
        with self._lock:
            if self.closed:
                raise OSError("shm: channel closed")
            for seg in segments:
                self.tx.write(seg)
        tx_frames.add(1)
        tx_bytes.add(nbytes)
        return nbytes

    def read_exact(self, n: int) -> bytes:
        return self.rx.read_exact(n)

    def close(self) -> None:
        """Mark both directions closed so blocked peers fail fast; the
        reader thread disposes the mappings on its way out."""
        self.closed = True
        self.tx.close_writer()
        self.tx.close_reader()
        self.rx.close_reader()
        self.rx.close_writer()

    def dispose(self) -> None:
        self.close()
        self.tx.dispose()
        self.rx.dispose()


def create_pair(capacity: int) -> tuple:
    """Dialing side: create both ring files; returns (paths, channel)
    where channel.tx is the client→server ring. On any error, nothing is
    left on disk."""
    c2s_path, s2c_path = make_segment_paths()
    c2s = s2c = None
    try:
        c2s = Ring.create(c2s_path, capacity)
        s2c = Ring.create(s2c_path, capacity)
    except OSError:
        for ring, path in ((c2s, c2s_path), (s2c, s2c_path)):
            if ring is not None:
                ring.dispose()
            try:
                os.unlink(path)
            except OSError:
                pass
        raise
    return (c2s_path, s2c_path), ShmChannel(c2s, s2c, label="client")


def open_pair(c2s_path: str, s2c_path: str) -> ShmChannel:
    """Accepting side: map the offered pair; channel.tx is the
    server→client ring."""
    c2s = Ring.open(c2s_path)
    try:
        s2c = Ring.open(s2c_path)
    except OSError:
        c2s.dispose()
        raise
    return ShmChannel(s2c, c2s, label="server")


def unlink_quiet(*paths: str) -> None:
    for path in paths:
        try:
            os.unlink(path)
        except OSError:
            pass
