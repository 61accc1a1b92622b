"""Cold-tier segment store: CRC-framed, quantized, atomically-committed
row spill for tiered tables (port of ``multiverso_tpu/store/coldstore.py``;
the JAX package's ``docs/tiered_storage.md``). Host-only; the segment
files are byte-identical to the JAX package's.

One demotion batch becomes ONE segment file, in the JAX package's WAL
framing (``durable/wal.py`` there)::

    segment = hdr | u32 crc32(body) | u32 body_len | body
    hdr     = "MVCS" | u8 version | i32 table_id | i64 segment
    body    = i64 count | i32 width | u8 mode | u8 dtype_len | dtype_str
              | i64 keys[count] | payload

``mode`` selects the payload codec: QUANT rides the 1/2/4/8-bit
quantization codec (utils/quantization.py, the Seide et al. 2014 packing
the wire already uses) over the concatenated float32 rows; RAW is the
verbatim ``tobytes()`` image, used when ``bits == 0``, when the table
dtype is not float32, or when a batch contains non-finite values (the
min/max grid cannot represent them). Quantized cold rows are **lossy**
(error ≤ step/2 per element); lossless tiering is ``tier_cold_bits=0``.

Why lossy is safe: the cold store is a per-incarnation **spill**, not a
durability layer. Authoritative state is the snapshot (and, in the JAX
package, the WAL, which the port has not yet); on restart the store
wipes any leftover segments and recovery re-demotes whatever no longer
fits. A torn or bit-flipped segment
is therefore detected by the CRC and surfaced loudly — it cannot be
"repaired" from anywhere but a restart.

Commit discipline mirrors the WAL's manifest: segment written to a tmp
name, flushed, synced, renamed into place, THEN the JSON manifest is
tmp+renamed — and only after that does the caller drop the hot copies
(write-ahead demotion). The ``MV_TIER_KILL`` chaos hook SIGKILLs the
process at either side of the commit point so CI can prove the drill:
kill -9 mid-demotion → restart → recover → zero acknowledged Adds lost.
"""

from __future__ import annotations

import json
import os
import re
import signal
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import log
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch.obs.profiler import wait_site
from multiverso_tpu_torch.utils.quantization import (_QBITS, quant_codes,
                                               quant_decode, quant_encode)

_SEG_MAGIC = b"MVCS"
_SEG_VERSION = 1
_SEG_HDR = struct.Struct("<4sBiq")   # magic, version, table_id, segment
_REC_HDR = struct.Struct("<II")      # crc32(body), body length
_BODY_HDR = struct.Struct("<qiBB")   # count, width, mode, dtype_len
_SEG_NAME = re.compile(r"^cseg(\d{8})\.t(-?\d+)\.mvcold$")
_MANIFEST = "TIER_MANIFEST"

MODE_RAW = 0
MODE_QUANT = 1


class ColdStore:
    """On-disk cold tier: fixed-width rows keyed by int64, batched into
    immutable segments. Not thread-safe by itself — every caller runs on
    the dispatcher (TieredStore's contract)."""

    def __init__(self, directory: str, width: int, dtype,
                 bits: int, table_id: int = -1) -> None:
        bits = int(bits)
        if bits not in (0,) + _QBITS:
            log.fatal("tier_cold_bits must be one of %s or 0 (raw), got %d",
                      _QBITS, bits)
        self.directory = directory
        self.width = int(width)
        self.dtype = np.dtype(dtype)
        self.bits = bits
        self.table_id = int(table_id)
        self._fs = mv_io.fs_for(directory)
        self._fs.makedirs(directory)
        self._index: Dict[int, int] = {}        # key -> segment id
        self._live: Dict[int, int] = {}         # segment -> live row count
        self._seg_bytes: Dict[int, int] = {}    # segment -> file bytes
        self._next_segment = 0
        self._total_bytes = 0
        # one-segment decode cache: Zipf traffic revisits the same cold
        # segment in bursts, and the fetch cost is per-segment anyway
        self._cache_seg = -1
        self._cache_rows: Dict[int, np.ndarray] = {}
        self._wipe()

    # -- lifecycle -----------------------------------------------------------
    def _wipe(self) -> None:
        """Drop every segment from a previous incarnation: the cold store
        is disposable spill — a snapshot restore rebuilds the table and
        re-demotes, so stale segments are garbage, never inputs."""
        for name in self._fs.listdir(self.directory):
            if _SEG_NAME.match(name) or name in (_MANIFEST, _MANIFEST + ".tmp"):
                try:
                    self._fs.remove(mv_io.join(self.directory, name))
                except OSError:
                    log.error("cold store: could not remove stale %s", name)

    def close(self) -> None:
        self._wipe()
        self._index.clear()
        self._live.clear()
        self._seg_bytes.clear()
        self._total_bytes = 0
        self._cache_seg = -1
        self._cache_rows = {}

    clear = close

    # -- write path (demotion) ----------------------------------------------
    def _seg_path(self, segment: int) -> str:
        return mv_io.join(self.directory,
                          f"cseg{segment:08d}.t{self.table_id}.mvcold")

    def _encode_batch(self, keys: np.ndarray, rows: np.ndarray) -> bytes:
        mode = MODE_QUANT
        if (self.bits == 0 or self.dtype != np.float32
                or not np.all(np.isfinite(rows))):
            mode = MODE_RAW
        if mode == MODE_QUANT:
            payload = quant_encode(rows.reshape(-1), self.bits)
        else:
            payload = rows.tobytes()
        dtype_str = self.dtype.str.encode("ascii")
        return (_BODY_HDR.pack(len(keys), self.width, mode, len(dtype_str))
                + dtype_str + keys.tobytes() + payload)

    def write_batch(self, keys: np.ndarray, rows: np.ndarray) -> int:
        """Persist one demotion batch as a fresh segment and commit it to
        the manifest. Returns the segment id. The caller drops its hot
        copies only AFTER this returns (write-ahead demotion)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64).reshape(-1)
        rows = np.ascontiguousarray(rows, dtype=self.dtype)
        rows = rows.reshape(len(keys), self.width)
        body = self._encode_batch(keys, rows)
        segment = self._next_segment
        self._next_segment += 1
        path = self._seg_path(segment)
        tmp = path + ".tmp"
        with mv_io.get_stream(tmp, "w") as stream:
            stream.write(_SEG_HDR.pack(_SEG_MAGIC, _SEG_VERSION,
                                       self.table_id, segment))
            stream.write(_REC_HDR.pack(zlib.crc32(body), len(body)))
            stream.write(body)
            stream.flush()
            stream.sync()
        kill = os.environ.get("MV_TIER_KILL", "")
        if kill == "before_commit":
            os.kill(os.getpid(), signal.SIGKILL)
        self._fs.replace(tmp, path)
        # a key demoted again from a fresher hot copy supersedes its old
        # cold slot — release the stale segment references first
        for k in keys.tolist():
            old = self._index.pop(k, None)
            if old is not None:
                self._release(old)
        size = _SEG_HDR.size + _REC_HDR.size + len(body)
        for k in keys.tolist():
            self._index[k] = segment
        self._live[segment] = len(keys)
        self._seg_bytes[segment] = size
        self._total_bytes += size
        self._commit_manifest()
        if kill == "after_commit":
            os.kill(os.getpid(), signal.SIGKILL)
        return segment

    def _commit_manifest(self) -> None:
        doc = {"version": _SEG_VERSION, "table_id": self.table_id,
               "next_segment": self._next_segment, "bits": self.bits,
               "segments": sorted(self._live)}
        path = mv_io.join(self.directory, _MANIFEST)
        tmp = path + ".tmp"
        with mv_io.get_stream(tmp, "w") as stream:
            stream.write(json.dumps(doc).encode("utf-8"))
            stream.flush()
            stream.sync()
        self._fs.replace(tmp, path)

    def _release(self, segment: int) -> None:
        """One row of ``segment`` stopped being live (promoted or
        superseded); delete the file once nothing references it."""
        remaining = self._live.get(segment, 0) - 1
        if remaining > 0:
            self._live[segment] = remaining
            return
        self._live.pop(segment, None)
        self._total_bytes -= self._seg_bytes.pop(segment, 0)
        if self._cache_seg == segment:
            self._cache_seg = -1
            self._cache_rows = {}
        try:
            self._fs.remove(self._seg_path(segment))
        except OSError:
            log.error("cold store: could not remove dead segment %d",
                        segment)

    # -- read path -----------------------------------------------------------
    def _segment_body(self, segment: int):
        """Validate + parse one segment file down to its payload:
        ``(count, width, mode, dtype, keys, body, payload_offset)``."""
        path = self._seg_path(segment)
        with mv_io.get_stream(path, "r") as stream:
            data = stream.read()
        if len(data) < _SEG_HDR.size + _REC_HDR.size:
            log.fatal("cold segment %s truncated (%d bytes)", path, len(data))
        magic, version, table_id, seg = _SEG_HDR.unpack_from(data, 0)
        if magic != _SEG_MAGIC or version != _SEG_VERSION or seg != segment:
            log.fatal("cold segment %s: bad header (magic=%r seg=%d)",
                      path, magic, seg)
        crc, body_len = _REC_HDR.unpack_from(data, _SEG_HDR.size)
        body = data[_SEG_HDR.size + _REC_HDR.size:
                    _SEG_HDR.size + _REC_HDR.size + body_len]
        if len(body) != body_len or zlib.crc32(body) != crc:
            log.fatal("cold segment %s: CRC mismatch — spill corrupted; "
                      "restart to rebuild from the snapshot", path)
        count, width, mode, dtype_len = _BODY_HDR.unpack_from(body, 0)
        off = _BODY_HDR.size
        dtype = np.dtype(body[off:off + dtype_len].decode("ascii"))
        off += dtype_len
        keys = np.frombuffer(body, np.int64, count, off)
        off += count * 8
        return count, width, mode, dtype, keys, body, off

    def _read_segment(self, segment: int) -> Dict[int, np.ndarray]:
        count, width, mode, dtype, keys, body, off = \
            self._segment_body(segment)
        if mode == MODE_QUANT:
            rows = quant_decode(body[off:], count * width)
        else:
            rows = np.frombuffer(body[off:], dtype, count * width)
        rows = rows.reshape(count, width)
        return {int(k): rows[i] for i, k in enumerate(keys)}

    def scan_segments(self):
        """Read-only batch scan for the query plane
        (``query/``): yields one block per segment —
        ``(keys int64 (n,), rows float32 (n, width) | None, quant)``
        where ``quant`` is ``(lo, step, bits, codes float32 (n, width))``
        for quantized segments (raw integer codes, NOT dequantized — the
        caller scores in the compressed domain) and None otherwise.
        Only LIVE rows of each segment are yielded (a key superseded by
        a fresher demotion stays in the old file but not the index).
        Never touches the fetch cache or the index — the same
        no-promotion cold iteration :meth:`items` provides, batched."""
        by_segment: Dict[int, List[int]] = {}
        for key, segment in self._index.items():
            by_segment.setdefault(segment, []).append(key)
        for segment in sorted(by_segment):
            seg_keys = by_segment[segment]
            count, width, mode, dtype, keys, body, off = \
                self._segment_body(segment)
            pos = {int(k): i for i, k in enumerate(keys)}
            live_idx = np.asarray([pos[k] for k in seg_keys], np.int64)
            live = np.asarray(seg_keys, dtype=np.int64)
            if mode == MODE_QUANT:
                codes, lo, step, bits = quant_codes(body[off:],
                                                    count * width)
                codes = codes.reshape(count, width)[live_idx]
                yield live, None, (lo, step, bits, codes)
            else:
                rows = np.frombuffer(body[off:], dtype, count * width)
                rows = rows.reshape(count, width)[live_idx]
                yield live, rows.astype(np.float32, copy=False), None

    def fetch(self, key: int) -> Optional[np.ndarray]:
        """Decode the row for ``key``, or None when it is not cold. The
        returned array is a fresh copy (hot-tier mutation must not write
        through into the decode cache)."""
        segment = self._index.get(key)
        if segment is None:
            return None
        if segment != self._cache_seg:
            with wait_site("tier_cold_fetch"):
                self._cache_rows = self._read_segment(segment)
                self._cache_seg = segment
        return self._cache_rows[key].astype(self.dtype, copy=True)

    def remove(self, key: int) -> None:
        """Forget ``key`` (promoted back hot, or deleted)."""
        segment = self._index.pop(key, None)
        if segment is not None:
            self._release(segment)

    def items(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Iterate every cold (key, row) — snapshot/get-all path; decodes
        segment-at-a-time without disturbing the fetch cache."""
        by_segment: Dict[int, List[int]] = {}
        for key, segment in self._index.items():
            by_segment.setdefault(segment, []).append(key)
        for segment, seg_keys in by_segment.items():
            rows = self._read_segment(segment)
            for key in seg_keys:
                yield key, rows[key].astype(self.dtype, copy=True)

    def keys(self):
        return self._index.keys()

    def __contains__(self, key: int) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    @property
    def total_bytes(self) -> int:
        return self._total_bytes

    @property
    def segment_count(self) -> int:
        return len(self._live)
