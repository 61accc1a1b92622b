"""Hot/cold tiered row store: the beyond-RAM backend for sparse/KV
tables (port of ``multiverso_tpu/store/tiered.py``; the JAX package's
``docs/tiered_storage.md``). Host-only, as in the JAX package.

The hot tier is the same ``Dict[int, np.ndarray]`` the in-RAM servers
use; what this layer adds is a byte budget (``tier_resident_bytes``),
an on-disk cold tier (store/coldstore.py) for the tail, and the policy
that moves rows between them:

* **Demotion** — when the hot tier exceeds its budget, the oldest rows
  by last-access tick (exact LRU over a per-key logical clock) are
  written to cold segments in bounded batches and dropped. Write-ahead:
  a row leaves RAM only after its segment and the manifest are on disk.
  Runs as a ``@dispatcher_only`` maintenance step after the triggering
  Add has applied, so demotion never reorders against the Adds.
* **Promotion** — a cold row touched by a Get is admitted back into the
  hot tier only when a TinyLFU-style frequency sketch has seen it
  ``tier_admit_touches`` times (second-chance admission): a one-shot
  full-table scan leaves the Zipf-hot working set resident instead of
  thrashing it. Adds (read-modify-write) always promote — the updated
  row is the freshest state and must live in the authoritative tier.

Telemetry: ``TIER_HOT_HITS`` / ``TIER_COLD_HITS`` / ``TIER_PROMOTIONS``
/ ``TIER_DEMOTIONS`` counters and ``TIER_RESIDENT_BYTES`` /
``TIER_COLD_BYTES`` gauges; cold fetch time parks at the
``tier_cold_fetch`` wait site (``obs/profiler.py``).
"""

from __future__ import annotations

import tempfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count, gauge_set
from multiverso_tpu_torch.runtime.contracts import dispatcher_only
from multiverso_tpu_torch.store.coldstore import ColdStore

#: Rows per demotion segment: bounds both the stall one maintenance step
#: can add to the dispatcher and the decode cost of a later cold fetch
#: (a fetch always decodes a whole segment).
DEMOTE_BATCH_ROWS = 2048

_MASK64 = (1 << 64) - 1

#: Per-process ordinal for tier spill directories: deterministic across
#: restarts (tables are re-created in the same order), so a fresh
#: incarnation lands on — and wipes — its predecessor's directory.
_TIER_SEQ = [0]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class FrequencySketch:
    """TinyLFU-flavored admission filter: two rows of 4-bit saturating
    counters under independent hash mixes, halved periodically so
    popularity decays (an aged one-shot scan cannot pollute admission
    forever). ``estimate`` is the min over the rows — an upper bound on
    the true touch count with one-sided error."""

    def __init__(self, size: int = 1 << 14) -> None:
        n = _next_pow2(max(1024, int(size)))
        self._mask = n - 1
        self._rows = np.zeros((2, n), np.uint8)
        self._touches = 0
        self._age_every = 8 * n

    def _slots(self, key: int) -> Tuple[int, int]:
        # splitmix64 finalizer: cheap, well-distributed 64-bit mix
        h = (key * 0x9E3779B97F4A7C15) & _MASK64
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
        return h & self._mask, (h >> 32) & self._mask

    def touch(self, key: int) -> None:
        self._touches += 1
        if self._touches >= self._age_every:
            self._rows >>= 1
            self._touches = 0
        s0, s1 = self._slots(int(key))
        row0, row1 = self._rows
        if row0[s0] < 15:
            row0[s0] += 1
        if row1[s1] < 15:
            row1[s1] += 1

    def estimate(self, key: int) -> int:
        s0, s1 = self._slots(int(key))
        return int(min(self._rows[0][s0], self._rows[1][s1]))


def _tier_directory(explicit: Optional[str]) -> str:
    """Resolve this store's spill directory. With ``tier_dir`` set the
    directory is deterministic (``tier<ordinal>`` under the flag root,
    one root per process like ``wal_dir``) so a restarted process reuses
    and wipes its predecessor's spill; otherwise an unguessable tempdir."""
    if explicit:
        return explicit
    root = str(config.get_flag("tier_dir"))
    ordinal = _TIER_SEQ[0]
    _TIER_SEQ[0] += 1
    if root:
        import os
        path = os.path.join(root, f"tier{ordinal}")
        return path
    return tempfile.mkdtemp(prefix=f"mvtier{ordinal}_")


class TieredStore:
    """Row store with a RAM-resident hot tier and a disk cold tier.

    Single-writer by contract: every mutation happens on the serving
    dispatcher (the same discipline as the tables themselves), so there
    is no locking here. Reads that promote are mutations too — which is
    exactly why tiered tables keep routing Gets through the dispatcher.
    """

    def __init__(self, width: int, dtype, table_id: int = -1,
                 resident_bytes: Optional[int] = None,
                 cold_bits: Optional[int] = None,
                 directory: Optional[str] = None,
                 admit_touches: Optional[int] = None) -> None:
        if resident_bytes is None:
            resident_bytes = int(config.get_flag("tier_resident_bytes"))
        if cold_bits is None:
            cold_bits = int(config.get_flag("tier_cold_bits"))
        self._flag_unsub = None
        if admit_touches is None:
            admit_touches = int(config.get_flag("tier_admit_touches"))
            # flag-derived admission bar stays LIVE (watch seam): the JAX
            # package's autotuner lowers it when tier_cold_fetch wait
            # dominates. An explicit constructor value stays pinned.
            self._flag_unsub = config.FLAGS.on_change(
                "tier_admit_touches", self._on_admit_change)
        self.width = int(width)
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.width * self.dtype.itemsize
        self.budget = int(resident_bytes)
        if self.budget < self.row_bytes:
            log.fatal("tier_resident_bytes=%d cannot hold one %d-byte row",
                      self.budget, self.row_bytes)
        self.admit = max(1, int(admit_touches))
        # Get-path promotions enforce the budget with hysteresis: demote
        # only once resident exceeds budget+slack, so read-heavy churn
        # writes a few well-filled segments instead of one per promotion
        # (the Add path stays strict via maybe_maintain)
        self._promote_slack = max(self.row_bytes * 64, self.budget // 8)
        self._hot: Dict[int, np.ndarray] = {}
        self._tick: Dict[int, int] = {}
        self._clock = 0
        # TinyLFU sizing: counters must outnumber the items whose
        # popularity they track, i.e. the hot-tier capacity — an
        # undersized sketch collides hot keys onto shared counters and
        # admits every one-hit tail key
        self._sketch = FrequencySketch(
            size=4 * max(1024, self.budget // self.row_bytes))
        self._cold = ColdStore(_tier_directory(directory), self.width,
                               self.dtype, cold_bits, table_id)

    def _on_admit_change(self, _name: str, value) -> None:
        self.admit = max(1, int(value))

    # -- accounting ----------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        """Hot-tier payload bytes (row data only; dict/tick overhead is
        bounded per row and excluded so the budget maps to table size)."""
        return len(self._hot) * self.row_bytes

    @property
    def cold_bytes(self) -> int:
        return self._cold.total_bytes

    @property
    def hot_rows(self) -> int:
        return len(self._hot)

    @property
    def cold_rows(self) -> int:
        return len(self._cold)

    def __len__(self) -> int:
        return len(self._hot) + len(self._cold)

    def __contains__(self, key: int) -> bool:
        return key in self._hot or key in self._cold

    def stats(self) -> Dict[str, int]:
        return {"hot_rows": self.hot_rows, "cold_rows": self.cold_rows,
                "resident_bytes": self.resident_bytes,
                "cold_bytes": self.cold_bytes,
                "cold_segments": self._cold.segment_count}

    def _touch(self, key: int) -> None:
        self._clock += 1
        self._tick[key] = self._clock

    # -- serving -------------------------------------------------------------
    def get(self, key: int) -> Optional[np.ndarray]:
        """Serving read. Hot rows are returned in place; cold rows decode
        through the segment cache and are promoted only once the sketch
        has seen the key ``admit`` times."""
        row = self._hot.get(key)
        if row is not None:
            count("TIER_HOT_HITS")
            self._touch(key)
            return row
        row = self._cold.fetch(key)
        if row is None:
            return None
        # sketch only keys that exist cold: misses (insert probes, absent
        # reads) carry no admission signal, and counting them saturates
        # the sketch during bulk load, admitting every one-hit tail key
        self._sketch.touch(key)
        count("TIER_COLD_HITS")
        if self._sketch.estimate(key) >= self.admit:
            self._promote(key, row)
        return row

    def get_for_update(self, key: int) -> Optional[np.ndarray]:
        """Read-modify-write read (the Add path): always promotes, so the
        caller's in-place mutation lands in the hot tier."""
        row = self._hot.get(key)
        if row is not None:
            count("TIER_HOT_HITS")
            self._touch(key)
            return row
        row = self._cold.fetch(key)
        if row is None:
            return None
        self._sketch.touch(key)
        count("TIER_COLD_HITS")
        self._promote(key, row)
        return row

    def _promote(self, key: int, row: np.ndarray) -> None:
        self._cold.remove(key)
        self._hot[key] = row
        self._touch(key)
        count("TIER_PROMOTIONS")
        if self.resident_bytes > self.budget + self._promote_slack:
            self.maintain()

    def put(self, key: int, row: np.ndarray) -> None:
        """Insert or overwrite a row (lands hot; any cold copy is stale)."""
        if key not in self._hot:
            self._cold.remove(key)
        self._hot[key] = row
        self._touch(key)

    def items(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Every (key, row), hot then cold — the snapshot/get-all path.
        No tier churn: iteration must not evict the working set."""
        yield from self._hot.items()
        yield from self._cold.items()

    def scan_blocks(self):
        """Batch scan for the query plane: the hot tier as ONE
        ``(keys, rows, None)`` block, then one block per cold segment
        from :meth:`ColdStore.scan_segments` (quantized segments arrive
        as raw codes for compressed-domain scoring). No tier churn at
        all — no sketch touches, no promotions, no fetch-cache writes —
        so a scan leaves the hit-rate exactly where it found it."""
        if self._hot:
            keys = np.fromiter(self._hot.keys(), np.int64, len(self._hot))
            keys.sort()
            rows = np.stack([self._hot[k] for k in keys.tolist()])
            yield keys, rows.astype(np.float32, copy=False), None
        yield from self._cold.scan_segments()

    # -- maintenance ---------------------------------------------------------
    def maybe_maintain(self) -> int:
        """Cheap budget probe for the hot mutation path."""
        if self.resident_bytes > self.budget:
            return self.maintain()
        return 0

    @dispatcher_only
    def maintain(self) -> int:
        """Demote least-recently-used rows until the hot tier fits the
        budget. Victims are persisted segment-by-segment and dropped only
        after each segment commits (a SIGKILL mid-step — the MV_TIER_KILL
        drill — loses nothing: hot copies still exist for any uncommitted
        batch)."""
        over = self.resident_bytes - self.budget
        rows_over = -(-over // self.row_bytes) if over > 0 else 0
        rows_over = min(rows_over, len(self._hot))
        if rows_over <= 0:
            self.refresh_gauges()
            return 0
        # two passes over an unmutated dict iterate in the same order
        keys_arr = np.fromiter(self._hot.keys(), np.int64, len(self._hot))
        ticks = np.fromiter((self._tick.get(k, 0) for k in self._hot.keys()),
                            np.int64, len(self._hot))
        if rows_over < len(keys_arr):
            idx = np.argpartition(ticks, rows_over - 1)[:rows_over]
        else:
            idx = np.arange(len(keys_arr))
        victims = keys_arr[idx[np.argsort(ticks[idx], kind="stable")]]
        demoted = 0
        for start in range(0, len(victims), DEMOTE_BATCH_ROWS):
            chunk = victims[start:start + DEMOTE_BATCH_ROWS]
            rows = np.stack([self._hot[k] for k in chunk.tolist()])
            self._cold.write_batch(chunk, rows)   # durable first...
            for k in chunk.tolist():              # ...then drop
                del self._hot[k]
                self._tick.pop(k, None)
            count("TIER_DEMOTIONS", len(chunk))
            demoted += len(chunk)
        self.refresh_gauges()
        return demoted

    def refresh_gauges(self) -> None:
        gauge_set("TIER_RESIDENT_BYTES", self.resident_bytes)
        gauge_set("TIER_COLD_BYTES", self.cold_bytes)

    # -- lifecycle -----------------------------------------------------------
    def clear(self) -> None:
        """Drop every row, both tiers (snapshot load repopulates)."""
        self._hot.clear()
        self._tick.clear()
        self._clock = 0
        self._cold.clear()

    def close(self) -> None:
        if self._flag_unsub is not None:
            self._flag_unsub()
            self._flag_unsub = None
        self._hot.clear()
        self._tick.clear()
        self._cold.close()
