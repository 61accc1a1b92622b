"""Fleet integrity auditing: state digests + the continuous auditor (port
of ``multiverso_tpu/obs/audit.py``; the digests of one state are the same
32 hex characters in both packages).

The observability stack can say where time goes (trace stitching,
profiler/critpath) but not whether the fleet's STATE is correct: replicas
and standbys replay their primary's WAL and are never compared against
it, so a bad apply — bit rot, a corrupted row the wire CRC could not see
because it happened after decode, a replay bug — survives silently until
a failover serves it. This module closes that gap:

* :func:`table_digest` — an order-independent content digest over a
  table's ``(id, row-bytes)`` pairs. Order independence (a commutative
  XOR + sum fold over per-row hashes) is load-bearing twice: dict
  iteration order differs across processes, and tiered tables stream
  ``hot then cold`` while their plain twins stream insertion order. The
  fold is streamed row-at-a-time, so a tiered table digests its cold
  segments WITHOUT promoting them (``TieredStore.items`` decodes
  segment-at-a-time and never admits — the working set survives an
  audit).
* ``Control_Digest`` repliers (runtime/remote.py primaries,
  durable/standby.py replicas) call :func:`digest_payload` under their
  dispatcher seam, so the ``(digest, watermark)`` pair is exact for the
  state observed.
* :class:`FleetAuditor` (``mv.audit``) — pulls digests from every
  primary and replica, compares them at a common watermark, verifies an
  acked-Add conservation ledger (a member's watermark must never regress
  within one layout version — a regression means acknowledged records
  vanished), and on mismatch fires ``AUDIT_DIVERGENCE`` through the
  flight-recorder path with both digests and the watermark vector
  attached (docs/observability.md, docs/fault_tolerance.md).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import Dashboard, count
from multiverso_tpu_torch.obs.trace import flight_dump

_FOLD_MOD = 1 << 128


def _row_hash(key: int, row_bytes: bytes) -> int:
    h = hashlib.blake2b(struct.pack("<q", int(key)) + row_bytes,
                        digest_size=16).digest()
    return int.from_bytes(h, "little")


def _iter_rows(server) -> Any:
    """Yield ``(id, row-bytes)`` for a server table, streamed.

    Row bytes are the canonical dtype encoding — exactly what the table's
    ``store()`` writes per row — so digests interchange across backends
    of one kind: a tiered table (whose cold rows decode through the
    quantized segment codec) digests equal to a plain table loaded from
    its snapshot, because the snapshot carried those same decoded bytes.

    Kinds without a row map (dense array/matrix) fold their canonical
    ``store()`` stream as one pseudo-row under id -1: still comparable
    across processes, just not incremental. ``store()`` reads the table's
    tensors to the host in the table's numpy dtype, so the bytes are the
    JAX package's for the same state.
    """
    z = getattr(server, "_z", None)
    n = getattr(server, "_n", None)
    if isinstance(z, dict) and isinstance(n, dict):
        # FTRL: the (z, n) accumulator pair IS the row state
        for k, zv in z.items():
            yield int(k), zv.tobytes() + n[k].tobytes()
        return
    tier = getattr(server, "_tier", None)
    if tier is not None:
        dtype = getattr(server, "dtype", None) or server.value_dtype
        for k, row in tier.items():
            yield int(k), np.ascontiguousarray(row, dtype=dtype).tobytes()
        return
    store = getattr(server, "_store", None)
    if isinstance(store, dict):
        dtype = getattr(server, "dtype", None) or getattr(
            server, "value_dtype", None)
        for k, v in store.items():
            if isinstance(v, np.ndarray) and dtype is not None:
                yield int(k), np.ascontiguousarray(v,
                                                   dtype=dtype).tobytes()
            elif dtype is not None and isinstance(v, (int, float, complex,
                                                      np.generic)):
                yield int(k), np.asarray(v, dtype=dtype).tobytes()
            else:
                # host KV stores arbitrary python objects; their repr is
                # the only stable byte encoding available
                yield int(k), repr(v).encode("utf-8")
        return
    from multiverso_tpu_torch.tables.kv_table import DeviceKVServer
    if isinstance(server, DeviceKVServer):
        dtype = server.value_dtype
        for k, v in server.process_get((None, None)).items():
            yield int(k), np.asarray(v, dtype=dtype).tobytes()
        return
    from multiverso_tpu_torch import io as mv_io
    stream = mv_io.MemoryStream()
    server.store(stream)
    yield -1, stream.getvalue()


def table_digest(server) -> Dict[str, Any]:
    """Order-independent content digest of one server table:
    ``{"digest": <32 hex chars>, "rows": <count>}``. Accepts a worker
    handle or a server table."""
    server = getattr(server, "_server_table", server)
    acc_xor = 0
    acc_sum = 0
    rows = 0
    for key, row_bytes in _iter_rows(server):
        h = _row_hash(key, row_bytes)
        acc_xor ^= h
        acc_sum = (acc_sum + h) % _FOLD_MOD
        rows += 1
    final = hashlib.blake2b(
        acc_xor.to_bytes(16, "little") + acc_sum.to_bytes(16, "little")
        + struct.pack("<q", rows), digest_size=16)
    return {"digest": final.hexdigest(), "rows": rows}


def digest_payload(tables: Dict[int, Any], role: str, endpoint: str,
                   watermark: int, layout_version: int) -> Dict[str, Any]:
    """The ``Control_Reply_Digest`` payload: per-table digests plus the
    identity needed to compare them — MUST be computed under the serving
    process's dispatcher seam so ``watermark`` is exact for the state
    digested."""
    return {"role": role, "endpoint": endpoint,
            "watermark": int(watermark),
            "layout_version": int(layout_version),
            "tables": {int(tid): table_digest(table)
                       for tid, table in sorted(tables.items())}}


def _digest_tables(payload: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
    # wire codecs may stringify int keys; normalize for comparison
    return {int(tid): d for tid, d in (payload.get("tables") or {}).items()}


class FleetAuditor:
    """Continuous primary↔replica↔standby digest comparison (``mv.audit``).

    ``fleet`` is anything :func:`mv._fleet_endpoints` understands — a
    ShardGroup, a layout manifest, endpoint lists — but shard structure
    matters here: digests are compared per shard, each primary against
    its own replica fleet. A cut manifest (``mv.cut_fleet``) may ride
    along as ``manifest``; divergence flight dumps carry it so the
    operator holding the dump also holds the restore point.

    Each :meth:`check`:

    * pulls ``Control_Digest`` from the shard's primary and every
      replica (``AUDIT_UNREACHABLE`` per member that does not answer);
    * compares digests only between members at the SAME watermark — a
      replica mid-catch-up is lagging, not diverged
      (``AUDIT_SKEW_SKIPS``);
    * verifies the conservation ledger: within one layout version a
      member's watermark must never regress (acked Adds are records;
      records vanishing is loss). Migration fences bump the layout
      version, which resets the expectation — a post-cutover member
      legitimately restarts its WAL lineage;
    * on any mismatch counts ``AUDIT_DIVERGENCE`` and (edge-triggered,
      like the SLO burn alerts) fires one ``audit_divergence`` flight
      dump with both digests and the watermark vector.
    """

    def __init__(self, fleet: Any,
                 interval: Optional[float] = None,
                 timeout: Optional[float] = None,
                 manifest: Optional[Dict[str, Any]] = None,
                 probe: Optional[Callable[..., Dict[str, Any]]] = None
                 ) -> None:
        self.primaries: List[str] = [
            str(e) for e in getattr(fleet, "endpoints",
                                    fleet if isinstance(fleet, (list, tuple))
                                    else [fleet])]
        if isinstance(fleet, dict):
            self.primaries = [str(e) for e in fleet.get("endpoints", [])]
            self.replicas = [list(r) for r in fleet.get("replicas", [])]
        else:
            self.replicas = [
                [str(e) for e in fleet_eps] for fleet_eps in
                (getattr(fleet, "replica_endpoints", None) or [])]
        self.interval = float(
            interval if interval is not None
            else config.get_flag("audit_interval_seconds"))
        self.timeout = float(
            timeout if timeout is not None
            else config.get_flag("audit_timeout_seconds"))
        self.manifest = manifest
        if probe is None:
            from multiverso_tpu_torch.runtime.remote import fetch_digest
            probe = fetch_digest
        self._probe = probe
        self.last_report: Optional[Dict[str, Any]] = None
        self._divergent = False  # edge-trigger state for the flight dump
        self._divergent_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one sweep -----------------------------------------------------------
    def check(self) -> Dict[str, Any]:
        count("AUDIT_RUNS")
        divergences: List[Dict[str, Any]] = []
        unreachable: List[str] = []
        skews = 0
        shards: List[Dict[str, Any]] = []
        for k, primary_ep in enumerate(self.primaries):
            members = [("primary", primary_ep)]
            if k < len(self.replicas):
                members += [("replica", ep) for ep in self.replicas[k]]
            payloads: Dict[str, Dict[str, Any]] = {}
            for role, ep in members:
                try:
                    payloads[ep] = self._probe(ep, timeout=self.timeout)
                except (OSError, RuntimeError):
                    count("AUDIT_UNREACHABLE")
                    unreachable.append(ep)
            divergences.extend(self._ledger_check(payloads))
            primary = payloads.get(primary_ep)
            watermarks = {ep: int(p.get("watermark", -1))
                          for ep, p in payloads.items()}
            if primary is not None:
                p_wm = int(primary.get("watermark", -1))
                p_tables = _digest_tables(primary)
                for _role, ep in members[1:]:
                    replica = payloads.get(ep)
                    if replica is None:
                        continue
                    if int(replica.get("watermark", -1)) != p_wm:
                        # lag is the watermark probe's business; digests
                        # of different prefixes are incomparable
                        count("AUDIT_SKEW_SKIPS")
                        skews += 1
                        continue
                    for tid, want in p_tables.items():
                        got = _digest_tables(replica).get(tid)
                        if got is None or got["digest"] != want["digest"]:
                            divergences.append({
                                "kind": "digest_mismatch", "shard": k,
                                "table_id": tid, "watermark": p_wm,
                                "primary": {"endpoint": primary_ep, **want},
                                "replica": {"endpoint": ep,
                                            **(got or {"digest": None,
                                                       "rows": -1})}})
            shards.append({"shard": k, "watermarks": watermarks})
        report = {"divergences": divergences, "unreachable": unreachable,
                  "skews": skews, "shards": shards,
                  "ok": not divergences}
        self.last_report = report
        if divergences:
            count("AUDIT_DIVERGENCE", len(divergences))
            if not self._divergent:
                # edge-triggered like the SLO burn alerts: one dump per
                # transition into divergence, not one per sweep — the
                # condition persists until repaired and the recorder
                # must not fill with copies of the same fact
                flight_dump("audit_divergence",
                            divergences=divergences,
                            watermarks=[s["watermarks"] for s in shards],
                            manifest=self.manifest)
            if not self._divergent:
                self._divergent_since = time.time()
            self._divergent = True
            log.error("audit: %d divergence(s) across the fleet: %r",
                      len(divergences), divergences[:3])
        else:
            self._divergent = False
            self._divergent_since = None
        return report

    @property
    def divergent(self) -> bool:
        """Is the fleet currently diverged (as of the last sweep)? The
        queryable twin of the ``audit_divergence`` dump — the autopilot's
        safety interlock polls this instead of parsing the recorder."""
        return self._divergent

    def status(self) -> Dict[str, Any]:
        """Machine-readable auditor state: divergence flag + since-time,
        plus the last sweep's summary counts."""
        report = self.last_report or {}
        return {"divergent": self._divergent,
                "divergent_since": self._divergent_since,
                "divergences": len(report.get("divergences", [])),
                "unreachable": list(report.get("unreachable", [])),
                "skews": int(report.get("skews", 0)),
                "checked": self.last_report is not None}

    def _ledger_check(self, payloads: Dict[str, Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
        """Acked-Add conservation: a member's watermark regressing within
        one layout version means records it acknowledged (or applied)
        no longer exist. A layout-version bump — a migration fence —
        resets the expectation: post-cutover members legitimately start
        a fresh WAL lineage."""
        out: List[Dict[str, Any]] = []
        ledger = getattr(self, "_ledger", None)
        if ledger is None:
            ledger = self._ledger = {}
        for ep, payload in payloads.items():
            lv = int(payload.get("layout_version", -1))
            wm = int(payload.get("watermark", -1))
            prev = ledger.get(ep)
            if prev is not None and prev[0] == lv and wm < prev[1]:
                out.append({"kind": "watermark_regression", "endpoint": ep,
                            "layout_version": lv, "watermark": wm,
                            "previous": prev[1]})
            ledger[ep] = (lv, wm)
        return out

    # -- background mode -----------------------------------------------------
    def start(self) -> "FleetAuditor":
        if self.interval <= 0:
            log.fatal("FleetAuditor.start needs audit_interval_seconds > 0 "
                      "(or interval=); use check() for one-shot audits")
        if self._thread is not None:
            return self
        # a dedicated auditor process (operator box, cron job) gets the
        # "auditor" Prometheus role label so its AUDIT_* series are
        # attributable in fleet dashboards; inside a serving process the
        # existing primary/replica/standby identity wins
        if not Dashboard.identity().get("role"):
            Dashboard.set_identity(role="auditor")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mv-fleet-auditor")
        self._thread.start()
        log.info("audit: continuous auditor started (%d shard(s), every "
                 "%.1fs)", len(self.primaries), self.interval)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception as exc:  # noqa: BLE001 — an auditor that
                # dies on one bad sweep stops watching the fleet
                log.error("audit: sweep failed (%r); retrying next "
                          "interval", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
