"""Watermark-consistent fleet cuts + point-in-time recovery/cloning (port
of ``multiverso_tpu/durable/cut.py``; the cut's table files are the
checkpoint frames both packages write byte for byte, and its manifests the
same JSON, so a cut taken by either package restores in the other).

Restoring a sharded fleet from each shard's latest independent snapshot
can resurrect a state no client ever observed: shard A's snapshot may
predate an acked Add whose sibling write to shard B is included. The fix
is a marker-based consistent cut (Chandy-Lamport shaped, simplified by
the system's model — clients talk to shards, shards never talk to each
other, so there are no in-flight cross-shard messages to capture):

* The coordinator (:func:`cut_fleet`) fans a slot-free ``Control_Cut``
  over every shard primary.
* Each primary — on its pump thread, the only thread that enqueues wire
  requests — runs ONE dispatcher-serialized block
  (:func:`capture_cut`): read the ``WalWriter.seq`` fence (the drain
  guarantees every acked Add is <= it), rotate the log so segments
  before/after the cut are physically disjoint, store every table and
  its content digest into ``<wal_dir>/cut_<id>/`` — deliberately
  OUTSIDE the ``gen_<g>`` compaction lineage, so later
  ``commit_snapshot`` retirements never collect a committed cut — and
  write the shard's ``CUT.json`` (fence, dedup Add-window, digests).
* The coordinator commits the atomic **fleet manifest**
  (``<base_dir>/cuts/cut_<id>.json`` + ``LATEST.json``, tmp+rename)
  only after EVERY member answered. A shard killed mid-cut (the
  ``MV_CUT_KILL`` drill) fails the whole cut; the previous manifest
  stays the recovery point.

Point-in-time recovery (:func:`restore_fleet`) brings up a fresh
:class:`~multiverso_tpu_torch.shard.group.ShardGroup` in which every shard
loads its cut snapshot — the state at its fence, i.e. the WAL replay
truncated exactly there — and seeds its dedup window from ``CUT.json``,
so clients retrying pre-cut Adds are answered, not double-applied.
:func:`clone_fleet` bootstraps a blue/green twin of a LIVE fleet instead:
each clone shard pulls a quiesced full-state transfer over the existing
``Control_Replicate`` shape and serves it under a fresh WAL lineage.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import config, io as mv_io, log
from multiverso_tpu_torch.dashboard import count, observe
from multiverso_tpu_torch.runtime.message import Message, MsgType

CUT_META = "CUT.json"


# -- shard side ---------------------------------------------------------------

def capture_cut(remote, cut_id: str) -> Dict[str, Any]:
    """Snapshot this shard at its WAL fence (``Control_Cut`` handler
    body; ``remote`` is the serving RemoteServer). Runs everything that
    defines the cut — fence read, log rotation, table stores, digests,
    dedup capture, CUT.json commit — in ONE dispatcher-serialized block:
    no Add can land between the fence and the stores, so the snapshot IS
    the state at the fence."""
    from multiverso_tpu_torch import checkpoint
    from multiverso_tpu_torch.obs.audit import table_digest
    server = remote._zoo.server
    wal = server.wal
    t0 = time.perf_counter()
    fs = mv_io.fs_for(wal.directory)
    cut_dir = mv_io.join(wal.directory, f"cut_{cut_id}")

    def run():
        fence = int(wal.seq)
        segment = wal.rotate()  # pre-cut records live strictly below it
        fs.makedirs(cut_dir)
        digests: Dict[int, Dict[str, Any]] = {}
        table_ids: List[int] = []
        for tid, table in sorted(server._tables.items()):
            checkpoint.store_table(
                table, mv_io.join(cut_dir, f"table_{tid}.mvckpt"))
            digests[int(tid)] = table_digest(table)
            table_ids.append(int(tid))
        with remote._dedup_lock:
            dedup = [[m.req_id, m.dst, m.msg_id]
                     for m in remote._dedup.values()
                     if isinstance(m, Message)
                     and m.type == MsgType.Reply_Add]
        meta = {"cut_id": str(cut_id), "fence": fence, "segment": segment,
                "tables": table_ids, "digests": digests, "dedup": dedup}
        tmp = mv_io.join(cut_dir, CUT_META + ".tmp")
        with mv_io.get_stream(tmp, "w") as stream:
            stream.write(json.dumps(meta).encode("utf-8"))
        fs.replace(tmp, mv_io.join(cut_dir, CUT_META))
        return meta

    meta = server.run_serialized(run, timeout=None)
    count("CUT_SNAPSHOTS")
    observe("CUT_SNAPSHOT_SECONDS", time.perf_counter() - t0)
    log.info("cut: shard snapshot %s at fence %d -> %s", cut_id,
             meta["fence"], cut_dir)
    return {**meta, "cut_dir": cut_dir,
            "dedup_count": len(meta["dedup"]), "dedup": None}


# -- coordinator --------------------------------------------------------------

def _fleet_view(fleet: Any) -> Dict[str, Any]:
    """Normalize a fleet handle — ShardGroup, its ``base_dir``, or a cut
    manifest — into what the coordinator needs. Group handles resolve
    through the on-disk ``group.json`` + ``layout.json``, so a detached
    coordinator process (the chaos drills) can drive a cut knowing only
    the base directory."""
    if isinstance(fleet, dict) and "shards" in fleet:  # a cut manifest
        return {"base_dir": fleet.get("base_dir", ""),
                "endpoints": [s["endpoint"] for s in fleet["shards"]],
                "layout_version": int(fleet.get("layout_version", 1)),
                "num_shards": int(fleet["num_shards"]),
                "tables": fleet["tables"], "flags": fleet.get("flags", {}),
                "host": fleet.get("host", "127.0.0.1"),
                "wal_root": fleet.get("wal_root", "")}
    base_dir = fleet if isinstance(fleet, str) else getattr(
        fleet, "base_dir", None)
    if not base_dir:
        log.fatal("cut: cannot resolve a fleet from %r — pass a "
                  "ShardGroup, its base_dir, or a cut manifest", fleet)
    with open(os.path.join(base_dir, "group.json"), encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(base_dir, "layout.json"), encoding="utf-8") as f:
        layout = json.load(f)
    # the spans and the shard count come from the layout, not from the
    # start-time spec: a live migration republishes only layout.json, and
    # a cut restored at the start-time spans would load each shard's
    # snapshot into a table of another size (the JAX package reads the
    # spec here)
    return {"base_dir": base_dir,
            "endpoints": list(layout["endpoints"]),
            "layout_version": int(layout.get("layout_version", 1)),
            "num_shards": int(layout.get("num_shards", spec["num_shards"])),
            "tables": layout.get("tables", spec["tables"]),
            "flags": spec.get("flags", {}),
            "host": spec.get("host", "127.0.0.1"),
            "wal_root": spec.get("wal_root", "")}


def cut_fleet(fleet: Any, cut_id: Optional[str] = None,
              timeout: Optional[float] = None) -> Dict[str, Any]:
    """Take a consistent cut of a serving fleet and commit its manifest
    (``mv.cut_fleet``). Fans ``Control_Cut`` over every primary
    concurrently; commits atomically only when ALL answered — a partial
    cut is no cut (``CUT_FLEET_FAILURES``), and the previously committed
    manifest stays the fleet's recovery point.

    The ``MV_CUT_KILL`` chaos drill reads the env at cut time in THIS
    process: ``shard`` rides the cut payload and each primary SIGKILLs
    itself after its local snapshot but before replying; ``coordinator``
    SIGKILLs this process after the fan-out but before the manifest
    commit. Both leave the fleet restorable only to the previous cut —
    exactly the invariant tests/test_cut.py pins."""
    from multiverso_tpu_torch.runtime.remote import fetch_cut
    view = _fleet_view(fleet)
    if timeout is None:
        timeout = float(config.get_flag("audit_timeout_seconds"))
    if cut_id is None:
        cut_id = f"{int(time.time() * 1000):x}-{os.getpid():x}"
    kill = os.environ.get("MV_CUT_KILL", "")
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    lock = threading.Lock()

    def probe(k: int, ep: str) -> None:
        try:
            reply = fetch_cut(ep, cut_id, timeout=timeout,
                              kill=(kill if kill == "shard" else ""))
            with lock:
                results[k] = {"shard": k, "endpoint": ep, **reply}
        except (OSError, RuntimeError) as exc:
            with lock:
                errors[k] = f"{ep}: {exc}"

    threads = [threading.Thread(target=probe, args=(k, ep), daemon=True,
                                name="mv-cut-probe")
               for k, ep in enumerate(view["endpoints"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 5.0)
    if errors or len(results) != len(view["endpoints"]):
        count("CUT_FLEET_FAILURES")
        missing = [str(k) for k in range(len(view["endpoints"]))
                   if k not in results and k not in errors]
        raise RuntimeError(
            "cut_fleet: cut %s failed — the previous manifest remains the "
            "recovery point (errors: %s%s)" % (
                cut_id, "; ".join(errors.values()) or "none",
                f"; no reply from shard(s) {','.join(missing)}"
                if missing else ""))
    shards = [results[k] for k in sorted(results)]
    manifest = {"cut_id": cut_id, "committed_at": time.time(),
                "layout_version": view["layout_version"],
                "num_shards": view["num_shards"],
                "tables": view["tables"], "flags": view["flags"],
                "host": view["host"], "wal_root": view["wal_root"],
                "base_dir": view["base_dir"], "shards": shards,
                "watermarks": {s["endpoint"]: int(s["fence"])
                               for s in shards}}
    if kill == "coordinator":
        log.error("cut: MV_CUT_KILL=coordinator — dying before the "
                  "manifest commit (drill)")
        os.kill(os.getpid(), signal.SIGKILL)
    cuts_dir = os.path.join(view["base_dir"], "cuts")
    os.makedirs(cuts_dir, exist_ok=True)
    blob = json.dumps(manifest)
    for name in (f"cut_{cut_id}.json", "LATEST.json"):
        tmp = os.path.join(cuts_dir, name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(blob)
        os.replace(tmp, os.path.join(cuts_dir, name))  # atomic commit
    count("CUT_FLEET_COMMITS")
    log.info("cut: fleet manifest %s committed (%d shard(s), fences %s)",
             cut_id, len(shards), [s["fence"] for s in shards])
    return manifest


def load_cut_manifest(fleet: Any) -> Optional[Dict[str, Any]]:
    """The last COMMITTED cut manifest of a fleet (ShardGroup, base_dir,
    or a direct path to a manifest file); None when no cut ever
    committed."""
    if isinstance(fleet, str) and fleet.endswith(".json"):
        path = fleet
    else:
        base_dir = fleet if isinstance(fleet, str) else getattr(
            fleet, "base_dir", "")
        path = os.path.join(base_dir, "cuts", "LATEST.json")
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# -- point-in-time recovery / cloning ----------------------------------------

def restore_fleet(manifest: Any, base_dir: Optional[str] = None,
                  replicas: int = 0, standby: bool = False,
                  timeout: float = 240.0, device: Optional[str] = None):
    """Bring up a fresh ShardGroup restored to a committed cut
    (``mv.restore_fleet``): every shard loads its ``cut_<id>/`` snapshot
    — the state at its fence, i.e. its WAL truncated exactly there — and
    seeds its dedup window from the cut's Add ledger, so clients
    retrying pre-cut Adds get their cached ACKs instead of
    double-applying. The new group runs a fresh WAL lineage under its
    own ``base_dir`` (the source fleet's log stays untouched — a botched
    restore can always be retried). ``device`` is the new group's
    (default: the ``device`` flag)."""
    from multiverso_tpu_torch.shard.group import ShardGroup
    if isinstance(manifest, (str, type(None))) or hasattr(manifest,
                                                          "base_dir"):
        manifest = load_cut_manifest(manifest)
    if not manifest:
        log.fatal("restore_fleet: no committed cut manifest to restore "
                  "from")
    group = ShardGroup(manifest["tables"],
                       shards=int(manifest["num_shards"]),
                       base_dir=base_dir, durable=True, replicas=replicas,
                       standby=standby, flags=manifest.get("flags"),
                       host=manifest.get("host", "127.0.0.1"),
                       preplanned=True, device=device)
    for s in manifest["shards"]:
        group._primary_extra[int(s["shard"])] = ["--restore-cut",
                                                 s["cut_dir"]]
    group.start(timeout=timeout)
    log.info("restore: fleet restored to cut %s at %s",
             manifest["cut_id"], group.endpoints)
    return group


def clone_fleet(source: Any, base_dir: Optional[str] = None,
                replicas: int = 0, timeout: float = 240.0,
                device: Optional[str] = None):
    """Bootstrap a blue/green twin of a LIVE fleet (``mv.clone_fleet``):
    each clone shard pulls a quiesced full-state transfer from its
    source primary over the existing ``Control_Replicate`` shape —
    tables, dedup Add-window and watermark in one dispatcher-serialized
    reply — then serves it under a fresh WAL lineage. ``source`` is a
    ShardGroup, its base_dir, or a cut manifest (whose per-shard
    endpoints name the donors). ``device`` is the clone group's
    (default: the ``device`` flag)."""
    from multiverso_tpu_torch.shard.group import ShardGroup
    view = _fleet_view(source)
    group = ShardGroup(view["tables"], shards=view["num_shards"],
                       base_dir=base_dir, durable=True, replicas=replicas,
                       flags=view["flags"], host=view["host"],
                       preplanned=True, device=device)
    for k, ep in enumerate(view["endpoints"]):
        group._primary_extra[k] = ["--clone-primary", ep]
    group.start(timeout=timeout)
    log.info("clone: fleet cloned from %s at %s", view["endpoints"],
             group.endpoints)
    return group
