"""One shard of a ShardGroup — the per-process serving entrypoint (port of
``multiverso_tpu/shard/_child.py``).

Runs as ``python -m multiverso_tpu_torch.shard._child --spec <group.json>
--shard <k>``: reads the group spec, builds this shard's LOCAL slice of
every table (range kinds at span size, with ids translated by the
router; hash kinds at global key space), serves it over TCP, and
announces the bound endpoint via ``<base_dir>/shard<k>.endpoint``.

``--standby --primary <endpoint>`` instead runs the shard's warm standby
(:mod:`multiverso_tpu_torch.durable.standby`): replicate the primary, take over
its endpoint on lease expiry, announce via ``standby<k>.tookover``.

``--replica <i> --primary <endpoint>`` runs serving read replica ``i``
of the shard (a WarmStandby promoted with ``serve_reads()``): tail the
WAL, answer slot-free watermark-stamped Gets, announce the read endpoint
via ``replica<k>.<i>.endpoint``. With ``--takeover`` the replica also
holds the failover role (replica 0 when the group runs no dedicated
standby) and announces a takeover via ``standby<k>.tookover``.

``--recover`` replays this shard's WAL before serving — the per-shard
restart-recovery path (docs/fault_tolerance.md §7, per shard).

``--restore-cut <cut_dir>`` loads this shard's slice of a committed
consistent cut (durable/cut.py) before serving: every table restored to
the state at the cut's WAL fence, and the dedup window seeded from the
cut's acked-Add ledger so clients retrying pre-cut Adds are answered,
not double-applied. The point-in-time-recovery bring-up vehicle
(``mv.restore_fleet``).

``--clone-primary <endpoint>`` bootstraps this shard from a LIVE donor
primary instead: one quiesced ``Control_Replicate`` transfer (tables +
dedup window + watermark — the same shape a warm standby absorbs), then
serve under a fresh WAL lineage. The blue/green bring-up vehicle
(``mv.clone_fleet``).

A replica child honors the ``MV_AUDIT_CORRUPT=<table>:<row>[:<after>]``
chaos env: once synced and past ``after`` applied records it flips one
byte of that row IN its applied state — the seeded divergence the fleet
auditor (obs/audit.py) must catch — and flips it again after any later
state transfer (a resubscribe would otherwise heal it). Wire-level
corruption cannot stage this drill: the frame CRC discards a corrupted
record before apply.

``--join <spec.json>`` runs a live-migration JOINER (shard/reshard.py):
build this member's tables at their NEW-layout spans, absorb a quiesced
range transfer from each donor and tail its WAL (durable/migrate.py),
report catch-up through a status file, then — once the coordinator's
cutover file names the per-donor watermarks — drain to them, start
serving on the pre-assigned port, and announce through a serving file.
The joiner never serves a single request before every acknowledged donor
record at or below the cutover watermark has been applied.

Every role inits its runtime on the group's ``device`` (the spec's, or
the join spec's): ``cuda`` puts the tables on the card, where row Adds
(live, replayed, translated from a donor) run the scatter kernel and row
Gets the gather kernel; asked for ``cuda`` without one, ``init`` raises.
On SIGTERM the child writes ``<role>.launches.json`` beside its endpoint
file — its process's row-kernel launch counts — and exits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _write_atomic(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(content)
    os.replace(tmp, path)


def _record_launches_on_stop(path: str, device: str) -> None:
    """SIGTERM (the group's stop): write this process's row-kernel launch
    counts to ``path`` and exit at once. The counts are the wrappers' own
    (``ops/rows.py``): one per kernel launch, none on the CPU path."""
    import signal
    from multiverso_tpu_torch.ops import rows

    def stop(signum, frame):  # noqa: ARG001 — signal handler signature
        counts = {"scatter_add_rows": int(rows.scatter_add_rows.launches),
                  "gather_rows": int(rows.gather_rows.launches),
                  "scatter_add_rows_coalesced":
                      int(rows.scatter_add_rows_coalesced.launches),
                  "device": device}
        try:
            _write_atomic(path, json.dumps(counts))
        finally:
            os._exit(0)

    signal.signal(signal.SIGTERM, stop)


def _build_tables(mv, spec, shard: int):
    """Create this shard's local tables in layout order (table ids must
    match the manifest's on every shard)."""
    from multiverso_tpu_torch.shard.partition import shard_table_kwargs
    from multiverso_tpu_torch.tables.sparse_table import SparseWorker
    workers = []
    for entry in spec["tables"]:
        kwargs, offset = shard_table_kwargs(entry, shard)
        kind = entry["kind"]
        if kind == "sparse":
            worker = SparseWorker(**kwargs)
        else:
            worker = mv.create_table(kind, **kwargs)
        worker._server_table.row_offset = offset
        if int(worker.table_id) != int(entry["table_id"]):
            mv.log.fatal("shard %d: table id %d != layout id %d",
                         shard, worker.table_id, entry["table_id"])
        workers.append(worker)
    return workers


def _restore_from_cut(tables, cut_dir: str) -> None:
    """Point-in-time recovery (durable/cut.py): load every table's
    ``cut_<id>/`` snapshot — the state at the cut's WAL fence — and seed
    the dedup window from the cut's acked-Add ledger, all BEFORE
    ``serve()``. A client retrying a pre-cut Add against the restored
    fleet gets its cached ACK, never a second apply."""
    from multiverso_tpu_torch import checkpoint, io as mv_io, log
    from multiverso_tpu_torch.durable.cut import CUT_META
    from multiverso_tpu_torch.runtime.zoo import Zoo
    with mv_io.get_stream(mv_io.join(cut_dir, CUT_META), "r") as stream:
        meta = json.loads(bytes(stream.read()).decode("utf-8"))
    restored = checkpoint.restore_tables(tables, cut_dir)
    Zoo.instance()._dedup_seeds = [tuple(int(x) for x in entry)
                                   for entry in meta.get("dedup", [])]
    log.info("restore-cut: %d table(s) at fence %d from %s (%d dedup "
             "seed(s))", restored, int(meta.get("fence", -1)), cut_dir,
             len(meta.get("dedup", [])))


def _clone_from_primary(tables, donor: str) -> None:
    """Blue/green clone (durable/cut.py): absorb ONE quiesced
    Control_Replicate transfer from a live donor primary — tables, dedup
    Add-window, watermark, the exact shape a warm standby loads — then
    fall through to serve() under this shard's own fresh WAL lineage.
    The probe connection closes after the transfer; the donor drops the
    dead subscriber on its next WAL send, so the clone never tails."""
    import numpy as np
    from multiverso_tpu_torch import config, io as mv_io, log
    from multiverso_tpu_torch.runtime.message import MsgType
    from multiverso_tpu_torch.runtime.remote import control_probe
    from multiverso_tpu_torch.runtime.zoo import Zoo
    payload = control_probe(
        donor, MsgType.Control_Replicate, MsgType.Control_Reply_Replicate,
        timeout=float(config.get_flag("audit_timeout_seconds")),
        what="clone")
    by_id = {int(w.table_id): getattr(w, "_server_table", w)
             for w in tables}
    server = Zoo.instance().server

    def run():
        for table_id, blob in payload.get("tables", {}).items():
            server_table = by_id.get(int(table_id))
            if server_table is None:
                log.fatal("clone: donor transfer names unknown table %s — "
                          "clone with the donor group's layout", table_id)
            data = bytes(np.ascontiguousarray(
                np.asarray(blob, dtype=np.uint8)))
            server_table.load(mv_io.MemoryStream(data))

    if server is not None and hasattr(server, "run_serialized"):
        server.run_serialized(run)
    else:
        run()
    Zoo.instance()._dedup_seeds = [tuple(int(x) for x in entry)
                                   for entry in payload.get("dedup", [])]
    log.info("clone: absorbed %d table(s) from %s at watermark %d",
             len(payload.get("tables", {})), donor,
             int(payload.get("watermark", -1)))


def _arm_audit_corruption(standby, spec: str) -> None:
    """MV_AUDIT_CORRUPT=<table>:<row>[:<after>] — the seeded-divergence
    chaos drill: once this replica is synced and has applied ``after``
    records (default 1), flip one byte of the named row IN its applied
    state, under the replay-serialized seam. The fleet auditor must
    catch the divergence within one audit interval. A fresh state
    transfer (the resubscribe after a lease stall or a replication gap)
    loads the primary's bytes over the flip, so the drill re-plants it
    inside the same serialized block (``WarmStandby.after_transfer``):
    no digest can read the healed state in between."""
    import threading
    from multiverso_tpu_torch import log
    from multiverso_tpu_torch.fault.inject import corrupt_table_row
    parts = spec.split(":")
    table_id, row = int(parts[0]), int(parts[1])
    after = int(parts[2]) if len(parts) > 2 else 1

    def drill() -> None:
        standby.synced.wait(120.0)
        deadline = time.monotonic() + 120.0
        while (standby.records_applied < after
               and time.monotonic() < deadline):
            time.sleep(0.05)
        table = standby._tables.get(table_id)
        if table is None:
            log.error("audit-corrupt drill: no table %d on this replica",
                      table_id)
            return

        def plant() -> None:
            corrupt_table_row(table, row)
            standby.after_transfer = lambda: corrupt_table_row(table, row)
        standby._run(plant)

    threading.Thread(target=drill, daemon=True,
                     name="mv-audit-corrupt-drill").start()


def _run_join(join_path: str) -> int:
    """Live-migration joiner: catch up on the migrating ranges, wait for
    the cutover watermarks, then serve (docstring above; the coordinator
    half lives in shard/reshard.py)."""
    with open(join_path, "r", encoding="utf-8") as f:
        join = json.load(f)
    shard = int(join["shard"])

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.durable import shard_wal_dir
    from multiverso_tpu_torch.durable.migrate import RangeTailer
    from multiverso_tpu_torch.runtime.zoo import Zoo

    def status(phase: str, **extra) -> None:
        extra.update({"phase": phase, "shard": shard})
        _write_atomic(join["status_path"], json.dumps(extra))

    flags = dict(join.get("flags", {}))
    flags["ps_role"] = "server"
    flags["device"] = join.get("device", "cuda")
    _record_launches_on_stop(
        os.path.splitext(join_path)[0] + ".launches.json", flags["device"])
    flags.setdefault("metrics_shard", shard)
    flags.setdefault("metrics_role", "joiner")
    # fresh WAL lineage: this member's log starts at the absorbed
    # transfer, not at the donor's history (the donor keeps its own)
    flags["wal_dir"] = (shard_wal_dir(join["wal_root"], shard)
                        + join.get("wal_suffix", "-join"))
    mv.init(**flags)
    tables = _build_tables(mv, join, shard)
    by_id = {int(w.table_id): w for w in tables}

    tailers = []
    try:
        for donor in join["donors"]:
            specs = []
            for s in donor["specs"]:
                spec = dict(s)
                spec["server_table"] = by_id[int(s["table_id"])]._server_table
                specs.append(spec)
            tailers.append(RangeTailer(donor["endpoint"], specs).start())
    except (OSError, ConnectionError) as exc:
        status("failed", error=f"donor subscribe failed: {exc!r}")
        return 1

    deadline = time.monotonic() + float(join.get("deadline_seconds", 600.0))
    cutover = None
    while cutover is None:
        if time.monotonic() > deadline:
            status("failed", error="no cutover before the join deadline")
            return 1
        for t in tailers:
            if t.failed.is_set():
                status("failed", error=t.error)
                return 1
        status("catchup",
               lag=sum(t.lag_records() for t in tailers),
               applied=sum(t.records_applied for t in tailers),
               synced=all(t.synced.is_set() for t in tailers))
        if os.path.exists(join["cutover_path"]):
            with open(join["cutover_path"], "r", encoding="utf-8") as f:
                cutover = json.load(f)  # written atomically: never torn
            break
        time.sleep(0.1)

    watermarks = cutover.get("watermarks", {})
    for t in tailers:
        try:
            t.wait_watermark(int(watermarks.get(t.donor_endpoint, -1)),
                             timeout=max(5.0, deadline - time.monotonic()))
        except (ConnectionError, TimeoutError) as exc:
            status("failed", error=f"drain failed: {exc!r}")
            return 1
    for t in tailers:
        t.stop()

    manifest = cutover["manifest"]
    # the port was pre-assigned by the coordinator so the new manifest
    # could name this endpoint before we serve; bind it now
    endpoint = mv.serve(f"{join['host']}:{int(join['port'])}")
    remote = Zoo.instance().remote_server
    remote.layout = manifest
    remote.layout_version = int(manifest.get("layout_version", 1))
    remote.layout_path = join.get("layout_path", "")
    # the status first: the coordinator returns once the serving file
    # lands, and its caller may read the catch-up figures at once
    status("serving", endpoint=endpoint,
           records_applied=sum(t.records_applied for t in tailers),
           transfer_bytes=sum(t.transfer_bytes for t in tailers),
           transfer_s=max(t.transfer_seconds for t in tailers))
    _write_atomic(join["serving_path"], endpoint)
    while True:  # killed by the group (SIGTERM) or chaos (SIGKILL)
        time.sleep(3600)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--spec", default="")
    parser.add_argument("--shard", type=int, default=-1)
    parser.add_argument("--join", default="",
                        help="run as a live-migration joiner from this "
                             "join-spec file (reshard)")
    parser.add_argument("--standby", action="store_true")
    parser.add_argument("--replica", type=int, default=-1,
                        help="serving read-replica index (>= 0)")
    parser.add_argument("--takeover", action="store_true",
                        help="this replica also holds the failover role")
    parser.add_argument("--primary", default="")
    parser.add_argument("--recover", action="store_true")
    parser.add_argument("--restore-cut", default="",
                        help="restore this shard from a consistent-cut "
                             "snapshot directory before serving (PITR)")
    parser.add_argument("--clone-primary", default="",
                        help="bootstrap this shard's state from a live "
                             "donor primary via Control_Replicate "
                             "(blue/green clone)")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args(argv)
    if args.join:
        return _run_join(args.join)
    if not args.spec or args.shard < 0:
        parser.error("--spec and --shard are required (or --join)")

    with open(args.spec, "r", encoding="utf-8") as f:
        spec = json.load(f)
    shard = int(args.shard)
    base_dir = os.path.dirname(os.path.abspath(args.spec))

    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.durable import shard_wal_dir
    from multiverso_tpu_torch.runtime.zoo import Zoo

    flags = dict(spec.get("flags", {}))
    flags["ps_role"] = "server"
    # the group's device, never the environment's: a child asked for the
    # card raises at init when there is none
    flags["device"] = spec.get("device", "cuda")
    role_file = (f"standby{shard}" if args.standby
                 else f"replica{shard}.{args.replica}" if args.replica >= 0
                 else f"shard{shard}")
    _record_launches_on_stop(
        os.path.join(base_dir, role_file + ".launches.json"),
        flags["device"])
    # MV_CHAOS_SHARD=<k> + MV_CHAOS_SPEC=<fault DSL>: arm the chaos
    # schedule on exactly ONE shard's primary — the gray-failure drill
    # vehicle (the CI overload job stalls one shard's replies while its
    # sibling serves clean; group-spec flags reach every child equally,
    # so an asymmetric fault needs this env seam).
    chaos_shard = os.environ.get("MV_CHAOS_SHARD", "")
    if (chaos_shard != "" and int(chaos_shard) == shard
            and not args.standby and args.replica < 0):
        flags["fault_spec"] = os.environ.get("MV_CHAOS_SPEC", "")
        flags.setdefault("fault_seed", 0)
    # fleet identity for labeled metrics (mvtpu_*{shard=,role=}) — the
    # role the child was launched AS, not what it may fail over into
    flags.setdefault("metrics_shard", shard)
    flags.setdefault("metrics_role",
                     "standby" if args.standby
                     else "replica" if args.replica >= 0 else "primary")
    if spec.get("wal_root"):
        suffix = ("-standby" if args.standby
                  else f"-replica{args.replica}" if args.replica >= 0
                  else "")
        flags["wal_dir"] = shard_wal_dir(spec["wal_root"], shard) + suffix
    mv.init(**flags)
    tables = _build_tables(mv, spec, shard)
    server = Zoo.instance().server
    if server is not None:
        server.shard_id = shard  # shard identity in stall/eviction logs

    if args.standby:
        standby = mv.warm_standby(args.primary, args.primary, tables=tables)
        _write_atomic(os.path.join(base_dir, f"standby{shard}.ready"), "ok")
        standby.took_over.wait()
        remote = Zoo.instance().remote_server
        if remote is not None:
            remote.layout_path = spec.get("layout_path", "")
        _write_atomic(os.path.join(base_dir, f"standby{shard}.tookover"),
                      standby.endpoint or "")
    elif args.replica >= 0:
        standby = mv.warm_standby(args.primary, args.primary, tables=tables,
                                  takeover=args.takeover)
        read_ep = standby.serve_reads(
            f"{spec.get('host', '127.0.0.1')}:0")
        _write_atomic(os.path.join(
            base_dir, f"replica{shard}.{args.replica}.endpoint"), read_ep)
        corrupt = os.environ.get("MV_AUDIT_CORRUPT", "")
        if corrupt:
            _arm_audit_corruption(standby, corrupt)
        if args.takeover:
            standby.took_over.wait()
            remote = Zoo.instance().remote_server
            if remote is not None:
                remote.layout_path = spec.get("layout_path", "")
            _write_atomic(os.path.join(base_dir,
                                       f"standby{shard}.tookover"),
                          standby.endpoint or "")
    else:
        if args.recover:
            mv.durable_recover(tables)
        if args.restore_cut:
            _restore_from_cut(tables, args.restore_cut)
        elif args.clone_primary:
            _clone_from_primary(tables, args.clone_primary)
        endpoint = mv.serve(f"{spec.get('host', '127.0.0.1')}:{args.port}")
        remote = Zoo.instance().remote_server
        remote.layout_path = spec.get("layout_path", "")
        _write_atomic(os.path.join(base_dir, f"shard{shard}.endpoint"),
                      endpoint)
    while True:  # killed by the group (SIGTERM) or chaos (SIGKILL)
        time.sleep(3600)


if __name__ == "__main__":
    sys.exit(main())
