"""ShardGroup — launch N serving processes + publish the layout manifest
(port of ``multiverso_tpu/shard/group.py``).

The reference ran one server actor per MPI rank and the Controller
broadcast membership; here each shard is one OS process owning its own
dispatcher, lease table, dedup window, WAL directory, and (optionally) a
warm standby — so a shard's failure, recovery, and failover are fully
independent of its peers (the acceptance property the chaos tests pin).

The launcher is deliberately file-based: children announce their bound
endpoints through ``<base_dir>/shard<k>.endpoint`` files (no stdout
parsing races), the parent then writes ``layout.json`` atomically, and
every member serves it over the ``Control_Layout`` RPC — the manifest on
disk doubles as the recovery record for a restarted shard.

The device is the group's: ``device`` (default: the ``device`` flag,
``cuda``) is written into the group spec, and every child — primary,
standby, replica, joiner — inits its runtime with it, so its tables live
on that device and its row Gets and Adds run the card's kernels. A child
asked for ``cuda`` where there is none raises; nothing falls back to the
CPU. Several shards of a local group share one card, each with its own
CUDA context. Children are fresh interpreters (``python -m
multiverso_tpu_torch.shard._child``), so no CUDA context crosses a fork.

When a child is stopped (SIGTERM) it writes ``<role>.launches.json``
beside its endpoint file: how many times its process launched each row
kernel (:func:`ShardGroup.kernel_launches` reads them).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.shard.partition import plan_tables, validate_partitioner_flag
from multiverso_tpu_torch.shard.router import (LAYOUT_VERSION, ShardLayout,
                                         ShardedClient)

class ShardGroup:
    """Start and own a local group of shard-serving child processes."""

    def __init__(self, tables: Sequence[Dict[str, Any]],
                 shards: Optional[int] = None,
                 base_dir: Optional[str] = None,
                 standby: bool = False,
                 replicas: Optional[int] = None,
                 durable: Optional[bool] = None,
                 partitioner: Optional[str] = None,
                 flags: Optional[Dict[str, Any]] = None,
                 host: str = "127.0.0.1",
                 preplanned: bool = False,
                 device: Optional[str] = None) -> None:
        if shards is None:
            shards = int(config.get_flag("shards"))
        if shards < 1:
            log.fatal("ShardGroup needs shards >= 1 (pass shards= or set "
                      "the -shards flag)")
        self.num_shards = int(shards)
        self.standby = bool(standby)
        # serving read replicas per shard (read-replica tier): each tails
        # its primary's WAL and answers slot-free watermark-stamped Gets.
        # With standby=False, replica 0 doubles as the failover standby
        # (takeover role); with standby=True the dedicated standby keeps
        # the takeover role and replicas only serve reads.
        self.num_replicas = int(replicas if replicas is not None
                                else config.get_flag("replicas"))
        if self.num_replicas < 0:
            log.fatal("ShardGroup needs replicas >= 0, got %d",
                      self.num_replicas)
        # standby/replica replication tails the WAL — durability is implied
        self.durable = (bool(durable) if durable is not None
                        else (self.standby or self.num_replicas > 0))
        if preplanned:
            # tables are already per-shard plan entries (a cut manifest's
            # or a source group's layout) — replanning could change the
            # partition and misalign every restored/cloned shard snapshot
            self.entries = [dict(e) for e in tables]
        else:
            part_flag = validate_partitioner_flag(
                partitioner if partitioner is not None
                else config.get_flag("shard_partitioner"))
            self.entries = plan_tables(tables, self.num_shards, part_flag)
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="mv_shards_")
        os.makedirs(self.base_dir, exist_ok=True)
        self.host = host
        self.device = str(device if device is not None
                          else config.get_flag("device"))
        self.flags = dict(flags or {})
        self.flags.setdefault("remote_workers", 4)
        self.layout_path = os.path.join(self.base_dir, "layout.json")
        self.spec_path = os.path.join(self.base_dir, "group.json")
        self.endpoints: List[str] = []
        self.replica_endpoints: List[List[str]] = []
        self.layout: Optional[ShardLayout] = None
        self._primaries: List[subprocess.Popen] = []
        self._standbys: List[Optional[subprocess.Popen]] = []
        self._replicas: List[List[subprocess.Popen]] = []
        # donors retired by a live migration (shard/reshard.py): they keep
        # running FENCED — serving Reply_WrongShard to stale clients —
        # until the group stops
        self._retired_procs: List[subprocess.Popen] = []
        # extra child argv per primary shard — the PITR/clone bring-up
        # vehicle (durable/cut.py): restore_fleet appends
        # ["--restore-cut", <cut_dir>], clone_fleet
        # ["--clone-primary", <endpoint>]
        self._primary_extra: Dict[int, List[str]] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout: float = 240.0) -> "ShardGroup":
        """Spawn the members and publish the manifest. A start that fails
        (a child dies, the deadline passes) stops every process it had
        started before it raises, so a failed start leaves none behind."""
        try:
            return self._start(timeout)
        except BaseException:
            self.stop()
            raise

    def _clear_announcements(self) -> None:
        """Remove what an earlier group in the same ``base_dir`` left:
        an old endpoint or ready file would be read as this group's
        announcement, an old launch readout as this group's."""
        suffixes = (".endpoint", ".ready", ".tookover", ".launches.json")
        for name in os.listdir(self.base_dir):
            if name.endswith(suffixes):
                os.remove(os.path.join(self.base_dir, name))

    def _start(self, timeout: float) -> "ShardGroup":
        self._clear_announcements()
        spec = {"version": LAYOUT_VERSION,
                "num_shards": self.num_shards,
                "tables": self.entries,
                "flags": self.flags,
                "host": self.host,
                "device": self.device,
                "wal_root": self.base_dir if self.durable else "",
                "layout_path": self.layout_path}
        with open(self.spec_path, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        deadline = time.monotonic() + timeout
        for k in range(self.num_shards):
            self._primaries.append(self._spawn(k))
        self.endpoints = [self._await_file(f"shard{k}.endpoint", k, deadline)
                          for k in range(self.num_shards)]
        # replicas spawn after the primaries (they subscribe to them) but
        # BEFORE the manifest publish, so the layout clients bootstrap
        # from already names every read endpoint
        if self.num_replicas > 0:
            for k in range(self.num_shards):
                fleet = []
                for i in range(self.num_replicas):
                    takeover = i == 0 and not self.standby
                    fleet.append(self._spawn(k, replica_index=i,
                                             primary=self.endpoints[k],
                                             takeover=takeover))
                self._replicas.append(fleet)
            self.replica_endpoints = [
                [self._await_file(f"replica{k}.{i}.endpoint", k, deadline,
                                  proc=self._replicas[k][i])
                 for i in range(self.num_replicas)]
                for k in range(self.num_shards)]
        self.publish_manifest({"version": LAYOUT_VERSION,
                               "num_shards": self.num_shards,
                               "layout_version": 1,
                               "endpoints": self.endpoints,
                               "replicas": self.replica_endpoints,
                               "tables": self.entries})
        if self.standby:
            for k in range(self.num_shards):
                self._standbys.append(
                    self._spawn(k, standby=True,
                                primary=self.endpoints[k]))
            for k in range(self.num_shards):
                self._await_file(f"standby{k}.ready", k, deadline)
        log.info("shard group up: %d shard(s) at %s%s%s", self.num_shards,
                 self.endpoints, " (+warm standbys)" if self.standby else "",
                 (f" (+{self.num_replicas} read replica(s)/shard)"
                  if self.num_replicas else ""))
        return self

    def _spawn(self, shard: int, standby: bool = False,
               primary: str = "", replica_index: Optional[int] = None,
               takeover: bool = False,
               spec_path: Optional[str] = None) -> subprocess.Popen:
        argv = [sys.executable, "-m", "multiverso_tpu_torch.shard._child",
                "--spec", spec_path or self.spec_path,
                "--shard", str(shard)]
        if standby:
            argv += ["--standby", "--primary", primary]
        elif replica_index is not None:
            argv += ["--replica", str(replica_index), "--primary", primary]
            if takeover:
                argv += ["--takeover"]
        else:
            argv += self._primary_extra.get(shard, [])
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        role = ("standby" if standby
                else f"replica{shard}.{replica_index}"
                if replica_index is not None else "shard")
        name = role if replica_index is not None else f"{role}{shard}"
        logf = open(os.path.join(self.base_dir, f"{name}.log"), "ab")
        try:
            return subprocess.Popen(argv, stdout=logf, stderr=logf, env=env)
        finally:
            logf.close()  # the child holds its own fd

    def _await_file(self, name: str, shard: int, deadline: float,
                    proc: Optional[subprocess.Popen] = None) -> str:
        path = os.path.join(self.base_dir, name)
        if proc is None:
            procs = self._standbys if name.startswith("standby") else \
                self._primaries
            proc = procs[shard] if shard < len(procs) else None
        while time.monotonic() < deadline:
            if os.path.exists(path):
                with open(path, "r", encoding="utf-8") as f:
                    content = f.read().strip()
                if content:
                    return content
            if proc is not None and proc.poll() is not None:
                log.fatal("shard child %d died during startup (rc=%s); "
                          "see %s", shard, proc.returncode,
                          os.path.join(self.base_dir,
                                       name.split(".endpoint")[0].split(
                                           ".ready")[0] + ".log"))
            time.sleep(0.05)
        log.fatal("shard group startup timed out waiting for %s", name)

    def publish_manifest(self, manifest: Dict[str, Any]) -> None:
        """Atomically publish ``manifest`` as layout.json and adopt it as
        the group's current view — start() and live migrations
        (shard/reshard.py) both land here. Members serve the file over
        Control_Layout; the atomic replace means a bootstrapping client
        never reads a torn manifest."""
        tmp = self.layout_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
        os.replace(tmp, self.layout_path)  # atomic publish
        self.layout = ShardLayout(manifest)
        self.endpoints = list(manifest["endpoints"])
        self.replica_endpoints = [list(r)
                                  for r in manifest.get("replicas", [])]
        self.num_shards = int(manifest["num_shards"])

    def connect(self, timeout: float = 30.0,
                read_preference: Optional[str] = None) -> ShardedClient:
        """A router client over this group's layout. ``read_preference``
        overrides the flag for this client (primary|replica|hedged)."""
        if self.layout is None:
            log.fatal("ShardGroup.connect before start()")
        return ShardedClient(self.layout, timeout=timeout,
                             read_preference=read_preference)

    # -- live replica membership (the autopilot's actuator surface) ----------
    def add_replica(self, shard: int, timeout: float = 120.0) -> str:
        """Live-add one serving read replica to shard ``shard``: spawn a
        fresh replica child against the shard's primary, wait for its
        endpoint, and republish the manifest with it. ``layout_version``
        is NOT bumped — replica membership moves no key ownership, so
        in-flight sharded requests stay valid; routers pick up the new
        read endpoint on their next layout refresh. Returns the new
        replica's endpoint."""
        if self.layout is None:
            log.fatal("ShardGroup.add_replica before start()")
        shard = int(shard)
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"add_replica: shard {shard} out of range "
                             f"(group has {self.num_shards})")
        while len(self._replicas) < self.num_shards:
            self._replicas.append([])
        seqs = getattr(self, "_replica_seq", None)
        if seqs is None:
            seqs = self._replica_seq = {}
        # spawn indices are monotonic per shard so a re-added replica can
        # never adopt a removed one's stale endpoint file
        i = seqs.get(shard, max(self.num_replicas,
                                len(self._replicas[shard])))
        seqs[shard] = i + 1
        stale = os.path.join(self.base_dir, f"replica{shard}.{i}.endpoint")
        if os.path.exists(stale):
            os.remove(stale)
        # spawn against a CURRENT-layout spec: after a live migration the
        # start-time group.json holds pre-migration spans, and a replica
        # built at stale bounds would silently diverge from its primary
        manifest = self.layout.manifest
        lv = int(manifest.get("layout_version", 1))
        spec_path = os.path.join(self.base_dir, f"group-v{lv}.json")
        spec = {"version": LAYOUT_VERSION,
                "num_shards": self.num_shards,
                "tables": manifest["tables"],
                "flags": self.flags,
                "host": self.host,
                "device": self.device,
                "wal_root": self.base_dir if self.durable else "",
                "layout_path": self.layout_path}
        tmp = spec_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(spec, f)
        os.replace(tmp, spec_path)
        proc = self._spawn(shard, replica_index=i,
                           primary=self.endpoints[shard],
                           spec_path=spec_path)
        endpoint = self._await_file(f"replica{shard}.{i}.endpoint", shard,
                                    time.monotonic() + timeout, proc=proc)
        self._replicas[shard].append(proc)
        manifest = dict(self.layout.manifest)
        replicas = [list(r) for r in manifest.get("replicas", [])]
        while len(replicas) < self.num_shards:
            replicas.append([])
        replicas[shard] = replicas[shard] + [endpoint]
        manifest["replicas"] = replicas
        self.publish_manifest(manifest)
        log.info("shard %d: read replica added at %s (%d now serving)",
                 shard, endpoint, len(replicas[shard]))
        return endpoint

    def remove_replica(self, shard: int,
                       index: Optional[int] = None) -> str:
        """Live-remove one of shard ``shard``'s read replicas (default:
        the newest). The manifest republishes FIRST — routers refreshing
        the layout stop picking the endpoint before the process dies,
        and reads already in flight fail over through the read tier's
        normal replica/primary fallback. Returns the removed
        endpoint."""
        if self.layout is None:
            log.fatal("ShardGroup.remove_replica before start()")
        shard = int(shard)
        fleet = self._replicas[shard] if shard < len(self._replicas) else []
        eps = (self.replica_endpoints[shard]
               if shard < len(self.replica_endpoints) else [])
        if not fleet or not eps or len(fleet) != len(eps):
            raise ValueError(f"remove_replica: shard {shard} has no "
                             f"removable replica (procs={len(fleet)}, "
                             f"endpoints={len(eps)})")
        if index is None:
            index = len(fleet) - 1
        index = int(index)
        if not 0 <= index < len(fleet):
            raise ValueError(f"remove_replica: shard {shard} replica "
                             f"index {index} out of range")
        endpoint = eps[index]
        manifest = dict(self.layout.manifest)
        replicas = [list(r) for r in manifest.get("replicas", [])]
        replicas[shard] = [e for e in replicas[shard] if e != endpoint]
        manifest["replicas"] = replicas
        self.publish_manifest(manifest)
        proc = fleet.pop(index)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        log.info("shard %d: read replica %s removed (%d still serving)",
                 shard, endpoint, len(replicas[shard]))
        return endpoint

    # -- chaos / failover hooks ----------------------------------------------
    def kill_shard(self, shard: int) -> None:
        """SIGKILL shard ``shard``'s primary — the chaos hook. With
        ``standby=True`` that shard's warm standby detects the lease
        expiry and takes over the endpoint; the other shards never see
        anything."""
        proc = self._primaries[shard]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def kill_replica(self, shard: int, index: int = 0) -> None:
        """SIGKILL one of shard ``shard``'s read replicas — the read-path
        chaos hook: clients' reads transparently fail over to the
        remaining replicas / the primary (zero caller-visible errors, the
        drill tests/test_replica.py pins)."""
        proc = self._replicas[shard][index]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)

    def wait_failover(self, shard: int, timeout: float = 60.0) -> str:
        """Block until shard ``shard``'s standby has taken over; returns
        the (re-bound) service endpoint."""
        deadline = time.monotonic() + timeout
        return self._await_file(f"standby{shard}.tookover", shard, deadline)

    def kernel_launches(self) -> Dict[str, Dict[str, int]]:
        """Row-kernel launches of every child that has stopped, by role
        file (``shard0``, ``standby1``, ``replica0.0``,
        ``join-v2.0``, ...): ``{"scatter_add_rows": n, "gather_rows": n,
        "scatter_add_rows_coalesced": n, "device": ...}``. A child writes
        its counts when it is stopped (SIGTERM), so read this after
        :meth:`stop`; a SIGKILLed child leaves none."""
        out: Dict[str, Dict[str, int]] = {}
        suffix = ".launches.json"
        for name in sorted(os.listdir(self.base_dir)):
            if name.endswith(suffix):
                with open(os.path.join(self.base_dir, name), "r",
                          encoding="utf-8") as f:
                    out[name[:-len(suffix)]] = json.load(f)
        return out

    def _all_procs(self) -> List[subprocess.Popen]:
        return (list(self._primaries)
                + [p for p in self._standbys if p is not None]
                + [p for fleet in self._replicas for p in fleet]
                + list(self._retired_procs))

    def stop(self) -> None:
        for proc in self._all_procs():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 15.0
        for proc in self._all_procs():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        self._primaries.clear()
        self._standbys.clear()
        self._replicas.clear()
        self._retired_procs.clear()

    def __enter__(self) -> "ShardGroup":
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()
