"""Elastic membership: live key-range split / merge / move for a
running :class:`~multiverso_tpu_torch.shard.group.ShardGroup` (port of
``multiverso_tpu/shard/reshard.py``; joiners init on the group's device,
so on the card a joiner absorbs its ranges into tensors there and
replays the donors' translated records through the scatter kernel).

The reference system fixed its server set at launch; Li et al. (OSDI'14)
§4.3 sketches the consistent-hashing answer. Here the placement object is
an explicit range layout (shard/partition.py), so elasticity is a layout
TRANSITION: a new manifest with a bumped ``layout_version``, fresh member
processes for every changed span, and a fencing protocol that makes the
switch atomic per shard without dropping a single acknowledged Add.

Protocol (docs/sharding.md §live migration; retire-donor model):

1. **Plan** (pure): compute the new bounds, the joining shards, and the
   per-(joiner, donor, table) overlap ranges. Donors are never mutated or
   shrunk — every shard whose span changes is served by a FRESH joiner
   process and the old process retires fenced, so queued stale requests
   can never index past a shrunken table.
2. **Spawn + catch-up**: joiners (``_child.py --join``) build tables at
   their new spans, absorb a quiesced raw-value transfer of exactly the
   migrating ranges from each donor, and tail the donor's WAL stream
   translated into their own coordinates (durable/migrate.py).
3. **Cutover**: once every joiner is synced and closely caught up, each
   donor receives ``Control_Migrate_Cutover``: it installs the new
   manifest + version ON ITS PUMP THREAD (so no request interleaves),
   drains its dispatcher, and replies with its WAL sequence ``W``. From
   that instant the donor refuses stale-stamped requests with
   ``Reply_WrongShard`` — and every Add it ever acknowledged has seq <= W
   and was written to the joiner's subscription socket before its ACK.
4. **Drain + serve**: joiners apply through their donors' watermarks,
   then bind their pre-assigned ports and start serving. Only now can a
   rerouted client reach them — with every acknowledged record applied.
5. **Publish**: layout.json is atomically replaced, the group's
   bookkeeping adopts the joiners, donors move to the retired list
   (still running, still fencing), and surviving members are handed the
   new manifest so bootstrap fetches converge.

Failure containment: any pre-cutover failure aborts by killing the
joiners (the layout never changed). A failure during the fence loop
rolls the already-fenced donors FORWARD to the old topology at an even
newer version — clients that adopted the doomed layout are refused back.
A joiner death after the fence respawns it against its quiesced donors
(the fence froze the WAL at ``W``, so a fresh transfer is complete by
construction).

The hot-range detector closes the loop with the observability plane: it
reads the per-shard request-rate histograms (``ROUTER_SHARD<k>_SECONDS``
via obs/timeseries.py) and proposes splitting a shard that is
``reshard_hot_ratio`` times hotter than the median; ``auto_reshard``
(default off) lets it execute the proposal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch import config, log
from multiverso_tpu_torch.dashboard import count
from multiverso_tpu_torch.obs.trace import flight_dump, hop
from multiverso_tpu_torch.runtime.message import MsgType, next_msg_id
from multiverso_tpu_torch.shard.partition import partitioner_from_spec

MIGRATABLE_KINDS = ("array", "matrix")

# a joiner counts as caught up when its tail is within this many WAL
# records of the donor's append watermark (the fence then closes the
# remainder — cutover stall is bounded by drain time over this backlog)
CATCHUP_LAG_RECORDS = 64


class MigrationError(RuntimeError):
    """A migration could not be planned or executed. The group's layout
    is unchanged, or — after a mid-cutover failure — rolled forward to an
    equivalent of the old topology at a newer layout_version."""


@dataclasses.dataclass
class MigrationPlan:
    """One planned layout transition (pure data; execute() runs it)."""

    op: str                         # "split" | "merge" | "move"
    old_manifest: Dict[str, Any]
    new_manifest: Dict[str, Any]    # joiner endpoints are None until spawn
    joiners: List[Dict[str, Any]]   # [{"shard": new_idx, "donors": [...]}]
    retiring: List[int]             # OLD shard indices whose members retire
    # seconds from the start of execute() to the end of each step:
    # "catchup_s", "cutover_s" (every donor fenced), "serving_s", "total_s"
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def new_version(self) -> int:
        return int(self.new_manifest["layout_version"])


# -- planning (pure) ----------------------------------------------------------


def _validate_migratable(manifest: Dict[str, Any]) -> None:
    for entry in manifest["tables"]:
        if entry["kind"] not in MIGRATABLE_KINDS:
            raise MigrationError(
                f"table {entry['table_id']} is {entry['kind']!r}: live "
                f"migration supports {'/'.join(MIGRATABLE_KINDS)} only "
                "(kv/sparse placement is hash-stable, not range-movable)")
        if entry["partitioner"].get("kind") != "range":
            raise MigrationError(
                f"table {entry['table_id']} is not range-partitioned; "
                "only range layouts can split/merge/move")


def _shift_maps(op: str, shard: int, old_n: int):
    """-> (new_n, {old_idx: new_idx} for survivors, joiner new indices,
    retiring old indices)."""
    if op == "split":
        return (old_n + 1,
                {o: (o if o < shard else o + 1)
                 for o in range(old_n) if o != shard},
                [shard, shard + 1], [shard])
    if op == "merge":
        return (old_n - 1,
                {o: (o if o < shard else o - 1)
                 for o in range(old_n) if o not in (shard, shard + 1)},
                [shard], [shard, shard + 1])
    return (old_n, {o: o for o in range(old_n) if o != shard},
            [shard], [shard])


def _rebound(op: str, shard: int, bounds: List[int],
             fraction: float) -> List[int]:
    """New per-table bounds for the transition (raises when a split span
    is too small to cut)."""
    bounds = [int(b) for b in bounds]
    if op == "split":
        lo, hi = bounds[shard], bounds[shard + 1]
        if hi - lo < 2:
            raise MigrationError(
                f"shard {shard} span [{lo}, {hi}) is too small to split")
        cut = lo + min(hi - lo - 1, max(1, round((hi - lo) * fraction)))
        return bounds[:shard + 1] + [cut] + bounds[shard + 1:]
    if op == "merge":
        return bounds[:shard + 1] + bounds[shard + 2:]
    return list(bounds)


def _plan(op: str, manifest: Dict[str, Any], shard: int,
          fraction: float = 0.5) -> MigrationPlan:
    _validate_migratable(manifest)
    old_n = int(manifest["num_shards"])
    limit = old_n - 1 if op == "merge" else old_n
    if not 0 <= shard < limit:
        raise MigrationError(
            f"{op} of shard {shard} is out of range for {old_n} shard(s)")
    if op == "split" and not 0.0 < fraction < 1.0:
        raise MigrationError(f"split fraction must be in (0, 1), "
                             f"got {fraction}")
    new_n, survivors, joiner_idx, retiring = _shift_maps(op, shard, old_n)
    if new_n < 1:
        raise MigrationError("merge would leave an empty group")

    new_entries = []
    for entry in manifest["tables"]:
        part = dict(entry["partitioner"])
        part["bounds"] = _rebound(op, shard, part["bounds"], fraction)
        part["num_shards"] = new_n
        new_entries.append({**entry, "partitioner": part})

    old_eps = list(manifest["endpoints"])
    raw_reps = list(manifest.get("replicas", []))
    old_reps = [list(raw_reps[k]) if k < len(raw_reps) else []
                for k in range(old_n)]
    endpoints: List[Optional[str]] = [None] * new_n
    replicas: List[List[str]] = [[] for _ in range(new_n)]
    for old, new in survivors.items():
        endpoints[new] = old_eps[old]
        replicas[new] = old_reps[old]
    # migrated shards restart their replica fleets from scratch (a
    # retired donor's replicas would serve pre-migration reads): the new
    # layout simply lists none for them — docs/sharding.md

    new_manifest = {"version": int(manifest.get("version", 1)),
                    "num_shards": new_n,
                    "layout_version":
                        int(manifest.get("layout_version", 1)) + 1,
                    "endpoints": endpoints,
                    "replicas": replicas,
                    "tables": new_entries}

    joiners = []
    for j in joiner_idx:
        donors: Dict[str, Dict[str, Any]] = {}
        for entry, new_entry in zip(manifest["tables"], new_entries):
            old_part = partitioner_from_spec(entry["partitioner"])
            new_part = partitioner_from_spec(new_entry["partitioner"])
            nlo, nhi = new_part.span(j)
            for old in retiring:
                olo, ohi = old_part.span(old)
                ov_lo, ov_hi = max(olo, nlo), min(ohi, nhi)
                if ov_lo >= ov_hi:
                    continue
                donors.setdefault(old_eps[old], {
                    "endpoint": old_eps[old], "old_shard": old,
                    "specs": []})["specs"].append({
                        "table_id": int(entry["table_id"]),
                        "kind": entry["kind"],
                        "donor_lo": ov_lo - olo, "donor_hi": ov_hi - olo,
                        "rcpt_start": ov_lo - nlo, "rcpt_size": nhi - nlo,
                        "num_col": int(entry["params"].get("num_col", 0))})
        joiners.append({"shard": j,
                        "donors": list(donors.values())})
    return MigrationPlan(op=op, old_manifest=manifest,
                         new_manifest=new_manifest, joiners=joiners,
                         retiring=retiring)


def plan_split(manifest: Dict[str, Any], shard: int,
               fraction: float = 0.5) -> MigrationPlan:
    """Split ``shard``'s span at ``fraction`` into two shards (indices
    ``shard`` and ``shard+1``; shards above shift up by one)."""
    return _plan("split", manifest, shard, fraction)


def plan_merge(manifest: Dict[str, Any], shard: int) -> MigrationPlan:
    """Merge ``shard`` and ``shard+1`` into one shard at ``shard``
    (shards above shift down by one)."""
    return _plan("merge", manifest, shard)


def plan_move(manifest: Dict[str, Any], shard: int) -> MigrationPlan:
    """Move ``shard``'s full span to a fresh member process (same bounds,
    new endpoint) — host drain / rebalance without a topology change."""
    return _plan("move", manifest, shard)


# -- execution ----------------------------------------------------------------


def _write_atomic(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(content)
    os.replace(tmp, path)


def _free_port(host: str) -> int:
    """Claim-then-release a port for a joiner so the NEW manifest can
    name its endpoint before it serves (the bind race until the joiner
    rebinds is the standard local-launcher tradeoff; a lost race kills
    the joiner, which aborts/retries the migration — never corrupts)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class MigrationCoordinator:
    """Executes MigrationPlans against a live, durable ShardGroup.

    One migration at a time (the group's layout is the shared state);
    chaos drills inject participant kills via ``MV_RESHARD_KILL``
    (``donor`` | ``recipient`` | ``recipient_early``) — see
    tests/test_reshard.py and the ci chaos matrix.
    """

    def __init__(self, group) -> None:
        self.group = group

    # -- public ops ----------------------------------------------------------
    def split(self, shard: int, fraction: float = 0.5,
              timeout: float = 180.0) -> MigrationPlan:
        plan = plan_split(self._manifest(), shard, fraction)
        return self._execute(plan, timeout)

    def merge(self, shard: int, timeout: float = 180.0) -> MigrationPlan:
        plan = plan_merge(self._manifest(), shard)
        return self._execute(plan, timeout)

    def move(self, shard: int, timeout: float = 180.0) -> MigrationPlan:
        plan = plan_move(self._manifest(), shard)
        return self._execute(plan, timeout)

    def _manifest(self) -> Dict[str, Any]:
        if self.group.layout is None:
            raise MigrationError("migration before ShardGroup.start()")
        if not self.group.durable:
            raise MigrationError(
                "live migration needs a durable group — the WAL stream IS "
                "the transfer/catch-up channel (start the group with "
                "durable=True)")
        if self.group.standby:
            raise MigrationError(
                "live migration of groups with dedicated warm standbys is "
                "not supported yet (the standby would tail a retired "
                "donor); run replicas or plain durable groups")
        return self.group.layout.manifest

    # -- the protocol --------------------------------------------------------
    def _execute(self, plan: MigrationPlan, timeout: float) -> MigrationPlan:
        from multiverso_tpu_torch.runtime.remote import control_probe
        group = self.group
        ver = plan.new_version
        mig = next_msg_id()  # trace id: the migration's hop chain
        kill = os.environ.get("MV_RESHARD_KILL", "")
        t_start = time.monotonic()
        deadline = t_start + timeout
        count("MIGRATIONS_STARTED")
        hop(mig, f"migrate_{plan.op}_v{ver}")
        log.info("migration %s -> v%d: %d joiner(s), retiring shard(s) %s",
                 plan.op, ver, len(plan.joiners), plan.retiring)

        # 1+2: spawn joiners with pre-assigned ports; wait for catch-up
        procs: Dict[int, subprocess.Popen] = {}
        paths: Dict[int, Dict[str, str]] = {}
        try:
            for joiner in plan.joiners:
                j = joiner["shard"]
                port = _free_port(group.host)
                plan.new_manifest["endpoints"][j] = f"{group.host}:{port}"
                paths[j] = self._join_paths(ver, j)
                self._write_join_spec(plan, joiner, port, paths[j])
                procs[j] = self._spawn_joiner(paths[j])
            hop(mig, "migrate_spawn")
            if kill == "recipient_early":
                self._kill(procs[plan.joiners[0]["shard"]])
            self._await_catchup(plan, procs, paths, deadline)
            plan.timings["catchup_s"] = time.monotonic() - t_start
            hop(mig, "migrate_catchup")
        except BaseException:
            self._abort(procs, paths)
            raise

        # 3: fence the donors — the atomic instant, one donor at a time
        watermarks: Dict[str, int] = {}
        fenced: List[int] = []
        try:
            for old in plan.retiring:
                endpoint = plan.old_manifest["endpoints"][old]
                reply = control_probe(
                    endpoint, MsgType.Control_Migrate_Cutover,
                    MsgType.Control_Reply_Migrate_Cutover, timeout=30.0,
                    what="migrate cutover",
                    payload={"manifest": plan.new_manifest})
                watermarks[endpoint] = int(reply.get("watermark", -1))
                fenced.append(old)
            plan.timings["cutover_s"] = time.monotonic() - t_start
            hop(mig, "migrate_cutover")
        except (OSError, RuntimeError) as exc:
            self._rollback(plan, fenced)
            self._abort(procs, paths)
            raise MigrationError(
                f"cutover failed at donor ({exc!r}); group rolled forward "
                f"to the old topology at v{ver + 1}") from exc

        if kill == "donor":
            # chaos: the donor dies right after its cutover reply — every
            # acknowledged record is <= W and already written to the
            # joiners' subscription sockets, so the migration completes
            self._kill(group._primaries[plan.retiring[0]])

        # 4: hand the watermarks down; joiners drain then serve
        for joiner in plan.joiners:
            j = joiner["shard"]
            _write_atomic(paths[j]["cutover"],
                          json.dumps({"watermarks": watermarks,
                                      "manifest": plan.new_manifest}))
        if kill == "recipient":
            self._kill(procs[plan.joiners[0]["shard"]])
        try:
            for joiner in plan.joiners:
                j = joiner["shard"]
                self._await_serving(j, procs, paths[j], deadline)
            plan.timings["serving_s"] = time.monotonic() - t_start
            hop(mig, "migrate_serve")
        except BaseException as exc:
            self._rollback(plan, fenced)
            self._abort(procs, paths)
            raise MigrationError(
                f"joiner failed after cutover ({exc!r}); group rolled "
                f"forward to the old topology at v{ver + 1}") from exc

        # 5: publish + adopt
        group.publish_manifest(plan.new_manifest)
        self._rewire_group(plan, procs)
        count("MIGRATIONS_COMPLETED")
        hop(mig, "migrate_publish")
        # hand surviving members the new manifest (refreshes their cached
        # Control_Layout reply and fences them too, so every member
        # converges stale clients onto v<new>); best-effort — a member
        # that misses it still serves the republished layout.json
        for old, new in _shift_maps(plan.op, plan.retiring[0],
                                    int(plan.old_manifest["num_shards"])
                                    )[1].items():
            try:
                control_probe(plan.old_manifest["endpoints"][old],
                              MsgType.Control_Migrate_Cutover,
                              MsgType.Control_Reply_Migrate_Cutover,
                              timeout=10.0, what="migrate propagate",
                              payload={"manifest": plan.new_manifest})
            except (OSError, RuntimeError) as exc:
                log.info("migrate: survivor %s missed the propagate (%r)",
                         plan.old_manifest["endpoints"][old], exc)
        plan.timings["total_s"] = time.monotonic() - t_start
        log.info("migration %s complete: layout v%d, %d shard(s)",
                 plan.op, ver, plan.new_manifest["num_shards"])
        return plan

    # -- helpers -------------------------------------------------------------
    def _join_paths(self, ver: int, j: int) -> Dict[str, str]:
        base = os.path.join(self.group.base_dir, f"join-v{ver}.{j}")
        return {"spec": base + ".json", "status": base + ".status",
                "cutover": base + ".cutover", "serving": base + ".serving",
                "log": base + ".log"}

    def _write_join_spec(self, plan: MigrationPlan, joiner: Dict[str, Any],
                         port: int, paths: Dict[str, str]) -> None:
        j = joiner["shard"]
        new_entries = plan.new_manifest["tables"]
        spec = {"shard": j, "host": self.group.host, "port": port,
                "flags": self.group.flags,
                "device": self.group.device,
                "wal_root": self.group.base_dir,
                "wal_suffix": f"-join{plan.new_version}",
                "layout_path": self.group.layout_path,
                "tables": new_entries,
                "donors": joiner["donors"],
                "status_path": paths["status"],
                "cutover_path": paths["cutover"],
                "serving_path": paths["serving"],
                "deadline_seconds": 600.0}
        _write_atomic(paths["spec"], json.dumps(spec))

    def _spawn_joiner(self, paths: Dict[str, str]) -> subprocess.Popen:
        argv = [sys.executable, "-m", "multiverso_tpu_torch.shard._child",
                "--join", paths["spec"]]
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        logf = open(paths["log"], "ab")
        try:
            return subprocess.Popen(argv, stdout=logf, stderr=logf, env=env)
        finally:
            logf.close()  # the child holds its own fd

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)

    def _read_status(self, path: str) -> Dict[str, Any]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _await_catchup(self, plan: MigrationPlan,
                       procs: Dict[int, subprocess.Popen],
                       paths: Dict[int, Dict[str, str]],
                       deadline: float) -> None:
        pending = {joiner["shard"] for joiner in plan.joiners}
        while pending:
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"joiners {sorted(pending)} missed the catch-up "
                    "deadline")
            for j in sorted(pending):
                if procs[j].poll() is not None:
                    raise MigrationError(
                        f"joiner {j} died during catch-up (rc="
                        f"{procs[j].returncode}); see {paths[j]['log']}")
                status = self._read_status(paths[j]["status"])
                if status.get("phase") == "failed":
                    raise MigrationError(
                        f"joiner {j} failed: {status.get('error')}")
                if (status.get("synced")
                        and int(status.get("lag", 1 << 30))
                        <= CATCHUP_LAG_RECORDS):
                    pending.discard(j)
            time.sleep(0.1)

    def _await_serving(self, j: int, procs: Dict[int, subprocess.Popen],
                       paths: Dict[str, str], deadline: float,
                       respawned: bool = False) -> None:
        while True:
            if os.path.exists(paths["serving"]):
                return
            status = self._read_status(paths["status"])
            dead = procs[j].poll() is not None
            if dead or status.get("phase") == "failed":
                if respawned:
                    raise MigrationError(
                        f"joiner {j} failed twice after cutover; see "
                        f"{paths['log']}")
                # post-fence respawn: the donors are frozen at W, so a
                # fresh transfer is complete by construction and the new
                # joiner drains instantly from the existing cutover file
                log.error("migrate: joiner %d lost after cutover — "
                          "respawning against the quiesced donor(s)", j)
                count("MIGRATION_JOINER_RESPAWNS")
                self._kill(procs[j])
                try:
                    os.remove(paths["status"])
                except OSError:
                    pass
                procs[j] = self._spawn_joiner(paths)
                respawned = True
            if time.monotonic() > deadline:
                raise MigrationError(
                    f"joiner {j} did not serve before the deadline")
            time.sleep(0.1)

    def _abort(self, procs: Dict[int, subprocess.Popen],
               paths: Dict[int, Dict[str, str]]) -> None:
        count("MIGRATIONS_ABORTED")
        for proc in procs.values():
            try:
                self._kill(proc)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        for p in paths.values():
            for key in ("spec", "status", "cutover", "serving"):
                try:
                    os.remove(p[key])
                except OSError:
                    pass

    def _rollback(self, plan: MigrationPlan, fenced: List[int]) -> None:
        """Roll FORWARD to the old topology at new_version + 1: fenced
        donors re-install their original spans under a version that
        outranks the doomed layout, so clients that adopted it are
        refused back. Donor tables were never mutated — resuming their
        old spans is exact."""
        from multiverso_tpu_torch.runtime.remote import control_probe
        rollback = dict(plan.old_manifest)
        rollback["layout_version"] = plan.new_version + 1
        for old in fenced:
            endpoint = plan.old_manifest["endpoints"][old]
            try:
                control_probe(endpoint, MsgType.Control_Migrate_Cutover,
                              MsgType.Control_Reply_Migrate_Cutover,
                              timeout=10.0, what="migrate rollback",
                              payload={"manifest": rollback})
            except (OSError, RuntimeError) as exc:
                log.error("migrate: rollback of %s failed (%r) — a stale "
                          "client may need the republished layout",
                          endpoint, exc)
        self.group.publish_manifest(rollback)
        count("MIGRATION_ROLLBACKS")

    def _rewire_group(self, plan: MigrationPlan,
                      procs: Dict[int, subprocess.Popen]) -> None:
        """Adopt the joiners into the group's process bookkeeping; donors
        (and their now-stale replica fleets) retire."""
        group = self.group
        old_n = int(plan.old_manifest["num_shards"])
        new_n = int(plan.new_manifest["num_shards"])
        _, survivors, _, _ = _shift_maps(plan.op, plan.retiring[0], old_n)
        old_primaries = list(group._primaries)
        old_fleets = list(group._replicas) or [[] for _ in range(old_n)]
        new_primaries: List[Any] = [None] * new_n
        new_fleets: List[List[Any]] = [[] for _ in range(new_n)]
        for old, new in survivors.items():
            new_primaries[new] = old_primaries[old]
            new_fleets[new] = old_fleets[old]
        for j, proc in procs.items():
            new_primaries[j] = proc
        for old in plan.retiring:
            group._retired_procs.append(old_primaries[old])
            for proc in old_fleets[old]:
                # a retired donor's replicas would serve pre-migration
                # reads: stop them outright
                try:
                    self._kill(proc)
                except Exception:  # noqa: BLE001
                    pass
        group._primaries = new_primaries
        group._replicas = new_fleets if any(new_fleets) else []


# -- hot-range detection ------------------------------------------------------


class HotRangeDetector:
    """Proposes splitting the hottest shard from live traffic telemetry.

    Reads the per-shard fan-out histograms (``ROUTER_SHARD<k>_SECONDS``)
    out of the time-series recorder's ring (obs/timeseries.py) — the same
    series the fleet view plots — and proposes a split when one shard's
    request rate is ``reshard_hot_ratio`` times the median shard's AND
    above the ``reshard_min_qps`` floor. Detection only counts and logs;
    execution stays behind the ``auto_reshard`` flag (default off).
    """

    def __init__(self, num_shards: int, recorder=None,
                 window_seconds: float = 30.0,
                 hot_ratio: Optional[float] = None,
                 min_qps: Optional[float] = None) -> None:
        if recorder is None:
            from multiverso_tpu_torch.obs.timeseries import TIMESERIES
            recorder = TIMESERIES
        self._recorder = recorder
        self.num_shards = int(num_shards)
        self.window_seconds = float(window_seconds)
        self.hot_ratio = float(hot_ratio if hot_ratio is not None
                               else config.get_flag("reshard_hot_ratio"))
        self.min_qps = float(min_qps if min_qps is not None
                             else config.get_flag("reshard_min_qps"))
        self.cold_qps = float(config.get_flag("reshard_cold_qps"))

    def shard_rates(self) -> List[float]:
        """Per-shard request rates (req/s) over the observation window."""
        rates = []
        for k in range(self.num_shards):
            hist = self._recorder.window_histogram(
                f"ROUTER_SHARD{k}_SECONDS", self.window_seconds)
            n = int(hist.count) if hist is not None else 0
            rates.append(n / self.window_seconds)
        return rates

    def propose(self) -> Optional[Dict[str, Any]]:
        """-> {"op": "split", "shard": k, "rate": .., "median": ..} when
        one shard runs hot, else None."""
        rates = self.shard_rates()
        if len(rates) < 2:
            return None  # splitting the only shard rebalances nothing
        hot = max(range(len(rates)), key=lambda k: rates[k])
        rest = sorted(r for k, r in enumerate(rates) if k != hot)
        median = rest[len(rest) // 2]
        if rates[hot] < self.min_qps:
            return None
        if rates[hot] < self.hot_ratio * max(median, 1e-9):
            return None
        count("RESHARD_PROPOSALS")
        proposal = {"op": "split", "shard": hot,
                    "rate": rates[hot], "median": median}
        log.info("hot-range detector: shard %d at %.1f req/s vs median "
                 "%.1f — proposing a split%s", hot, rates[hot], median,
                 "" if config.get_flag("auto_reshard")
                 else " (auto_reshard off: proposal only)")
        return proposal

    def propose_merge(self) -> Optional[Dict[str, Any]]:
        """-> {"op": "merge", "shard": k, "rate": .., "neighbor_rate": ..}
        when two ADJACENT shards both idle below ``reshard_cold_qps``
        (the merged shard at shard k absorbs k+1), else None."""
        rates = self.shard_rates()
        if len(rates) < 2:
            return None  # nothing to merge into
        best: Optional[int] = None
        for k in range(len(rates) - 1):
            if rates[k] >= self.cold_qps or rates[k + 1] >= self.cold_qps:
                continue
            if best is None or rates[k] + rates[k + 1] < \
                    rates[best] + rates[best + 1]:
                best = k
        if best is None:
            return None
        count("RESHARD_PROPOSALS")
        proposal = {"op": "merge", "shard": best,
                    "rate": rates[best], "neighbor_rate": rates[best + 1]}
        log.info("hot-range detector: shards %d+%d idle at %.1f/%.1f "
                 "req/s (< %.1f) — proposing a merge%s", best, best + 1,
                 rates[best], rates[best + 1], self.cold_qps,
                 "" if config.get_flag("auto_reshard")
                 else " (auto_reshard off: proposal only)")
        return proposal

    def maybe_autosplit(self,
                        coordinator: MigrationCoordinator) -> Optional[Any]:
        """One detector tick: propose, and — only when ``auto_reshard``
        is on — execute the split. Returns the executed plan or None."""
        proposal = self.propose()
        if proposal is None or not config.get_flag("auto_reshard"):
            return None
        return coordinator.split(int(proposal["shard"]))

    def tick(self, coordinator: Optional[MigrationCoordinator] = None
             ) -> Optional[Dict[str, Any]]:
        """One full detector tick: propose a split (or, failing that, a
        cold-range merge) and — when ``auto_reshard`` is on and a
        coordinator is given — execute it, RECORDING the outcome in the
        timeseries (``RESHARD_EXECUTED`` / ``RESHARD_EXEC_FAILURES``)
        and the flight recorder instead of only logging it. Returns the
        proposal dict annotated with ``executed``/``error``, or None
        when the group is balanced."""
        proposal = self.propose()
        if proposal is None:
            proposal = self.propose_merge()
        if proposal is None:
            return None
        proposal = dict(proposal)
        proposal["executed"] = False
        if coordinator is None or not config.get_flag("auto_reshard"):
            return proposal
        shard = int(proposal["shard"])
        try:
            if proposal["op"] == "split":
                coordinator.split(shard)
            else:
                coordinator.merge(shard)
            proposal["executed"] = True
            count("RESHARD_EXECUTED")
            flight_dump("reshard_executed", **proposal)
        except MigrationError as exc:
            # the coordinator already rolled forward to the old topology
            # (MIGRATION_ROLLBACKS); record WHY the plan died so the
            # operator reading the flight recorder sees cause, not just
            # the rollback counter
            proposal["error"] = str(exc)
            count("RESHARD_EXEC_FAILURES")
            flight_dump("reshard_exec_failed", **proposal)
            log.error("reshard tick: %s of shard %d failed: %s",
                      proposal["op"], shard, exc)
        return proposal
