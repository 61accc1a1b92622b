"""Child process serving DURABLE tables of ``multiverso_tpu_torch`` on the
CPU — the kill target of the port's crash-point-recovery, warm-standby
failover and read-replica tests (the twin of ``durable_primary_child.py``;
it imports no JAX and needs no card).

Usage: python torch_durable_primary_child.py <port> <wal_dir> [options]

    --sync                      BSP server (ps_role=server either way)
    --recover                   run mvt.durable_recover before serving
                                (the restarted-server role)
    --crash-point=P --crash-at=N
                                os._exit(9) on the N-th wire Add at point
                                P: before_append (nothing logged),
                                after_append (logged, apply/ACK never
                                happen), after_ack (logged+applied+ACKed),
                                mid_batch (the N-th FUSED apply: the whole
                                micro-batch is WAL-logged, the fused
                                scatter and every ACK never happen)
    --batch-hold=N              dispatcher drains only once N messages are
                                queued — forces a deterministic N-message
                                fused batch for the mid_batch point
    --fault-spec=S --fault-seed=K
                                chaos on this server's transports

Prints ``serving <endpoint> <table_id>`` once ready, then sleeps until
killed (or until the armed crash fires)."""

import os
import sys
import time

import numpy as np
import torch

import multiverso_tpu_torch as mvt


def arm_crash(point: str, at: int) -> None:
    """Patch the port's dispatcher so the process dies with ``os._exit(9)``
    at crash point ``point`` of the ``at``-th wire Add (module docstring)."""
    state = {"appends": 0, "acks": 0}
    from multiverso_tpu_torch.runtime.server import Server
    if point in ("before_append", "after_append"):
        orig = Server._wal_append

        def hooked(self, msg):
            if getattr(msg, "_wal", None) is None or self.wal is None:
                return orig(self, msg)
            state["appends"] += 1
            if state["appends"] == at and point == "before_append":
                os._exit(9)
            orig(self, msg)
            if state["appends"] == at and point == "after_append":
                os._exit(9)

        Server._wal_append = hooked
    elif point == "mid_batch":
        # kill between a micro-batch's WAL appends and its fused apply:
        # every Add in the batch is logged but neither applied nor ACKed
        orig_fused = Server._apply_fused

        def hooked_fused(self, table, request):
            state["appends"] += 1
            if state["appends"] == at:
                os._exit(9)
            orig_fused(self, table, request)

        Server._apply_fused = hooked_fused
    elif point == "after_ack":
        from multiverso_tpu_torch.runtime import remote
        from multiverso_tpu_torch.runtime.message import MsgType
        orig_reply = remote._NetCompletion._reply

        def hooked_reply(self, msg_type, payload):
            orig_reply(self, msg_type, payload)
            if self._template.type == MsgType.Request_Add:
                state["acks"] += 1
                if state["acks"] == at:
                    os._exit(9)

        remote._NetCompletion._reply = hooked_reply
    else:
        raise SystemExit(f"unknown crash point {point!r}")


def arm_batch_hold(n: int) -> None:
    """Make the dispatcher drain only once ``n`` messages are queued — a
    deterministic fused batch (the dispatcher queue is the only pop_all
    user in this process)."""
    from multiverso_tpu_torch.utils import MtQueue
    orig = MtQueue.pop_all

    def held(self):
        while self.alive and self.size() < n:
            time.sleep(0.005)
        return orig(self)

    MtQueue.pop_all = held


def main() -> int:
    torch.set_num_threads(1)
    port, wal_dir = sys.argv[1], sys.argv[2]
    opts = sys.argv[3:]
    crash_point, crash_at = None, 0
    batch_hold = 0
    fault_spec, fault_seed = "", 0
    for arg in opts:
        if arg.startswith("--crash-point="):
            crash_point = arg.split("=", 1)[1]
        elif arg.startswith("--crash-at="):
            crash_at = int(arg.split("=", 1)[1])
        elif arg.startswith("--batch-hold="):
            batch_hold = int(arg.split("=", 1)[1])
        elif arg.startswith("--fault-spec="):
            fault_spec = arg.split("=", 1)[1]
        elif arg.startswith("--fault-seed="):
            fault_seed = int(arg.split("=", 1)[1])
    if batch_hold > 0:
        # BEFORE init: the dispatcher thread blocks inside pop_all from
        # startup, so patching later would miss its first (held) drain
        arm_batch_hold(batch_hold)
    flags = dict(device="cpu", ps_role="server", remote_workers=2,
                 wal_dir=wal_dir, heartbeat_seconds=0.2, lease_seconds=30.0,
                 fault_spec=fault_spec, fault_seed=fault_seed)
    if "--sync" in opts:
        flags["sync"] = True
    mvt.init(**flags)
    table = mvt.create_table("array", 8, np.float32)
    if "--recover" in opts:
        mvt.durable_recover([table])
    if crash_point:
        arm_crash(crash_point, crash_at)
    endpoint = mvt.serve(f"127.0.0.1:{port}")
    print(f"serving {endpoint} {table.table_id}", flush=True)
    time.sleep(600)  # killed (or crashed) long before this
    return 1


if __name__ == "__main__":
    sys.exit(main())
