"""The port's durable serving across a crash (``multiverso_tpu_torch/
durable/``): the child-process cases of ``tests/test_durable.py`` on the
port, driven by ``tests/torch_durable_primary_child.py``.

* A killed server loses ZERO acknowledged Adds and applies NONE twice
  after recovery, whichever instant the crash hits: before the WAL append,
  after the append but before the ACK, after the ACK, or between a fused
  micro-batch's appends and its apply.
* A killed PRIMARY is replaced by a warm standby within the lease window,
  and training completes with the final table exactly the fault-free sum,
  under async and BSP.
* A log written by a JAX-package primary that crashed recovers into a port
  server that the same client then finishes against.

Integer-valued float32 deltas make every sum exact, so a bitwise compare
holds whatever order the Adds applied in."""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.runtime.zoo import Zoo

SEED = int(os.environ.get("CHAOS_SEED", "7"))
HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD = os.path.join(HERE, "torch_durable_primary_child.py")
_JAX_CHILD = os.path.join(HERE, "durable_primary_child.py")


@pytest.fixture(autouse=True)
def port_runtime():
    """The port's flags from their defaults, tables on the CPU, one
    intra-op thread (tests/test_torch_sync.py's fixture says why);
    whatever a test starts is stopped."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TORCH_FLAGS.reset()
    TORCH_FLAGS.set("device", "cpu")
    Dashboard.reset()
    yield
    try:
        if Zoo.instance().started:
            mvt.shutdown()
    finally:
        Zoo._reset_instance()
        TORCH_FLAGS.reset()
        torch.set_num_threads(threads)


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _spawn_child(args, script=_CHILD):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(HERE) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, script, *args],
                            stdout=subprocess.PIPE, text=True, env=env)


def _await_serving(child):
    seen = []
    while len(seen) < 50:  # log INFO lines precede the ready marker
        line = child.stdout.readline()
        if not line:
            break
        line = line.strip()
        seen.append(line)
        if line.startswith("serving "):
            _, endpoint, table_id = line.split()
            return endpoint, int(table_id)
    raise AssertionError(f"child never reported serving: {seen}")


def _client_flags():
    mvt.set_flag("request_retry_seconds", 0.5)
    mvt.set_flag("reconnect_deadline_seconds", 90.0)
    mvt.set_flag("retry_base_seconds", 0.1)
    mvt.set_flag("heartbeat_seconds", 0.5)


def _reap(*procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- crash-point recovery: kill -9 at P, restart, exactly-once ----------------

@pytest.mark.parametrize("point", ["before_append", "after_append",
                                   "after_ack"])
def test_crash_point_recovery_exactly_once(point, tmp_path):
    """Kill the serving process at instant P of the 3rd Add, restart it
    from the same WAL, and finish: zero acknowledged Adds lost, zero
    double-applied (the dedup window is rebuilt from the WAL, so the
    client's retransmit of a logged-but-unACKed Add is swallowed)."""
    port = _free_port()
    root = str(tmp_path / "d")
    child = _spawn_child([str(port), root, f"--crash-point={point}",
                          "--crash-at=3"])
    child2 = None
    try:
        endpoint, table_id = _await_serving(child)
        _client_flags()
        client = mvt.remote_connect(endpoint)
        rt = client.table(table_id)
        deltas = [np.full(8, float(2 ** k), np.float32) for k in range(5)]
        rt.add(deltas[0])
        rt.add(deltas[1])
        handle = rt.add_async(deltas[2])  # the 3rd Add triggers the crash
        child.wait(timeout=60)
        assert child.returncode == 9
        child2 = _spawn_child([str(port), root, "--recover"])
        _await_serving(child2)
        rt.wait(handle)  # settles via reconnect-resume (+ dedup re-reply)
        rt.add(deltas[3])
        rt.add(deltas[4])
        final = np.asarray(rt.get(), np.float32)
        np.testing.assert_array_equal(final, np.full(8, 31.0, np.float32))
        client.close()
    finally:
        _reap(child, child2)


def test_crash_point_mid_batch_recovery_exactly_once(tmp_path):
    """Kill -9 between a fused micro-batch's WAL appends and its apply:
    the child's dispatcher is held until 3 Adds queue, so all 3 ride ONE
    fused apply — every one is WAL-logged, none is applied or ACKed when
    the process dies. After restart recovery the client's retransmits
    settle against the WAL-seeded dedup window: zero acknowledged Adds
    lost, zero double-applied."""
    port = _free_port()
    root = str(tmp_path / "d")
    child = _spawn_child([str(port), root, "--crash-point=mid_batch",
                          "--crash-at=1", "--batch-hold=3"])
    child2 = None
    try:
        endpoint, table_id = _await_serving(child)
        _client_flags()
        client = mvt.remote_connect(endpoint)
        rt = client.table(table_id)
        deltas = [np.full(8, float(2 ** k), np.float32) for k in range(4)]
        handles = [rt.add_async(deltas[k]) for k in range(3)]
        child.wait(timeout=60)
        assert child.returncode == 9
        child2 = _spawn_child([str(port), root, "--recover"])
        _await_serving(child2)
        for handle in handles:  # settle via reconnect-resume + dedup
            rt.wait(handle)
        rt.add(deltas[3])
        final = np.asarray(rt.get(), np.float32)
        np.testing.assert_array_equal(final, np.full(8, 15.0, np.float32))
        client.close()
    finally:
        _reap(child, child2)


def test_jax_primary_crash_recovers_into_port_server(tmp_path):
    """The JAX package's durable child dies after logging (not applying)
    the 3rd Add; a port server recovers the JAX log on the same port and
    the port client's retransmit settles against the seeded dedup window:
    the WAL, its dedup seeds and the wire interchange across a crash."""
    port = _free_port()
    root = str(tmp_path / "d")
    child = _spawn_child([str(port), root, "--crash-point=after_append",
                          "--crash-at=3"], script=_JAX_CHILD)
    child2 = None
    try:
        endpoint, table_id = _await_serving(child)
        _client_flags()
        client = mvt.remote_connect(endpoint)
        rt = client.table(table_id)
        deltas = [np.full(8, float(2 ** k), np.float32) for k in range(5)]
        rt.add(deltas[0])
        rt.add(deltas[1])
        handle = rt.add_async(deltas[2])
        child.wait(timeout=120)
        assert child.returncode == 9
        child2 = _spawn_child([str(port), root, "--recover"])
        _await_serving(child2)
        rt.wait(handle)
        rt.add(deltas[3])
        rt.add(deltas[4])
        np.testing.assert_array_equal(np.asarray(rt.get(), np.float32),
                                      np.full(8, 31.0, np.float32))
        client.close()
    finally:
        _reap(child, child2)


# -- warm-standby failover ----------------------------------------------------

@pytest.mark.parametrize("mode", ["async", "bsp"])
def test_warm_standby_failover_training_completes(mode, tmp_path):
    """kill -9 of the primary mid-training: the standby takes over the
    service endpoint within the lease window and training completes with
    the final table exactly the fault-free result. Each client has the
    reference test's 90 s reconnect deadline; the test waits on events."""
    port = _free_port()
    args = [str(port), str(tmp_path / "primary")]
    if mode == "bsp":
        args.append("--sync")
    child = _spawn_child(args)
    standby = None
    try:
        endpoint, table_id = _await_serving(child)
        flags = dict(ps_role="server", remote_workers=2,
                     wal_dir=str(tmp_path / "standby"),
                     request_retry_seconds=0.5,
                     reconnect_deadline_seconds=90.0,
                     retry_base_seconds=0.1, heartbeat_seconds=0.3)
        if mode == "bsp":
            flags["sync"] = True
        mvt.init(**flags)
        mvt.create_table("array", 8, np.float32)
        standby = mvt.warm_standby(endpoint, f"127.0.0.1:{port}",
                                   lease_seconds=2.0)
        assert standby.synced.wait(30), "state transfer never completed"

        n_workers = 2 if mode == "bsp" else 1
        rounds = 8
        rng = np.random.default_rng(SEED)
        deltas = rng.integers(-3, 4,
                              size=(n_workers, rounds, 8)).astype(np.float32)
        half_done = threading.Barrier(n_workers + 1)
        killed = threading.Event()
        results, errors = {}, []

        def trainer(idx):
            try:
                client = mvt.remote_connect(endpoint)
                rt = client.table(table_id)
                for i in range(rounds):
                    rt.add(deltas[idx, i])
                    if mode == "bsp":
                        rt.get()
                    if i == 2:
                        half_done.wait(timeout=60)
                        # on after the kill: it lands at a round boundary
                        # (the standby's round clocks start at 0, which a
                        # boundary matches; mid-round a worker whose Add
                        # the dead primary acknowledged waits in its Get)
                        killed.wait(timeout=60)
                rt.finish_train()
                results[idx] = np.asarray(rt.get(), np.float32)
                client.close()
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=trainer, args=(i,))
                   for i in range(n_workers)]
        for t in threads:
            t.start()
        half_done.wait(timeout=60)  # 3 rounds acked by the primary
        child.kill()  # SIGKILL: no goodbye of any kind
        child.wait(timeout=30)
        killed.set()
        assert standby.took_over.wait(60), "standby never took over"
        for t in threads:
            t.join(timeout=120)
        for t in threads:
            assert not t.is_alive(), f"{mode} trainer wedged across failover"
        assert not errors, errors

        expected = deltas.sum(axis=(0, 1))
        for idx, final in results.items():
            np.testing.assert_array_equal(final, expected,
                                          err_msg=f"trainer {idx}")
        assert standby.records_applied > 0
        assert Dashboard.counter_value("FAILOVERS") >= 1
        assert Dashboard.counter_value("CLIENT_RECONNECTS") >= n_workers
    finally:
        if standby is not None and not standby.took_over.is_set():
            standby.stop()
        _reap(child)
