"""The port's lock-order sanitizer (``fault/lockcheck.py``) — twins of
``tests/test_mvlint.py``'s four lockcheck units — and ``tools.mvlint``'s
metric and flag rules pointed at the port.

The fixture puts back exactly the lock factories it found, whether the
JAX package's sanitizer had patched them (``MV_LOCKCHECK=1``) or not. The
lint test held the port's findings to the metrics and flags of the modules
still to be ported; with ``native/``'s allocator flags ported the lists are
empty, so the port lints clean."""

import re
import threading
import time
from pathlib import Path

import pytest

from multiverso_tpu_torch.fault import lockcheck as port_lockcheck

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def lockcheck_session():
    found = (threading.Lock, threading.RLock, threading.Condition)
    was_enabled = port_lockcheck.enabled()
    port_lockcheck.enable()
    try:
        yield port_lockcheck
    finally:
        port_lockcheck.take_findings()
        if not was_enabled:
            port_lockcheck.disable()
        assert (threading.Lock, threading.RLock, threading.Condition) == found


def test_lockcheck_reports_ab_ba_cycle_across_threads(lockcheck_session):
    lockcheck = lockcheck_session
    lock_a = threading.Lock()
    lock_b = threading.Lock()

    def forward():
        with lock_a:
            with lock_b:
                pass

    def backward():
        with lock_b:
            with lock_a:
                pass

    # sequenced (join between) so the inversion is recorded without any
    # risk of the test actually deadlocking
    t1 = threading.Thread(target=forward, name="t-forward")
    t1.start()
    t1.join(5.0)
    t2 = threading.Thread(target=backward, name="t-backward")
    t2.start()
    t2.join(5.0)

    cycles = [f for f in lockcheck.take_findings()
              if f["kind"] == "lock_order_cycle"]
    assert len(cycles) == 1, cycles
    report = cycles[0]
    assert report["thread"] == "t-backward"
    assert len(report["locks"]) >= 2
    assert "backward" in report["acquire_stack"]
    assert report["held_stack"]


def test_lockcheck_consistent_order_is_clean(lockcheck_session):
    lockcheck = lockcheck_session
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    for _ in range(5):
        with lock_a:
            with lock_b:
                pass
    assert [f for f in lockcheck.take_findings()
            if f["kind"] == "lock_order_cycle"] == []


def test_lockcheck_hold_time_outlier(lockcheck_session, monkeypatch):
    lockcheck = lockcheck_session
    monkeypatch.setenv("MV_LOCKCHECK_HOLD_SECONDS", "0.01")
    lock = threading.Lock()
    with lock:
        time.sleep(0.05)
    outliers = [f for f in lockcheck.take_findings()
                if f["kind"] == "lock_hold_outlier"]
    assert len(outliers) == 1, outliers
    assert outliers[0]["held_seconds"] >= 0.05
    assert outliers[0]["threshold"] == 0.01


def test_lockcheck_rlock_and_condition_still_work(lockcheck_session):
    lockcheck = lockcheck_session
    rlock = threading.RLock()
    with rlock:
        with rlock:  # reentrant: no self-edge, no finding
            pass
    cond = threading.Condition()
    flag = []

    def setter():
        with cond:
            flag.append(1)
            cond.notify_all()

    t = threading.Thread(target=setter)
    with cond:
        t.start()
        assert cond.wait_for(lambda: flag, timeout=5.0)
    t.join(5.0)
    assert [f for f in lockcheck.take_findings()
            if f["kind"] == "lock_order_cycle"] == []


def test_lockcheck_wraps_native_locks_over_another_sanitizer():
    """With the JAX package's sanitizer already patched in, the port's
    wraps native locks (not the other's wrappers) and hands back the
    other's factories when it is disabled."""
    import _thread

    from multiverso_tpu.fault import lockcheck as jax_lockcheck
    found = (threading.Lock, threading.RLock, threading.Condition)
    jax_was = jax_lockcheck.enabled()
    assert not port_lockcheck.enabled()
    jax_lockcheck.enable()
    try:
        patched = (threading.Lock, threading.RLock, threading.Condition)
        port_lockcheck.enable()
        try:
            lock = threading.Lock()
            assert isinstance(lock, port_lockcheck._CheckedLock)
            assert type(lock._inner) is type(_thread.allocate_lock())
            rlock = threading.RLock()
            assert type(rlock._inner) is threading._CRLock
            assert isinstance(threading.Condition(), port_lockcheck._REAL[
                "Condition"])
        finally:
            port_lockcheck.disable()
        assert (threading.Lock, threading.RLock,
                threading.Condition) == patched
    finally:
        if not jax_was:
            jax_lockcheck.disable()
        port_lockcheck.take_findings()
    assert (threading.Lock, threading.RLock, threading.Condition) == found


def test_lockcheck_cycle_counts_and_dumps(lockcheck_session, tmp_path):
    from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
    from multiverso_tpu_torch.dashboard import Dashboard
    TORCH_FLAGS.reset()
    path = tmp_path / "flight.jsonl"
    TORCH_FLAGS.set("flight_recorder_path", str(path))
    before = Dashboard.counter_value("LOCK_ORDER_CYCLES")
    try:
        lock_a, lock_b = threading.Lock(), threading.Lock()
        with lock_a:
            with lock_b:
                pass
        with lock_b:
            with lock_a:
                pass
        assert Dashboard.counter_value("LOCK_ORDER_CYCLES") == before + 1
        assert "lock_order_cycle" in path.read_text()
    finally:
        TORCH_FLAGS.reset()


# -- tools.mvlint on the port ---------------------------------------------------

#: Flags of the modules still to be ported: none (the module port is done).
QUEUED_FLAGS = set()
#: Catalogued metrics only those modules emit: none.
QUEUED_METRICS = set()


def test_port_lints_to_the_queued_modules_only():
    from tools.mvlint.core import Project, RULES
    import tools.mvlint.rules_registry  # noqa: F401  (registers the rules)
    project = Project(REPO, package="multiverso_tpu_torch")
    names = {}
    for rule in ("flags", "metrics-docs"):
        found = RULES[rule](project)
        names[rule] = {re.search(r"'([^']+)'", f.message).group(1)
                       for f in found}
        assert all("read but never declared" in f.message
                   or "phantom metric" in f.message for f in found), \
            "\n".join(str(f) for f in found)
    assert names["flags"] == QUEUED_FLAGS
    assert names["metrics-docs"] == QUEUED_METRICS


def test_lockcheck_on_before_imports_that_register_fork_hooks():
    """``concurrent.futures`` (imported by torch) registers a lock's
    ``_at_fork_reinit`` at import: with the sanitizer on first, the import
    and a forked child still work."""
    import os
    import subprocess
    import sys
    code = ("from multiverso_tpu_torch.fault import lockcheck\n"
            "lockcheck.enable()\n"
            "import concurrent.futures as cf, os, threading\n"
            "with cf.ThreadPoolExecutor(2) as ex:\n"
            "    assert ex.submit(lambda: 7).result() == 7\n"
            "lock = threading.Lock()\n"
            "lock.acquire()\n"
            "lock._at_fork_reinit()\n"
            "assert not lock.locked()\n"
            "pid = os.fork()\n"
            "if pid == 0:\n"
            "    os._exit(0)\n"
            "assert os.waitpid(pid, 0)[1] == 0\n"
            "print('FORK_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "FORK_OK"
