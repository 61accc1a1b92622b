"""The port's profiler (``obs/profiler.py``) and thread contracts
(``runtime/contracts.py``): the behaviour of ``tests/test_profiler.py``
and ``tests/test_mvlint.py``'s contract cases that needs no wire, on the
port; plus ``create_table("sparse", ...)`` as the first call of a fresh
process."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.obs.profiler import (PROFILER, SamplingProfiler,
                                               WAIT_SITES, capture_for_alert,
                                               clear_wait, current_wait,
                                               mark_wait, wait_site)
from multiverso_tpu_torch.runtime import contracts

REPO = Path(__file__).resolve().parent.parent


class _Parked:
    """A helper thread parked off-CPU (Event.wait) under an optional
    wait-site tag until released."""

    def __init__(self, site=None, name="parked"):
        self.site = site
        self.ready = threading.Event()
        self.release = threading.Event()
        self.thread = threading.Thread(target=self._run, name=name,
                                       daemon=True)
        self.thread.start()
        assert self.ready.wait(5.0)
        time.sleep(0.01)

    def _run(self):
        prev = mark_wait(self.site) if self.site else None
        self.ready.set()
        try:
            self.release.wait(30.0)
        finally:
            if self.site:
                clear_wait(prev)

    def stop(self):
        self.release.set()
        self.thread.join(5.0)
        assert not self.thread.is_alive()


def test_wait_site_registry_nesting_and_context_manager():
    assert current_wait() is None
    prev = mark_wait("net_recv")
    assert prev is None and current_wait() == "net_recv"
    inner = mark_wait("wal_fsync")
    assert inner == "net_recv" and current_wait() == "wal_fsync"
    clear_wait(inner)
    assert current_wait() == "net_recv"
    clear_wait(prev)
    assert current_wait() is None
    with pytest.raises(RuntimeError):
        with wait_site("tier_cold_fetch"):
            assert current_wait() == "tier_cold_fetch"
            raise RuntimeError("boom")
    assert current_wait() is None
    assert set(WAIT_SITES) == {"lock_acquire", "net_recv", "wal_fsync",
                               "dispatcher_drain", "shm_ring_spin",
                               "tier_cold_fetch"}


def test_sample_once_classifies_tagged_blocked_and_on_cpu():
    prof = SamplingProfiler(hz=50.0, max_frames=24)
    tagged = _Parked(site="tier_cold_fetch", name="tprof-tagged")
    untagged = _Parked(site=None, name="tprof-untagged")
    done = threading.Event()

    def _burn():
        while not done.is_set():
            pass

    burner = threading.Thread(target=_burn, name="tprof-burner", daemon=True)
    burner.start()
    try:
        for _ in range(10):
            out = prof.sample_once(weight=0.02)
        assert out["sites"].get("tier_cold_fetch") == 1
        assert out["sites"].get("blocked:wait", 0) >= 1
        rep = prof.report()
        assert rep["samples"] == 10
        info = rep["threads"]["tprof-tagged"]
        assert info["off_cpu"] == pytest.approx(0.2)
        assert info["waits"] == {"tier_cold_fetch": pytest.approx(0.2)}
        assert rep["threads"]["tprof-untagged"]["waits"] == {
            "blocked:wait": pytest.approx(0.2)}
        assert rep["wait_seconds"]["tier_cold_fetch"] == pytest.approx(0.2)
        assert not any(s.startswith("blocked:") for s in rep["wait_seconds"])
        assert rep["threads"]["tprof-burner"]["on_cpu"] > 0
        assert "tprof-tagged" in prof.render()
    finally:
        done.set()
        tagged.stop()
        untagged.stop()
        burner.join(5.0)


def test_collapsed_stacks_and_flag_defaults():
    TORCH_FLAGS.reset()
    mvt.set_flag("profile_max_frames", 3)
    try:
        prof = SamplingProfiler()       # hz and depth from the flags
        assert prof.hz == 50.0 and prof.max_frames == 3
        parked = _Parked(site="net_recv", name="tprof-collapse")
        try:
            prof.sample_once()
        finally:
            parked.stop()
    finally:
        TORCH_FLAGS.reset()
    lines = [ln for ln in prof.collapsed().splitlines()
             if ln.startswith("tprof-collapse;")]
    assert lines, prof.collapsed()
    stack, n = lines[0].rsplit(" ", 1)
    frames = stack.split(";")
    assert int(n) == 1 and frames[0] == "tprof-collapse"
    assert frames[-1] == "[wait:net_recv]" and len(frames) <= 1 + 3 + 1


def test_metrics_emission_sampler_thread_and_alert_capture():
    prof = SamplingProfiler(hz=200.0, max_frames=24, emit_metrics=True)
    parked = _Parked(site="shm_ring_spin", name="tprof-emit")
    samples0 = Dashboard.counter_value("PROFILE_SAMPLES")
    try:
        prof.sample_once(weight=0.005)
        prof.sample_once(weight=0.005)
        assert Dashboard.counter_value("PROFILE_SAMPLES") == samples0 + 2
        assert Dashboard.gauge("PROFILE_OFF_CPU_THREADS").value >= 1
        assert Dashboard.gauge("PROFILE_WAIT_SHM_RING_SPIN_SECONDS").value \
            == pytest.approx(0.01)
    finally:
        parked.stop()
    prof.reset()
    assert prof.samples == 0
    prof.start()
    assert prof.running and prof._thread.name == "mv-profiler"
    deadline = time.monotonic() + 5.0
    while prof.samples == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert capture_for_alert(prof)["samples"] > 0
    prof.stop()
    assert not prof.running and prof.samples > 0
    cold = SamplingProfiler(hz=100.0, max_frames=24)
    assert capture_for_alert(cold)["samples"] == 10 and cold.samples == 0
    assert not PROFILER.running


def test_cold_fetch_parks_at_its_wait_site(tmp_path):
    """The cold store marks its segment read; the sampler sees it."""
    from multiverso_tpu_torch.store import ColdStore
    cs = ColdStore(str(tmp_path / "c"), 2, np.float32, bits=0)
    cs.write_batch(np.array([1], np.int64), np.ones((1, 2), np.float32))
    seen = []
    original = cs._read_segment
    cs._read_segment = lambda seg: (seen.append(current_wait()),
                                    original(seg))[1]
    np.testing.assert_array_equal(cs.fetch(1), [1.0, 1.0])
    assert seen == ["tier_cold_fetch"] and current_wait() is None
    cs.close()


def test_dispatcher_only_contract_enforced_when_asked():
    calls = []

    @contracts.dispatcher_only
    def mutate():
        calls.append(threading.current_thread().name)

    assert mutate.__mv_contract__ == "dispatcher_only"
    assert contracts.slot_free(lambda: None).__mv_contract__ == "slot_free"
    TORCH_FLAGS.reset()
    mvt.init(device="cpu")                 # a live "mv-server" dispatcher
    contracts.set_enforce(True)
    try:
        assert contracts.enforcing()
        with pytest.raises(contracts.ContractViolation):
            mutate()
        # on the dispatcher it runs
        mvt.Zoo.instance().server.run_serialized(mutate)
        assert calls == ["mv-server"]
    finally:
        contracts.set_enforce(False)
        mvt.shutdown()
        TORCH_FLAGS.reset()
    mutate()                               # not enforced: no check
    assert len(calls) == 2


def test_create_sparse_first_in_a_fresh_process(tmp_path):
    """``create_table("sparse", ...)`` needs nothing built before it (the
    kind is registered at import), nor do the tiered kinds and ``kv``
    with ``capacity=``."""
    code = f"""
import json, numpy as np, multiverso_tpu_torch as mvt
mvt.init(device="cpu")
s = mvt.create_table("sparse", 1000, width=2)
s.add([7, 7, 3], np.ones((3, 2), np.float32))
keys, vals = s.get()
t = mvt.create_table("tiered_sparse", 1000, 2, tier_dir={str(tmp_path / 'a')!r})
t.add([1], np.ones((1, 2), np.float32))
k = mvt.create_table("tiered_kv", np.float32, tier_dir={str(tmp_path / 'b')!r})
k.add([5], [2.0])
d = mvt.create_table("kv", np.float32, capacity=64)
d.add([5, 5], [2.0, 1.0])
print(json.dumps([keys.tolist(), vals.tolist(), t.get([1]).tolist(),
                  float(k.get(5)), float(d.get(5))]))
mvt.shutdown()
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == [[3, 7], [[1.0, 1.0], [2.0, 2.0]], [[1.0, 1.0]], 2.0, 3.0]
