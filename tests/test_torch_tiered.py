"""The port's tiered beyond-RAM storage (``multiverso_tpu_torch/store/``)
against the JAX package's.

The cases of ``tests/test_tiered.py`` run on the port; beside them the
same operations go through the JAX package's store and tables, and the
cold segment files, the tier state (hot rows, cold keys) and the
snapshots must be byte-identical. Tiered snapshots load into the plain
sparse and KV tables (the device KV table too) and back. The kill drill
runs on a port twin of the child (``tests/torch_tiered_kill_child.py``):
the port has no wire or WAL yet, so its child snapshots the table before
the Add whose demotion it dies in, and the restart restores that
snapshot and replays the unacknowledged Add."""

import io
import json
import os

# a global MV_TIER_KILL would SIGKILL this process at its first demotion;
# the drill sets it in the child's environment only
os.environ.pop("MV_TIER_KILL", None)

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import multiverso_tpu as mv  # noqa: E402
import multiverso_tpu_torch as mvt  # noqa: E402
from multiverso_tpu import store as jstore  # noqa: E402
from multiverso_tpu.io import MemoryStream  # noqa: E402
from multiverso_tpu.tables import kv_table as jkv  # noqa: E402
from multiverso_tpu.tables import sparse_table as jsparse  # noqa: E402
from multiverso_tpu_torch import convert  # noqa: E402
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS  # noqa: E402
from multiverso_tpu_torch.dashboard import Dashboard  # noqa: E402
from multiverso_tpu_torch.store import (ColdStore, FrequencySketch,  # noqa: E402
                                        TieredStore)
from multiverso_tpu_torch.tables.kv_table import (KVServer,  # noqa: E402
                                                  TieredKVServer)
from multiverso_tpu_torch.tables.sparse_table import (  # noqa: E402
    SparseServer, TieredSparseServer)

_CHILD = Path(__file__).resolve().parent / "torch_tiered_kill_child.py"


@pytest.fixture
def flags():
    TORCH_FLAGS.reset()
    yield
    TORCH_FLAGS.reset()


@pytest.fixture
def both(flags):
    mv.init()
    try:
        mvt.init(device="cpu")
        yield
    finally:
        mvt.shutdown()


def _files(directory):
    """Every file of a spill directory, name -> bytes."""
    return {name: (Path(directory) / name).read_bytes()
            for name in sorted(os.listdir(directory))}


# -- cold store: segment codec, CRC framing, lifecycle ------------------------

def test_coldstore_raw_roundtrip_and_release(tmp_path):
    cs = ColdStore(str(tmp_path / "c"), width=3, dtype=np.float32,
                   bits=0, table_id=7)
    ref = jstore.ColdStore(str(tmp_path / "j"), width=3, dtype=np.float32,
                           bits=0, table_id=7)
    keys = np.array([5, 42, 9_000_000_000], np.int64)
    rows = np.arange(9, dtype=np.float32).reshape(3, 3)
    for store in (cs, ref):
        store.write_batch(keys, rows)
    assert _files(tmp_path / "c") == _files(tmp_path / "j")
    assert len(cs) == 3 and 42 in cs
    np.testing.assert_array_equal(cs.fetch(42), rows[1])
    assert sorted(dict(cs.items())) == sorted(keys.tolist())

    # superseding every key of segment 0 in segment 1 deletes segment 0
    for store in (cs, ref):
        store.write_batch(keys, rows * 2.0)
    assert cs.segment_count == 1
    assert _files(tmp_path / "c") == _files(tmp_path / "j")
    np.testing.assert_array_equal(cs.fetch(5), rows[0] * 2.0)

    # remove drops the key; the segment goes when its last key goes
    cs.remove(5)
    cs.remove(42)
    assert cs.fetch(42) is None and len(cs) == 1
    cs.remove(9_000_000_000)
    assert cs.segment_count == 0 and cs.total_bytes == 0
    cs.close()
    ref.close()


@pytest.mark.parametrize("bits", [8, 4])
def test_coldstore_quantized_segments_smaller_close_and_identical(tmp_path,
                                                                  bits):
    rng = np.random.default_rng(0)
    keys = np.arange(64, dtype=np.int64)
    rows = rng.normal(0, 3, (64, 16)).astype(np.float32)
    raw = ColdStore(str(tmp_path / "raw"), 16, np.float32, bits=0)
    q = ColdStore(str(tmp_path / "q"), 16, np.float32, bits=bits)
    ref = jstore.ColdStore(str(tmp_path / "j"), 16, np.float32, bits=bits)
    raw.write_batch(keys, rows)
    q.write_batch(keys, rows)
    ref.write_batch(keys, rows)
    assert _files(tmp_path / "q") == _files(tmp_path / "j")
    assert q.total_bytes == ref.total_bytes < raw.total_bytes
    step = (rows.max() - rows.min()) / ((1 << bits) - 1)
    for k in (0, 31, 63):
        np.testing.assert_array_equal(raw.fetch(k), rows[k])
        np.testing.assert_allclose(q.fetch(k), rows[k], atol=step)
        np.testing.assert_array_equal(q.fetch(k), ref.fetch(k))
    # the query plane's scan yields the same codes in both packages
    (pk, prow, pq), = list(q.scan_segments())
    (jk, jrow, jq), = list(ref.scan_segments())
    np.testing.assert_array_equal(pk, jk)
    assert prow is None and jrow is None
    for a, b in zip(pq, jq):
        np.testing.assert_array_equal(a, b)
    for store in (raw, q, ref):
        store.close()


def test_coldstore_nonfinite_rows_fall_back_to_raw(tmp_path):
    cs = ColdStore(str(tmp_path / "c"), 4, np.float32, bits=8)
    rows = np.array([[1.0, np.inf, -2.0, np.nan]], np.float32)
    cs.write_batch(np.array([3], np.int64), rows)
    out = cs.fetch(3)
    assert np.isinf(out[1]) and np.isnan(out[3])
    np.testing.assert_array_equal(out[[0, 2]], rows[0][[0, 2]])
    cs.close()


def test_coldstore_wipes_stale_spill_on_init(tmp_path):
    d = str(tmp_path / "c")
    cs = ColdStore(d, 2, np.float32, bits=0)
    cs.write_batch(np.array([1], np.int64), np.ones((1, 2), np.float32))
    cs.close()
    cs2 = ColdStore(d, 2, np.float32, bits=0)
    assert len(cs2) == 0 and cs2.segment_count == 0
    assert not [f for f in os.listdir(d) if f.endswith(".mvcold")]
    cs2.close()


def test_coldstore_crc_mismatch_is_fatal(tmp_path):
    cs = ColdStore(str(tmp_path / "c"), 2, np.float32, bits=0)
    cs.write_batch(np.array([1, 2], np.int64), np.ones((2, 2), np.float32))
    seg = next(p for p in (tmp_path / "c").iterdir()
               if p.suffix == ".mvcold")
    data = bytearray(seg.read_bytes())
    data[-1] ^= 0xFF
    seg.write_bytes(bytes(data))
    with pytest.raises(mvt.log.FatalError, match="CRC"):
        cs.fetch(1)
    cs.close()


# -- admission sketch ---------------------------------------------------------

def test_frequency_sketch_counts_ages_and_hashes_as_jax():
    sk = FrequencySketch(size=1024)
    ref = jstore.FrequencySketch(size=1024)
    for key in (0, 1, 99, 2**40 + 3, 9_000_000_000):
        assert sk._slots(key) == ref._slots(key)
    assert sk.estimate(99) == 0
    sk.touch(99)
    assert sk.estimate(99) == 1
    for _ in range(40):
        sk.touch(99)
    assert sk.estimate(99) == 15  # saturates at 4 bits
    sk._rows >>= 1
    assert sk.estimate(99) == 7


# -- tier policy --------------------------------------------------------------

def _tier(tmp_path, rows_budget=8, width=4, bits=0, admit=2, pkg_store=None,
          sub="tier"):
    cls = (pkg_store or TieredStore)
    return cls(width, np.float32, resident_bytes=rows_budget * width * 4,
               cold_bits=bits, directory=str(tmp_path / sub),
               admit_touches=admit)


def test_tiered_demotes_to_budget_and_serves_both_tiers(tmp_path, flags):
    Dashboard.reset()
    ts = _tier(tmp_path, rows_budget=10)
    ref = _tier(tmp_path, rows_budget=10, pkg_store=jstore.TieredStore,
                sub="jtier")
    for k in range(100):
        for store in (ts, ref):
            store.put(k, np.full(4, float(k), np.float32))
    assert ts.maintain() == ref.maintain() == 90
    assert ts.hot_rows == 10 and ts.cold_rows == 90 and len(ts) == 100
    assert ts.resident_bytes <= ts.budget
    assert sorted(ts._hot) == sorted(ref._hot)
    assert sorted(ts._cold.keys()) == sorted(ref._cold.keys())
    assert _files(tmp_path / "tier") == _files(tmp_path / "jtier")
    for k in (0, 55, 99):
        np.testing.assert_array_equal(ts.get(k), np.full(4, float(k)))
    assert Dashboard.counter_value("TIER_DEMOTIONS") == 90
    assert Dashboard.gauge("TIER_COLD_BYTES").value > 0
    ts.close()
    ref.close()


def test_tiered_lru_picks_untouched_victims(tmp_path, flags):
    ts = _tier(tmp_path, rows_budget=4)
    for k in range(8):
        ts.put(k, np.zeros(4, np.float32))
    for k in (1, 3, 5, 7):
        ts.get(k)
    ts.maintain()
    assert sorted(ts._hot) == [1, 3, 5, 7]
    ts.close()


def test_tiered_admission_blocks_one_shot_scan(tmp_path, flags):
    Dashboard.reset()
    ts = _tier(tmp_path, rows_budget=4, admit=2)
    for k in range(16):
        ts.put(k, np.full(4, float(k), np.float32))
    ts.maintain()
    cold_key = next(k for k in range(16) if k not in ts._hot)
    ts.get(cold_key)  # first touch: served cold, NOT promoted
    assert cold_key not in ts._hot
    assert Dashboard.counter_value("TIER_PROMOTIONS") == 0
    ts.get(cold_key)  # second touch passes admission
    assert cold_key in ts._hot
    assert Dashboard.counter_value("TIER_PROMOTIONS") == 1
    ts.close()


def test_tiered_admission_bar_follows_the_flag_unless_pinned(tmp_path, flags):
    """The flag-derived admission bar stays live through the flag's watch;
    an explicit constructor value stays pinned."""
    live = TieredStore(4, np.float32, resident_bytes=64, cold_bits=0,
                       directory=str(tmp_path / "a"))
    pinned = _tier(tmp_path, admit=3, sub="b")
    assert live.admit == 2
    mvt.set_flag("tier_admit_touches", 5)
    assert live.admit == 5 and pinned.admit == 3
    live.close()
    mvt.set_flag("tier_admit_touches", 7)
    assert live.admit == 5  # close() dropped the watch
    pinned.close()


def test_tiered_add_path_always_promotes(tmp_path, flags):
    ts = _tier(tmp_path, rows_budget=4, admit=100)
    for k in range(16):
        ts.put(k, np.full(4, float(k), np.float32))
    ts.maintain()
    cold_key = next(k for k in range(16) if k not in ts._hot)
    row = ts.get_for_update(cold_key)
    assert cold_key in ts._hot
    row += 1.0
    np.testing.assert_array_equal(ts.get(cold_key),
                                  np.full(4, float(cold_key) + 1.0))
    ts.close()


def test_tiered_quant_integer_grid_survives_demotion_exactly(tmp_path, flags):
    ts = _tier(tmp_path, rows_budget=2, width=8, bits=8)
    rng = np.random.default_rng(1)
    rows = {k: rng.integers(0, 256, 8).astype(np.float32) for k in range(20)}
    rows[0][0], rows[1][0] = 0.0, 255.0  # pin the quant range
    for k, v in rows.items():
        ts.put(k, v)
    ts.maintain()
    assert ts.cold_rows >= 18
    for k, v in rows.items():
        np.testing.assert_array_equal(ts.get(k), v)
    ts.close()


# -- tiered servers: equal to the in-RAM tables and to the JAX package --------

@pytest.mark.parametrize("bits", [0, 8])
def test_tiered_sparse_server_matches_plain_and_jax(tmp_path, flags, bits):
    plain = SparseServer(10_000, width=4)
    tiered = TieredSparseServer(10_000, width=4, resident_bytes=6 * 4 * 4,
                                cold_bits=bits,
                                tier_dir=str(tmp_path / "tier"))
    ref = jsparse.TieredSparseServer(10_000, width=4,
                                     resident_bytes=6 * 4 * 4, cold_bits=bits,
                                     tier_dir=str(tmp_path / "jtier"))
    rng = np.random.default_rng(2)
    for _ in range(30):
        n = int(rng.integers(1, 12))
        keys = rng.integers(0, 10_000, n).astype(np.int64)
        vals = rng.normal(0, 1, (n, 4)).astype(np.float32)
        for srv in (plain, tiered, ref):
            srv.process_add((keys, vals, None))
        probe = rng.integers(0, 10_000, 8).astype(np.int64)
        got = tiered.process_get((probe, None))
        np.testing.assert_array_equal(got, ref.process_get((probe, None)))
        if bits == 0:
            np.testing.assert_array_equal(plain.process_get((probe, None)),
                                          got)
    lk_t, lv_t = tiered.process_get((None, None))
    lk_j, lv_j = ref.process_get((None, None))
    np.testing.assert_array_equal(lk_t, lk_j)
    np.testing.assert_array_equal(lv_t, lv_j)
    if bits == 0:
        lk_p, lv_p = plain.process_get((None, None))
        np.testing.assert_array_equal(lk_p, lk_t)
        np.testing.assert_array_equal(lv_p, lv_t)
    # the same state in both packages: hot rows, cold keys, segment files
    assert tiered.tier_stats() == ref.tier_stats()
    assert tiered.tier_stats()["cold_rows"] > 0  # it really spilled
    assert sorted(tiered._tier._hot) == sorted(ref._tier._hot)
    for k in tiered._tier._hot:
        np.testing.assert_array_equal(tiered._tier._hot[k], ref._tier._hot[k])
    assert _files(tmp_path / "tier") == _files(tmp_path / "jtier")
    tiered._tier.close()
    ref._tier.close()


def test_tiered_kv_server_matches_plain_kv_and_jax(tmp_path, flags):
    plain = KVServer(value_dtype=np.float32)
    tiered = TieredKVServer(value_dtype=np.float32,
                            resident_bytes=4 * 4, cold_bits=0,
                            tier_dir=str(tmp_path / "tier"))
    ref = jkv.TieredKVServer(value_dtype=np.float32, resident_bytes=4 * 4,
                             cold_bits=0, tier_dir=str(tmp_path / "jtier"))
    rng = np.random.default_rng(3)
    for _ in range(25):
        n = int(rng.integers(1, 6))
        keys = rng.integers(0, 200, n).astype(np.int64)
        vals = rng.normal(0, 1, n).astype(np.float32)
        for srv in (plain, tiered, ref):
            srv.process_add((keys, vals, None))
        probe = rng.integers(0, 200, 5).astype(np.int64)
        assert plain.process_get((probe, None)) == \
            tiered.process_get((probe, None)) == ref.process_get((probe, None))
    assert plain.process_get((None, None)) == tiered.process_get((None, None))
    assert tiered.tier_stats() == ref.tier_stats()
    assert tiered.tier_stats()["cold_rows"] > 0
    assert _files(tmp_path / "tier") == _files(tmp_path / "jtier")
    tiered._tier.close()
    ref._tier.close()


def test_tiered_sparse_snapshot_bytes_interchange(tmp_path, flags):
    """store()/load() keep the plain sparse format: the bytes equal the
    JAX tiered table's, and they move between tiered and in-RAM servers
    of either package in both directions."""
    kw = dict(resident_bytes=3 * 2 * 4, cold_bits=0)
    tiered = TieredSparseServer(1000, width=2, tier_dir=str(tmp_path / "a"),
                                **kw)
    ref = jsparse.TieredSparseServer(1000, width=2,
                                     tier_dir=str(tmp_path / "j"), **kw)
    keys = np.arange(0, 900, 90, dtype=np.int64)
    vals = np.arange(20, dtype=np.float32).reshape(10, 2)
    for srv in (tiered, ref):
        srv.process_add((keys, vals, None))
    buf = io.BytesIO()
    tiered.store(buf)
    want = MemoryStream()
    ref.store(want)
    assert buf.getvalue() == want.getvalue()
    plain_bytes = io.BytesIO()
    plain = SparseServer(1000, width=2)
    plain.load(io.BytesIO(buf.getvalue()))
    np.testing.assert_array_equal(plain.process_get((keys, None)), vals)
    plain.store(plain_bytes)
    assert plain_bytes.getvalue() == buf.getvalue()

    tiered2 = TieredSparseServer(1000, width=2, tier_dir=str(tmp_path / "b"),
                                 **kw)
    tiered2.load(io.BytesIO(want.getvalue()))       # the JAX bytes
    np.testing.assert_array_equal(tiered2.process_get((keys, None)), vals)
    assert tiered2.tier_stats()["cold_rows"] > 0    # load re-tiered
    jplain = jsparse.SparseServer(1000, width=2)
    jplain.load(MemoryStream(buf.getvalue()))       # the port's bytes
    np.testing.assert_array_equal(jplain.process_get((keys, None)), vals)
    for srv in (tiered, ref, tiered2):
        srv._tier.close()


def test_tiered_kv_snapshot_bytes_interchange_with_plain_and_device(both,
                                                                    tmp_path):
    kw = dict(resident_bytes=4 * 4, cold_bits=0)
    tiered = mvt.create_table("tiered_kv", np.float32,
                              tier_dir=str(tmp_path / "a"), **kw)
    ref = mv.create_table("tiered_kv", np.float32,
                          tier_dir=str(tmp_path / "j"), **kw)
    keys = [3, 70, 5, 900, 12, 3]
    vals = [1.0, 2.0, 4.0, -1.5, 8.0, 0.25]
    for table in (tiered, ref):
        table.add(keys, vals)
    assert tiered.get() == ref.get() == {3: 1.25, 70: 2.0, 5: 4.0,
                                         900: -1.5, 12: 8.0}
    got = io.BytesIO()
    tiered._server_table.store(got)
    want = MemoryStream()
    ref._server_table.store(want)
    assert got.getvalue() == want.getvalue()
    for target in (mvt.create_table("kv", np.float32),
                   mvt.create_table("kv", np.float32, capacity=64)):
        target._server_table.load(io.BytesIO(got.getvalue()))
        assert target.get() == tiered.get()
        back = io.BytesIO()
        target._server_table.store(back)
        assert back.getvalue() == got.getvalue()
    # a JAX tiered table crosses into a port tiered table through its bytes
    carried = mvt.create_table("tiered_kv", np.float32,
                               tier_dir=str(tmp_path / "b"), **kw)
    convert.load_snapshot(carried, want.getvalue())
    assert carried.get() == ref.get()


def test_tiered_sparse_worker_via_dispatcher(both, tmp_path):
    """The registered ``tiered_sparse`` kind through the dispatcher, and
    the JAX package's on the same Adds: the same Gets and tier state."""
    kw = dict(resident_bytes=8 * 4 * 4, cold_bits=0)
    tables = (mvt.create_table("tiered_sparse", 1_000_000, 4,
                               tier_dir=str(tmp_path / "tier"), **kw),
              mv.create_table("tiered_sparse", 1_000_000, 4,
                              tier_dir=str(tmp_path / "jtier"), **kw))
    keys = np.arange(0, 64_000, 1000, dtype=np.int64)
    vals = np.ones((64, 4), np.float32)
    for t in tables:
        t.add(keys, vals)
        t.add(keys[:5], vals[:5] * 2.0)
        np.testing.assert_array_equal(t.get(keys[:5]),
                                      np.full((5, 4), 3.0, np.float32))
    stats = tables[0]._server_table.tier_stats()
    assert stats == tables[1]._server_table.tier_stats()
    assert stats["hot_rows"] + stats["cold_rows"] == 64
    assert stats["cold_rows"] > 0
    lk, lv = tables[0].get()
    jk, jv = tables[1].get()
    np.testing.assert_array_equal(lk, jk)
    np.testing.assert_array_equal(lv, jv)


# -- kill drill: SIGKILL mid-demotion, restart, restore, exactly once ---------

def _child(args, kill_arm=""):
    repo = str(_CHILD.parent.parent)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("MV_TIER_KILL", None)
    if kill_arm:
        env["MV_TIER_KILL"] = kill_arm
    return subprocess.run([sys.executable, str(_CHILD), *args], env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("arm", ["before_commit", "after_commit"])
def test_tier_kill_mid_demotion_recovers_exactly_once(arm, tmp_path):
    """The child snapshots its 8 acknowledged Adds, then dies by SIGKILL
    inside the segment write that the 9th Add's demotion starts (before
    or after the manifest commit). The restarted child wipes the stale
    spill, restores the snapshot, replays the unacknowledged 9th Add and
    one more: nothing lost, nothing doubled."""
    snap, tier = str(tmp_path / "snap"), str(tmp_path / "tier")
    first = _child([snap, tier], kill_arm=arm)
    assert first.returncode == -9, first.stderr
    assert "acked 8" in first.stdout
    spill = os.listdir(tier)
    assert any(n.endswith(".tmp") or n.endswith(".mvcold") for n in spill)
    second = _child([snap, tier, "--recover"])
    assert second.returncode == 0, second.stderr
    final = np.asarray(json.loads(second.stdout.strip().splitlines()[-1]),
                       np.float32)
    width = 8
    want = np.stack([np.full(width, float(2 ** k), np.float32)
                     for k in range(9)])
    want[0] += 1.0
    np.testing.assert_array_equal(final, want)
