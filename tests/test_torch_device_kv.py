"""The port's device-resident hash KV table against the JAX package's.

The same seeded batches go through ``create_table("kv", dtype,
capacity=N)`` in both packages (the JAX table on the 8 virtual CPU
devices, so 8 shards; the port's on the CPU, one shard). Slot layouts
differ by design (shard count, and which of several lanes claiming one
slot lands), so the tests hold what the contract promises: the key ->
value map (``get()``, ``process_get((None, None))``), point Gets, the
live count and the checkpoint bytes, all exactly. Values are counts or
integers, exact in float32 in any summation order."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as mv
import multiverso_tpu_torch as mvt
from multiverso_tpu.io import MemoryStream
from multiverso_tpu.ops import device_hash as jax_hash
from multiverso_tpu_torch import convert
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS
from multiverso_tpu_torch.ops import device_hash as torch_hash
from multiverso_tpu_torch.parallel import mesh


@pytest.fixture
def both():
    TORCH_FLAGS.reset()
    mv.init()
    try:
        mvt.init(device="cpu")
        yield
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def _pair(dtype, capacity):
    return (mv.create_table("kv", dtype, capacity=capacity),
            mvt.create_table("kv", dtype, capacity=capacity))


def _same_map(jt, tt):
    want, got = jt.get(), tt.get()
    assert got == want
    return got


def test_device_kv_add_get(both):
    for table in _pair(np.float32, 4096):
        table.add([0, 17, 123456], [1.0, 2.0, 3.0])
        assert [float(v) for v in table.get([0, 17, 123456])] == [1.0, 2.0, 3.0]
        table.add([17], [10.0])
        assert float(table.get(17)) == 12.0
        assert float(table.get(424242)) == 0.0  # missing key -> zero
    _same_map(*_pair(np.float32, 64))


def test_device_kv_placement_is_key_mod_num_shards(both):
    """The placement contract in the shard key arrays: shard s holds the
    keys with key % num_shards == s. The port has one shard a device."""
    _jt, table = _pair(np.int32, 1024)
    server = table._server_table
    assert server.num_shards == mesh.table_shards() == 1
    keys = np.arange(0, 999, 7)
    table.add(keys, np.ones(len(keys), np.int32))
    stored = server.keys[:, :-1].numpy()
    for s in range(server.num_shards):
        live = stored[s][stored[s] >= 0]
        assert np.all(live % server.num_shards == s)
    assert int((stored >= 0).sum()) == len(keys) == server._live
    # the scratch slots are left EMPTY and 0 after every call
    assert (server.keys[:, -1] == torch_hash.EMPTY).all()
    assert (server.values[:, -1] == 0).all()


def test_device_kv_duplicate_keys_in_one_add(both):
    jt, tt = _pair(np.float32, 512)
    for table in (jt, tt):
        table.add([9, 9, 9, 4], [1.0, 2.0, 3.0, 0.5])
        assert float(table.get(9)) == 6.0
        assert float(table.get(4)) == 0.5
    assert _same_map(jt, tt) == {9: 6.0, 4: 0.5}


def test_device_kv_whole_get_and_store_load_bytes(both):
    jt, tt = _pair(np.float32, 512)
    for table in (jt, tt):
        table.add([5, 900, 31, 2_000_000_000], [1.0, 4.0, 2.0, -3.5])
    assert _same_map(jt, tt) == {5: 1.0, 900: 4.0, 31: 2.0,
                                 2_000_000_000: -3.5}
    want = MemoryStream()
    jt._server_table.store(want)
    got = io.BytesIO()
    tt._server_table.store(got)
    assert got.getvalue() == want.getvalue()
    # the JAX bytes load into the port, the port's into the JAX package
    port2 = mvt.create_table("kv", np.float32, capacity=64)
    port2._server_table.load(io.BytesIO(want.getvalue()))
    jax2 = mv.create_table("kv", np.float32, capacity=64)
    jax2._server_table.load(MemoryStream(got.getvalue()))
    assert port2.get() == jax2.get() == tt.get()
    # a snapshot larger than the table's capacity grows it on load
    assert port2._server_table.capacity >= 64
    # and the device table's bytes are the host KV table's
    host = mvt.create_table("kv", np.float32)
    host._server_table.load(io.BytesIO(got.getvalue()))
    assert host.get() == tt.get()


def test_device_kv_lightlda_stress_matches_jax(both):
    """The lightLDA-shaped stress: a skewed (zipf) key space and repeated
    batched Adds; exact counts survive hashing, shards and claims."""
    rng = np.random.default_rng(0)
    n_keys = 20_000
    jt, tt = _pair(np.float32, 2 * n_keys)
    expected = np.zeros(n_keys, np.float64)
    for _ in range(4):
        batch = (rng.zipf(1.3, size=4000) % n_keys).astype(np.int64)
        for table in (jt, tt):
            table.add(batch, np.ones(len(batch), np.float32))
        np.add.at(expected, batch, 1.0)
    check = np.concatenate([np.arange(500),
                            rng.choice(n_keys, 500, replace=False)])
    got = np.asarray(tt.get(list(check)), np.float64)
    np.testing.assert_array_equal(got, expected[check])
    assert np.asarray(jt.get(list(check)), np.float64).tolist() == got.tolist()
    live = _same_map(jt, tt)
    assert len(live) == tt._server_table._live == int((expected > 0).sum())


def test_device_kv_grows_past_initial_capacity(both):
    """Rebuild-and-replay: far more keys than the first capacity, every
    value exact through every rebuild (int32)."""
    jt, tt = _pair(np.int32, 128)
    server = tt._server_table
    cap0 = server.capacity
    rng = np.random.default_rng(7)
    want = {}
    for _ in range(6):
        ks = rng.choice(5000, size=300, replace=False).astype(np.int64)
        vs = rng.integers(1, 100, size=300).astype(np.int32)
        for table in (jt, tt):
            table.add(ks, vs)
        for k, v in zip(ks, vs):
            want[int(k)] = want.get(int(k), 0) + int(v)
    assert server.capacity > cap0 and server.rebuilds > 0
    assert len(want) > cap0
    got = tt.get(sorted(want))
    assert [int(x) for x in got] == [want[k] for k in sorted(want)]
    dump = _same_map(jt, tt)
    assert {int(k): int(v) for k, v in dump.items()} == want
    assert server._live == len(want)


def test_device_kv_grow_preserves_accumulation_semantics(both):
    jt, tt = _pair(np.float32, 64)
    for table in (jt, tt):
        table.add([1, 2, 3], [1.0, 2.0, 3.0])
        table.add(list(range(10, 400)), [0.5] * 390)   # forces growth
        table.add([1, 2, 3], [10.0, 20.0, 30.0])
        assert table.get([1, 2, 3]) == [11.0, 22.0, 33.0]
    _same_map(jt, tt)


def test_device_kv_steady_state_does_not_grow_unboundedly(both):
    jt, tt = _pair(np.int32, 256)
    keys = list(range(100))
    for _ in range(40):
        for table in (jt, tt):
            table.add(keys, [1] * 100)
    assert tt._server_table.capacity <= 1024
    assert tt.get([0, 50, 99]) == [40, 40, 40]
    _same_map(jt, tt)


def test_device_kv_rejects_bad_keys_and_dtypes(both):
    table = mvt.create_table("kv", np.float32, capacity=64)
    with pytest.raises(mvt.log.FatalError, match=">= 0"):
        table._server_table.process_add(([-1], [1.0], None))
    with pytest.raises(mvt.log.FatalError, match="int32"):
        table._server_table.process_add(([1 << 31], [1.0], None))
    with pytest.raises(mvt.log.FatalError, match="float32/int32"):
        mvt.create_table("kv", np.float64, capacity=64)


# -- the hash itself ------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 1 << 20, 1 << 31])
def test_probe_slot_sequence_matches_jax(capacity):
    """Unsigned 32-bit hashing computed in int64: the same slot for every
    probe, for keys up to 2^31-1 (and the -1 pad)."""
    rng = np.random.default_rng(capacity % 9973)
    keys = np.concatenate([[0, 1, 2, (1 << 31) - 1, (1 << 31) - 2, -1],
                           rng.integers(0, 1 << 31, 4000)]).astype(np.int32)
    for p in range(torch_hash.MAX_PROBE):
        want = np.asarray(jax_hash._probe_slot(jnp.asarray(keys), p, capacity))
        got = torch_hash.probe_slot(torch.from_numpy(keys), p, capacity)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _jax_add(keys, values, bk, bv, capacity):
    k2, v2, ovf, ins = jax_hash.hash_add(jnp.asarray(keys), jnp.asarray(values),
                                         jnp.asarray(bk), jnp.asarray(bv),
                                         capacity)
    return np.asarray(k2), np.asarray(v2), np.asarray(ovf), int(ins)


def _slot_map(keys, values):
    live = keys[:-1] >= 0
    return dict(zip(keys[:-1][live].tolist(), values[:-1][live].tolist()))


def test_hash_add_overflow_flags_match_jax():
    """A 16-slot table and 24 unique keys: at least 8 lanes exhaust their
    probes. The flags, the inserted count, the slots and the map equal
    the JAX package's (on the CPU both let the last of several claiming
    lanes land); a flagged lane's value is not applied, and re-inserting
    the flagged lanes into a larger table is lossless."""
    capacity = 16
    rng = np.random.default_rng(3)
    bk = rng.choice(1 << 20, 24, replace=False).astype(np.int32)
    bv = np.arange(1, 25, dtype=np.float32)
    keys0 = np.full(capacity + 1, -1, np.int32)
    vals0 = np.zeros(capacity + 1, np.float32)
    jk, jv, jovf, jins = _jax_add(keys0, vals0, bk, bv, capacity)
    tk, tv = torch.from_numpy(keys0.copy()), torch.from_numpy(vals0.copy())
    tovf, tins = torch_hash.hash_add(tk, tv, torch.from_numpy(bk),
                                     torch.from_numpy(bv), capacity)
    np.testing.assert_array_equal(tovf.numpy(), jovf)
    assert int(tins) == jins == len(bk) - int(jovf.sum())
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tv.numpy(), jv)
    placed = _slot_map(tk.numpy(), tv.numpy())
    assert placed == {int(k): float(v) for k, v, f in zip(bk, bv, jovf) if not f}
    assert tk[capacity] == -1 and tv[capacity] == 0
    # re-insert the flagged lanes after a rebuild: nothing lost
    assert jovf.sum() >= len(bk) - capacity
    if jovf.any():
        big = 256
        keys1 = torch.full((big + 1,), -1, dtype=torch.int32)
        vals1 = torch.zeros(big + 1)
        pk = torch.tensor(list(placed), dtype=torch.int32)
        pv = torch.tensor(list(placed.values()))
        torch_hash.hash_add(keys1, vals1, pk, pv, big)
        flagged = torch.from_numpy(jovf.copy())
        ovf2, _ = torch_hash.hash_add(keys1, vals1, torch.from_numpy(bk)[flagged],
                                      torch.from_numpy(bv)[flagged], big)
        assert not ovf2.any()
        assert _slot_map(keys1.numpy(), vals1.numpy()) == {
            int(k): float(v) for k, v in zip(bk, bv)}


def test_hash_get_matches_jax_and_reads_missing_as_zero():
    capacity = 256
    rng = np.random.default_rng(5)
    bk = rng.choice(1 << 30, 100, replace=False).astype(np.int32)
    bv = rng.integers(1, 50, 100).astype(np.int32)
    jk, jv, _, _ = _jax_add(np.full(capacity + 1, -1, np.int32),
                            np.zeros(capacity + 1, np.int32), bk, bv, capacity)
    tk = torch.full((capacity + 1,), -1, dtype=torch.int32)
    tv = torch.zeros(capacity + 1, dtype=torch.int32)
    torch_hash.hash_add(tk, tv, torch.from_numpy(bk), torch.from_numpy(bv),
                        capacity)
    probe = np.concatenate([bk[::3], [-1, 7, 123456789]]).astype(np.int32)
    want = np.asarray(jax_hash.hash_get(jnp.asarray(jk), jnp.asarray(jv),
                                        jnp.asarray(probe), capacity))
    got = torch_hash.hash_get(tk, tv, torch.from_numpy(probe), capacity)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-3:].tolist() == [0, 0, 0]


# -- carrying a JAX table across ------------------------------------------------

def test_convert_carries_device_kv_by_replay(both):
    """The JAX table's 8 shards and the port's one hold different slot
    layouts, so the live map crosses by replay; the next Add then gives
    the same map in both packages."""
    rng = np.random.default_rng(11)
    jt = mv.create_table("kv", np.float32, capacity=128)
    for _ in range(3):
        ks = rng.integers(0, 10_000, 200)
        jt.add(ks, np.ones(len(ks), np.float32))
    tt = mvt.create_table("kv", np.float32, capacity=64)
    tt.add([1, 2], [5.0, 5.0])  # replaced, not merged
    convert.load_device_kv_state(tt, jt.get())
    assert tt.get() == jt.get()
    assert tt._server_table._live == len(jt.get())
    ks = rng.integers(0, 10_000, 300)
    for table in (jt, tt):
        table.add(ks, np.full(len(ks), 2.0, np.float32))
    _same_map(jt, tt)
