"""The port's multi-process lockstep PS: failure detection, adjudication,
named transactions, the replicated KV table, model averaging, the SSP
contract and wire clients, as ``tests/test_multihost.py`` drives them in
the JAX package. The scenarios below run in the port's ranks through the
runner in ``test_torch_multihost.py``; their checks hold the contracts
``tests/multihost_child.py`` asserts, against numpy oracles."""

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def run_kv(mv, rank, world, ctx):
    """The device KV table across processes: every rank keeps a whole
    replica and replays the same Adds, growth included. The key->value
    map and the live count are held, not the slot layout."""
    kv = mv.create_table("kv", np.int32, capacity=64)  # small: forces growth
    # the declared capacity, not the replica's: another rank's Add may
    # already have grown this rank's replica when it would be read
    cap0 = n_keys = 64
    with mv.worker(0):
        # overlapping keys accumulate across ranks
        kv.add(list(range(n_keys)), [rank + 1] * n_keys)
    mv.process_barrier()
    want = sum(range(1, world + 1))
    with mv.worker(0):
        got = kv.get(list(range(n_keys)))
    assert [int(x) for x in got] == [want] * n_keys, (got, want)
    server = kv._server_table
    assert server.capacity > cap0, f"never grew past {cap0}"
    assert server._live == n_keys, server._live
    mv.process_barrier()


def run_ma(mv, rank, world, ctx):
    """Model averaging (``ma=True``: no PS) across processes: aggregate
    hands EVERY worker on EVERY rank the all-workers sum, for host arrays,
    host leaf lists and tensors (back on their device)."""
    import torch
    workers = 2 * world
    results, errors = {}, []

    def work(slot):
        try:
            with mv.worker(slot):
                wid = rank * 2 + slot
                r1 = mv.aggregate(np.ones(8, np.float32))
                r2 = mv.aggregate([np.full(3, float(wid + 1), np.float32),
                                   np.ones((2, 2), np.float32)])
                r3 = mv.aggregate(torch.full((4,), float(wid + 1)))
                results[slot] = (r1, r2, r3)
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(s,)) for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "aggregate worker hung"
    wid_sum = float(sum(range(1, workers + 1)))
    for slot in range(2):
        r1, r2, r3 = results[slot]
        np.testing.assert_array_equal(r1, np.full(8, float(workers)))
        np.testing.assert_array_equal(r2[0], np.full(3, wid_sum))
        np.testing.assert_array_equal(r2[1], np.full((2, 2), float(workers)))
        assert isinstance(r3, torch.Tensor), type(r3)  # device in, device out
        np.testing.assert_array_equal(r3.numpy(), np.full(4, wid_sum))
    mv.process_barrier()


def run_remote(mv, rank, world, ctx):
    """A row-split table ALSO served to an off-world client over TCP from
    the leader: the ranks' workers and the wire client hit one lockstep
    dispatcher and see each other's Adds."""
    rows, cols = 24, 6
    expect = sum(range(1, world + 1)) + 10.0
    mat = mv.create_table("matrix", num_row=rows, num_col=cols)
    with mv.worker(0):
        mat.add(np.full((rows, cols), float(rank + 1), np.float32))
    mv.process_barrier()
    if rank == 0:
        endpoint = mv.serve("127.0.0.1:0")
        client = mv.remote_connect(endpoint)
        rt = client.table(mat.table_id)
        rt.add(np.full((rows, cols), 10.0, np.float32))
        got = np.asarray(rt.get())
        client.close()
        np.testing.assert_array_equal(got, expect)
    mv.process_barrier()
    with mv.worker(0):
        got = mat.get()
    np.testing.assert_array_equal(got, np.full((rows, cols), expect))
    mv.process_barrier()


def _until_loud(op, fail_marker):
    """Keep running ``op`` (each attempt on its own watchdogged thread)
    until it raises, and return the error; a hung attempt or no error
    before the deadline prints ``fail_marker`` and exits 1."""
    from multiverso_tpu_torch import config
    loud_bound = float(config.get_flag("multihost_timeout")) + 30.0
    deadline = time.monotonic() + loud_bound + 60.0
    while time.monotonic() < deadline:
        outcome = {}

        def attempt():
            try:
                op()
                outcome["ok"] = True
            except BaseException as exc:  # noqa: BLE001 — loud = pass
                outcome["exc"] = exc

        t = threading.Thread(target=attempt, daemon=True)
        t.start()
        t.join(timeout=loud_bound)
        if t.is_alive():
            print(f"{fail_marker} (op hung)", flush=True)
            os._exit(1)
        if "exc" in outcome:
            return outcome["exc"]
        time.sleep(0.5)
    print(f"{fail_marker} (no error before deadline)", flush=True)
    os._exit(1)


def run_crash(mv, rank, world, ctx):
    """Rank 1 dies abruptly mid-run; the leader's next collective fails
    LOUDLY within the bound instead of hanging."""
    mat = mv.create_table("matrix", num_row=16, num_col=4)
    with mv.worker(0):
        mat.add(np.ones((16, 4), np.float32))
        mat.get()
    mv.process_barrier()
    if rank == 1:
        os._exit(42)  # simulated host failure: no goodbye, no cleanup

    def op():
        with mv.worker(0):
            mat.add(np.ones((16, 4), np.float32))
            mat.get()

    exc = _until_loud(op, "LEADER_DID_NOT_DETECT_FAILURE")
    print(f"LEADER_DETECTED_FAILURE {type(exc).__name__}", flush=True)
    os._exit(0)


def run_leadercrash(mv, rank, world, ctx):
    """Rank 0 dies abruptly: every follower fails LOUDLY within the
    control-plane bound (the replay loop poisons the rank on the leader
    socket's EOF), and its teardown still runs. The leader dies right
    after releasing the barrier, so a follower may see the death in the
    barrier itself (the release frame not yet sent) or in its next op:
    both are loud."""
    mat = mv.create_table("matrix", num_row=16, num_col=4)
    with mv.worker(0):
        mat.add(np.ones((16, 4), np.float32))
        mat.get()
    try:
        mv.process_barrier()
        exc = None
    except mv.log.FatalError as err:
        exc = err
    if rank == 0:
        os._exit(42)  # simulated leader failure: no goodbye

    def op():
        with mv.worker(0):
            mat.add(np.ones((16, 4), np.float32))
            mat.get()

    if exc is None:
        exc = _until_loud(op, "FOLLOWER_DID_NOT_DETECT_LEADER_DEATH")
    mv.shutdown()  # teardown on a poisoned rank must not raise
    print(f"FOLLOWER_DETECTED_LEADER_DEATH {type(exc).__name__}", flush=True)
    os._exit(0)


def run_flagmismatch(mv, rank, world, ctx):
    # unreachable: init must already have failed on the divergent flag
    raise AssertionError("flag-mismatch world initialized despite a "
                         "divergent sync flag")


def run_badreq(mv, rank, world, ctx):
    """A malformed Add fails ONLY its caller: every rank rejects it, the
    leader absolves the followers' divergence reports, and later traffic
    lands exactly on every rank's rows."""
    mat = mv.create_table("matrix", num_row=16, num_col=4)
    with mv.worker(0):
        mat.add(np.ones((16, 4), np.float32))
    mv.process_barrier()
    if rank == world - 1:  # a FOLLOWER sends the malformed add
        with mv.worker(0):
            try:
                mat.add(np.ones((2, 4), np.float32))  # wrong whole-table
                raise AssertionError("malformed add did not raise")
            except AssertionError:
                raise
            except Exception:
                pass  # the caller gets the failure; the world survives
    mv.process_barrier()
    with mv.worker(0):
        mat.add(np.ones((16, 4), np.float32))
    mv.process_barrier()
    with mv.worker(0):
        got = mat.get()
    np.testing.assert_array_equal(
        got, np.full((16, 4), 2.0 * world, np.float32),
        err_msg="table corrupted or a rank was wrongly poisoned")
    mv.process_barrier()


def run_namedtxn(mv, rank, world, ctx):
    """A registered two-table program submitted from a FOLLOWER updates
    every rank's rows exactly, and the origin gets the reply its own
    replay computed. In a multi-process world a program sees each rank's
    row shard: it maps the logical ids through ``own_rows`` and reads
    rows through ``candidate_rows`` (the exchange). Raw closures are still
    rejected."""
    import torch
    rows, cols = 16, 8
    a = mv.create_table("matrix", num_row=rows, num_col=cols)
    b = mv.create_table("matrix", num_row=rows, num_col=cols)
    sa = a._server_table._unwrapped()
    sb = b._server_table._unwrapped()

    def fused(datas, states, ids, scale):
        da, db = datas
        _, local = sa.own_rows(ids)
        idx = torch.as_tensor(local, dtype=torch.long)
        da[idx, :cols] += scale
        db[idx, :cols] += 2.0 * scale
        reply = (sa.candidate_rows(ids)[:, :cols]
                 + sb.candidate_rows(ids)[:, :cols]).sum()
        return [da, db], states, reply

    mv.register_program("test.fused_pair", fused)
    ids = np.array([0, 3, 9, 15], dtype=np.int32)  # on both ranks' shards
    if rank == world - 1:  # follower origin: the full lockstep round
        with mv.worker(0):
            h = a.transact_device_async("test.fused_pair", [b],
                                        args=(ids, 2.5))
            reply = a.wait(h)
        assert isinstance(reply, torch.Tensor), type(reply)
        assert float(reply) == 4 * cols * 7.5, float(reply)
    mv.process_barrier()
    with mv.worker(0):
        got_a, got_b = a.get(), b.get()
    expect_a = np.zeros((rows, cols), np.float32)
    expect_a[ids] = 2.5
    np.testing.assert_array_equal(got_a, expect_a)
    np.testing.assert_array_equal(got_b, 2.0 * expect_a)
    mv.process_barrier()
    with mv.worker(0):
        try:
            a.transact_device_async(lambda d, s: (d, s, None), [b])
            raise AssertionError("raw closure transact did not fail")
        except AssertionError:
            raise
        except Exception:
            pass
    mv.process_barrier()


SCENARIOS = {"kv": run_kv, "ma": run_ma, "remote": run_remote,
             "crash": run_crash, "leadercrash": run_leadercrash,
             "flagmismatch": run_flagmismatch, "badreq": run_badreq,
             "namedtxn": run_namedtxn}


# -- the tests ----------------------------------------------------------------

from test_torch_multihost import port_world  # noqa: E402


def test_multihost_follower_crash_detected_loudly():
    """A follower dying mid-run surfaces as a bounded-time loud error on
    the leader, not a silent hang; the dead rank exits 42 by design."""
    port_world("crash", timeout=480,
               expect={0: (0, "LEADER_DETECTED_FAILURE"), 1: (42, None)})


def test_multihost_leader_crash_detected_loudly():
    """Rank 0 dying mid-run surfaces LOUDLY on every follower within the
    control-plane bound."""
    port_world("leadercrash", timeout=480,
               expect={0: (42, None),
                       1: (0, "FOLLOWER_DETECTED_LEADER_DEATH")})


def test_multihost_flag_mismatch_fatal_at_bringup():
    """Rank 1 runs sync=True against an async leader: a LOUD bring-up
    error naming the flag (the handshake carries a flag digest)."""
    port_world("flagmismatch",
               expect={0: (1, "flag mismatch"), 1: (1, None)})


def test_multihost_bad_request_fails_caller_not_world():
    """A malformed add raises on its caller and leaves the world healthy."""
    port_world("badreq")


def test_multihost_named_device_transaction_exact():
    """A follower-origin two-table named program updates every rank's
    rows exactly; the origin gets its replay's reply; closures refused."""
    port_world("namedtxn")


def test_multihost_device_kv_with_growth():
    """The device KV table across processes: replicated, growth in
    lockstep, the same map and live count on every rank."""
    port_world("kv")


def test_multihost_ssp_staleness_contract():
    """SSP bounded staleness across two processes: the leader's clocks
    gate forwarded Gets like in-process ones."""
    port_world("ssp")


def test_multihost_model_averaging_aggregate():
    """MA mode across 2 processes x 2 workers: aggregate returns the
    all-workers sum on every rank for all three value shapes."""
    port_world("ma")


def test_multihost_with_offmesh_remote_client():
    """A row-split table served to a wire client from the leader: ranks'
    workers and the client all see each other's Adds."""
    port_world("remote")
