"""Child process of the port's remote-serving tests: an off-process worker
or server of ``multiverso_tpu_torch`` (it imports no JAX and needs no
card). Modes:

    adds <endpoint> <table_id> <n_adds> <delta>
        Add ``delta`` everywhere ``n_adds`` times to an array table, check
        its own contribution is visible, exit 0 (the twin of
        ``remote_child.py``).
    crash <endpoint> <table_id>
        One BSP round (Add + Get) on an array table, print
        ``round-1-done <worker_id>``, then die without deregistering (the
        twin of ``remote_crash_child.py``).
    serve
        Serve a 16-float array table, print ``serving <endpoint>
        <table_id>``, sleep until killed (the twin of
        ``server_crash_child.py``).
    sequence <endpoint> <table_id> <seed> <rounds> <out.npy>
        Run :func:`seeded_sequence` on a matrix table and save its Gets.
"""

import os
import sys
import time

import numpy as np

import multiverso_tpu_torch as mvt


def seeded_sequence(table, seed: int, rounds: int, batch: int = 1024):
    """``rounds`` rounds of a ``batch``-row Add (random ids, duplicates
    included, values from a seeded normal) and a ``batch``-row Get on a
    worker proxy of a matrix table; returns the Gets, stacked. The same
    calls on a proxy of either package."""
    rng = np.random.default_rng(seed)
    gets = []
    for _ in range(rounds):
        ids = rng.integers(0, table.num_row, batch).astype(np.int32)
        vals = rng.standard_normal((batch, table.num_col)).astype(np.float32)
        table.add(vals, row_ids=ids)
        gets.append(np.asarray(table.get(
            rng.integers(0, table.num_row, batch).astype(np.int32))))
    return np.stack(gets)


def sequence_mirror(num_row: int, num_col: int, seed: int, rounds: int,
                    batch: int = 1024) -> np.ndarray:
    """The table :func:`seeded_sequence` leaves behind, in float64."""
    rng = np.random.default_rng(seed)
    mirror = np.zeros((num_row, num_col), np.float64)
    for _ in range(rounds):
        ids = rng.integers(0, num_row, batch).astype(np.int32)
        vals = rng.standard_normal((batch, num_col)).astype(np.float32)
        np.add.at(mirror, ids, vals)
        rng.integers(0, num_row, batch)
    return mirror


def main() -> int:
    mode, args = sys.argv[1], sys.argv[2:]
    mvt.set_flag("heartbeat_seconds", 0.0)
    if mode == "serve":
        mvt.init(device="cpu", remote_workers=1)
        table = mvt.create_table("array", 16, np.float32)
        endpoint = mvt.serve("127.0.0.1:0")
        print(f"serving {endpoint} {table.table_id}", flush=True)
        time.sleep(600)  # the parent kills this process long before
        return 1
    client = mvt.remote_connect(args[0])
    table = client.table(int(args[1]))
    if mode == "adds":
        n, delta = int(args[2]), float(args[3])
        for _ in range(n):
            table.add(np.full(table.size, delta, np.float32))
        got = table.get()
        assert got.shape == (table.size,), got.shape
        assert np.all(got >= n * delta - 1e-4), got
    elif mode == "crash":
        table.add(np.ones(table.size, np.float32))
        table.get()
        print(f"round-1-done {client.worker_id}", flush=True)
        os._exit(9)  # no deregister, no finish_train, socket torn down
    elif mode == "sequence":
        np.save(args[4], seeded_sequence(table, int(args[2]), int(args[3])))
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
