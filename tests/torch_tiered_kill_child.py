"""Child process for the port's MV_TIER_KILL drill: a tiered-sparse table
of ``multiverso_tpu_torch`` on the CPU (the port's twin of
``tiered_kill_child.py``; the port has no wire or WAL yet, so the drill
runs in this one process and its durable state is a snapshot).

Usage: python torch_tiered_kill_child.py <snapshot_file> <tier_dir> [--recover]

First run: 8 Adds fill the hot tier exactly, the table is snapshotted
(``checkpoint.store_table``) and ``acked 8`` printed; the 9th Add
overflows the budget, and its demotion's segment write SIGKILLs the
process when the parent exported ``MV_TIER_KILL=before_commit`` or
``after_commit``. With ``--recover``: the table is created again (its
cold store wipes the stale spill), the snapshot restored, the
unacknowledged 9th Add replayed and one more Add made; the final rows
are printed as one JSON line."""

import json
import sys

import numpy as np

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import checkpoint

#: Eight float32 rows of width 8 fit the hot tier; the ninth Add demotes.
RESIDENT_BYTES = 8 * 8 * 4
WIDTH = 8


def main() -> int:
    snapshot, tier_dir = sys.argv[1], sys.argv[2]
    mvt.init(device="cpu")
    # cold_bits=0 (raw): exact float equality survives a demote/fetch
    table = mvt.create_table("tiered_sparse", 1 << 20, WIDTH, np.float32,
                             resident_bytes=RESIDENT_BYTES, cold_bits=0,
                             tier_dir=tier_dir)
    row = lambda value: np.full((1, WIDTH), value, np.float32)  # noqa: E731
    if "--recover" not in sys.argv[3:]:
        for k in range(8):
            table.add([k * 1000], row(float(2 ** k)))
        checkpoint.store_table(table, snapshot)
        print("acked 8", flush=True)
        table.add([8000], row(256.0))  # killed inside its demotion
        mvt.shutdown()
        return 1
    checkpoint.load_table(table, snapshot)
    table.add([8000], row(256.0))      # the Add that was never acknowledged
    table.add([0], row(1.0))
    final = table.get([k * 1000 for k in range(9)])
    print(json.dumps(np.asarray(final).tolist()), flush=True)
    mvt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
