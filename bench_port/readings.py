"""The readings that a cell's limits are set from, on the card, many seeds
in one process: the program's sound runs (the lower reading), the control
(the reference put in the program's place in the next lower precision:
bfloat16 tables, or TF32 products) and planted faults (the upper
readings). One JSON line a run on standard output, and in ``--out``.

    python3 bench_port/readings.py --workload matrix.perf_cycle \\
        --systems port,control --seeds 11,12,13 --seconds 20

A matrix cell reads at its own load through a whole window; a training
cell reads its checked steps and needs no window (``--seconds`` 0).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as runner  # sets the caches and the import path first

import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--systems", default="port")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = harness.Cell(harness.load_manifest(runner.ROOT), args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for system in args.systems.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                spec = runner.Spec(cell, seed, args.seconds, False,
                                   system=system, window=args.seconds > 0)
                t0 = time.perf_counter()
                out = runner.run_spec(spec)
                row = {"workload": cell.name, "system": system, "seed": seed,
                       "correct": out["correct"], "numbers": out.get("numbers"),
                       "e2e": out.get("e2e"), "diag": out.get("diag"),
                       "error": out.get("error"),
                       "seconds": time.perf_counter() - t0}
                line = json.dumps(row, default=float)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    found = harness.forbidden_modules()
    if found:
        print(f"readings: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
