"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, driver,
reference and per-layer readers are found by the names in
``BENCHMARK.json`` (``harness.Cell``). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from the same
window and a profiled sub-window after it. Every run checks what the
timed path produced against the plain reference and prints each number
compared beside its limit, last on standard error and last in the result.

Exit codes: 0 with a result; 2 without a card (or too few) or without the
cell; 3 when JAX or the JAX package was loaded; anything else is an error.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The host clock (``perf_counter``) at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = HERE / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import argparse  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import List, Optional, Tuple  # noqa: E402

import harness  # noqa: E402
import peaks  # noqa: E402


@dataclass
class Spec:
    """One run of a cell. ``system`` is ``port`` for the program; the
    readings put the reference in its place as ``control`` (the lower
    precision: bfloat16 tables, TF32 products) or as a planted fault
    (``half``). ``window`` False makes only the check's readings (training
    cells)."""
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    system: str = "port"
    window: bool = True


def run_spec(spec: Spec) -> dict:
    """Drive the cell and check it: the driver's outcome with the compared
    numbers beside their limits (``checks``) and ``correct``."""
    out = spec.cell.driver.run(spec)
    out["checks"] = harness.judge(out.get("numbers") or {},
                                  spec.cell.config["limits"])
    out["correct"] = not out["failed"] and harness.all_within(out["checks"])
    return out


def result(spec: Spec, out: dict, power_w: Optional[float]
           ) -> Tuple[str, List[str]]:
    """(the result line, the lines that end standard error)."""
    import torch
    cell = spec.cell
    metrics = {}
    if spec.trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]](out.get("ctx", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out.get("e2e", {}),
                   setup_s=out["window_start"] - PROCESS_START)
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit_w": power_w}
    breakdown = None
    if spec.trace and "trace" in out:
        device.update(busy_s=out["trace"]["busy_s"],
                      window_s=out["trace"]["window_s"])
        breakdown = {k: out["trace"][k] for k in ("device_ops", "idle_gaps")}
    line = harness.result_line(out["correct"], out["attempted"], out["failed"],
                               metrics, device, out["checks"], breakdown)
    err = [f"diag {k}: {v!r}" for k, v in out.get("diag", {}).items()]
    if out.get("error"):
        err.append(f"error: {out['error']}")
    return line, err + harness.check_lines(out["checks"])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = harness.Cell(harness.load_manifest(ROOT), args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"run.py: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    power_w = peaks.power_limit_w()
    spec = Spec(cell, args.seed, args.seconds, bool(args.trace))
    out = run_spec(spec)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}, which the port must not use",
              file=sys.stderr)
        return 3
    line, err = result(spec, out, power_w)
    print(line, flush=True)
    for text in err:
        print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
