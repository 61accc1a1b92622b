"""What every cell shares: the manifest, finding a cell's files by name,
the check of what a run loaded, and the result line.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``. Its files are
found by the names the manifest gives:

* ``configs/<config>.json``: the configuration as it is run, its
  ``kind`` and the limits of the numbers its check compares;
* ``reference/<config>.py``: the plain reference of that configuration;
* ``traffic/<traffic>.json``: the traffic mix, parameters only; its
  ``driver`` names the general driver ``drivers/<driver>.py`` that reads it;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(ctx) -> float | None``.

So a later change adds a configuration, a mix or a metric by adding files
and manifest entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that no run may have loaded: the JAX package the
#: port was made from, and JAX itself. Compared whole, since the port's own
#: name begins with the JAX package's.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "multiverso_tpu"})

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    """Import the file at ``path`` as a module of its own. File names carry
    the manifest's names, dots included, so they are loaded by path."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(path.parents[1])}")
    spec = importlib.util.spec_from_file_location(
        "bench_port_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with its configuration, traffic, driver,
    reference and metrics resolved by name from ``bench``, the benchmark's
    folder (``bench_port/`` or a copy of it)."""

    def __init__(self, manifest: dict, name: str, bench: Path = HERE) -> None:
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the manifest "
                           f"(have: {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        entry = configs[self.workload["config"]]
        with open(bench.parent / entry["file"]) as f:
            self.config = json.load(f)
        with open(bench / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.driver = _module(bench / "drivers" / f"{self.traffic['driver']}.py",
                              "driver_" + self.traffic["driver"])
        self.reference = _module(bench / "reference" / f"{entry['name']}.py",
                                 "reference_" + entry["name"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"] if _reports(
            m, name, self.end_to_end)]
        self.readers = {m["name"]: _module(bench / "metrics" / f"{m['name']}.py",
                                           "metric_" + m["name"]).read
                        for m in self.per_layer}


def _reports(metric: dict, cell: str, end_to_end: List[dict]) -> bool:
    """A per-layer metric is read in the cells it lists, or, listing none,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return any(m["name"] == metric["moves"] for m in end_to_end)


# -- what a run loaded --------------------------------------------------------

def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``modules``) that are in
    :data:`FORBIDDEN_MODULES`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN_MODULES)


# -- the result line ----------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output. ``checks`` comes last: each
    number the correctness check compared, beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """The compared numbers as the last lines of standard error."""
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if c['value'] <= c['limit'] else 'FAILED'})"
            for name, c in checks.items()]


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each compared number beside its limit; a number the check did not
    compute is NaN, within no limit."""
    return {name: {"value": float(numbers.get(name, float("nan"))),
                   "limit": float(limit)} for name, limit in limits.items()}


def all_within(checks: Dict[str, dict]) -> bool:
    """A number is within its limit when it is at most the limit (NaN is
    not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
