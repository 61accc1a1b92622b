"""Nothing the command reaches loads JAX or the JAX package: checked on the
modules a whole run loaded, by top-level name compared whole (the port's
own name begins with the JAX package's)."""

import subprocess
import sys

import harness
from conftest import BENCH, ROOT

SCRIPT = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import conftest, harness, run as runner
from pathlib import Path
import tempfile
tiny = conftest.make_tiny(Path(tempfile.mkdtemp()))
manifest = harness.load_manifest(tiny.parent)
for w in manifest["workloads"]:
    cell = harness.Cell(manifest, w["name"], bench=tiny)
    out = runner.run_spec(runner.Spec(cell, 7, 0.5, True, device="cpu"))
    assert out["correct"], (w["name"], out["checks"])
    for m in cell.per_layer:
        cell.readers[m["name"]](out.get("ctx", {{}}))
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(
        ["multiverso_tpu_torch", "multiverso_tpu_torch.tables", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "multiverso_tpu.ops", "flax"]) == [
        "flax", "jax", "multiverso_tpu"]


def test_a_whole_run_loads_no_jax(tmp_path):
    """Every cell, traced, at test size on the CPU, in a fresh process."""
    code = SCRIPT.format(bench=str(BENCH), root=str(ROOT),
                         tests=str(BENCH / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = eval(proc.stdout.strip().splitlines()[-1])
    assert "multiverso_tpu_torch" in loaded
    assert not set(loaded) & harness.FORBIDDEN_MODULES


def test_the_command_needs_the_port(tmp_path):
    """In a directory holding only the manifest and the benchmark, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                           "matrix.perf_cycle", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
