"""On the card, at the cells' own sizes: each cell's command prints a
correct result line, and each cell's control comes out not correct.
Skipped where there is no card (the ``card`` fixture decides)."""

import json
import subprocess
import sys

import pytest

import harness
import run as runner
from conftest import ROOT

WORKLOADS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_command_prints_a_correct_result(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", workload,
         "--seed", "4242424242", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["kind"] == card and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_at_the_cells_size_fails(card, workload):
    cell = harness.Cell(harness.load_manifest(ROOT), workload)
    seconds = 3.0 if cell.config["kind"] == "matrix" else 0.0
    out = runner.run_spec(runner.Spec(cell, 777, seconds, False,
                                      system="control", window=seconds > 0))
    assert not out["correct"], out["checks"]
