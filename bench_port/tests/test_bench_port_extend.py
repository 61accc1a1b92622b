"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and manifest entries alone: the harness finds them by
name, runs the new cell, and no file that was there changes."""

import hashlib
import json

import harness
import run as runner
from conftest import make_tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_alone_add_a_cell(tmp_path):
    bench = make_tiny(tmp_path)
    before = _digests(bench)
    (bench / "configs" / "ps_matrix_small.json").write_text(json.dumps(dict(
        json.loads((bench / "configs" / "ps_matrix_1m50.json").read_text()),
        name="ps_matrix_small", num_row=5000)))
    (bench / "reference" / "ps_matrix_small.py").write_text(
        "import harness, pathlib\n"
        "_m = harness._module(pathlib.Path(__file__).parent / "
        "'ps_matrix_1m50.py', 'ps_matrix_1m50_shared')\n"
        "Add, Get, PlainTable, check = _m.Add, _m.Get, _m.PlainTable, _m.check\n")
    (bench / "traffic" / "cycle_half.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "perf_cycle.json").read_text()),
        percents=[50])))
    (bench / "metrics" / "requests_per_s.ps.py").write_text(
        "def read(ctx):\n"
        "    return (ctx['gets'] + ctx['acked_adds']) / ctx['window_s'] if ctx.get('window_s') else None\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "ps_matrix_small", "source": "test",
                                "file": "bench_port/configs/ps_matrix_small.json",
                                "reduced": ["num_row"], "why": "test"})
    manifest["workloads"].append({"name": "matrix.hot", "config": "ps_matrix_small",
                                  "traffic": "cycle_half", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if "matrix.perf_cycle" in m.get("workloads", []):
            m["workloads"].append("matrix.hot")
    manifest["per_layer"].append({"name": "requests_per_s.ps", "unit": "1/s",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "worker API", "moves": "ps_gb_per_s",
                                  "workloads": ["matrix.hot"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())  # nothing edited
    cell = harness.Cell(harness.load_manifest(tmp_path), "matrix.hot", bench=bench)
    assert cell.config["num_row"] == 5000 and cell.traffic["percents"] == [50]
    assert "requests_per_s.ps" in cell.readers
    out = runner.run_spec(runner.Spec(cell, 5, 0.5, False, device="cpu"))
    assert out["correct"], out["checks"]
    assert cell.readers["requests_per_s.ps"](out["ctx"]) > 0
