"""``BENCHMARK.json`` against the benchmark's contract: names, units, keys,
bounds, and every cell reporting what its metrics move."""

import json
import re

import pytest

from conftest import BENCH, ROOT
import harness

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|"
                   r"head|expansion|experts_per_tok|num_col|dim$")


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert MANIFEST["paths"] == ["bench_port"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            extra = set(entry) - KEYS[section]
            assert not extra, (section, entry["name"], extra)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_text(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert harness.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert harness.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_configs_files_and_reductions():
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench_port/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == data["source"][:200]
        assert data["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
        assert data["limits"], "a configuration states the limits it is held to"


def test_cells_resolve_and_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MANIFEST["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4)
        cell = harness.Cell(MANIFEST, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in reported, (w["name"], m["name"])


def test_per_layer_layers_and_moves():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "mfu" in m["name"] or m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_check_budget_fits():
    """Every later check runs 2 + 14 runs a cell for 24 cells within its
    allowance; the run length may not grow past what that leaves."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
