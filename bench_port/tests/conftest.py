"""Fixtures of the benchmark's own tests: a copy of the benchmark with the
configurations cut to a size the CPU runs in seconds, and the ``card``
marker for tests that need the card (they decide inside a fixture).

Run from the repository root: ``python -m pytest bench_port/tests -q``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The configurations and mixes at test size: every width and shape as
#: the cells have them, only the rows, the vocabulary and the windows cut.
TINY_CONFIG = {
    "ps_matrix_1m50": {"num_row": 20000},
    "w2v_gnews_300": {"vocab_size": 2000, "dim": 16, "block_tokens": 1024,
                      "batch_pairs": 4096},
}
TINY_TRAFFIC = {
    "perf_cycle": {"warmup_cycles": 2, "get_sample": 2, "trace_seconds": 1},
    "corpus_ps": {"stream_block": 1024, "group": 8, "corpus_groups": 16,
                  "trace_seconds": 1, "warmup_groups": 1},
    "corpus_device": {"stream_block": 1024, "group": 8, "corpus_groups": 16,
                      "trace_seconds": 1, "warmup_groups": 1},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


def _rewrite(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make_tiny(root: Path) -> Path:
    """A checkout-like tree under ``root``: the manifest and a copy of the
    benchmark whose configurations and mixes are cut to test size."""
    bench = root / "bench_port"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, changes in TINY_CONFIG.items():
        _rewrite(bench / "configs" / f"{name}.json", changes)
    for name, changes in TINY_TRAFFIC.items():
        _rewrite(bench / "traffic" / f"{name}.json", changes)
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def tiny_spec(tiny):
    """``tiny_spec(workload, **spec_fields)``: a CPU run of a tiny cell."""
    import harness
    import run as runner

    def make(workload, seed=20231, seconds=1.0, **kw):
        cell = harness.Cell(harness.load_manifest(tiny.parent), workload,
                            bench=tiny)
        kw.setdefault("device", "cpu")
        return runner.Spec(cell, seed, seconds, kw.pop("trace", False), **kw)

    return make


@pytest.fixture
def card():
    """Skip unless a CUDA card is present; decided here, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
