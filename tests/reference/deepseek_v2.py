"""The plain float32 reference of DeepSeek-V2's layers that the tests hold
``multiverso_tpu_torch/models/deepseek_v2.py`` to: the benchmark's own
(``bench_port/reference/dsv2_lite_ep8.py``, plain torch, importing nothing
of the port), loaded by path so that one copy serves both."""

import importlib.util
from pathlib import Path

_PATH = (Path(__file__).resolve().parents[2] / "bench_port" / "reference"
         / "dsv2_lite_ep8.py")
_spec = importlib.util.spec_from_file_location("dsv2_reference", _PATH)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

Reference, shapes, yarn, softmax_scale, FAULTS = (
    _mod.Reference, _mod.shapes, _mod.yarn, _mod.softmax_scale, _mod.FAULTS)
