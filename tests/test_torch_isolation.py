"""The torch port stands alone: it imports neither JAX nor the JAX package,
and it never carries on quietly on the host when a card was asked for."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS as TORCH_FLAGS

REPO = Path(__file__).resolve().parent.parent
# the package, its example scripts (multiverso_tpu_torch/examples) and the
# scripts beside it
PORT_FILES = sorted((REPO / "multiverso_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "asgd_probe.py",
    REPO / "tests" / "torch_remote_child.py",
    REPO / "tests" / "torch_durable_primary_child.py"]
EXAMPLES = ("resnet_asgd.py", "torch_asgd.py", "asgd_param_manager.py",
            "lda_topics.py", "word2vec_train.py", "logreg_train.py",
            "ftrl_ctr.py", "word2vec_query.py", "addition_rnn.py",
            "multihost_ps.py", "long_context_lm.py")


def _forbidden(module: str) -> bool:
    return (module in ("jax", "multiverso_tpu")
            or module.startswith(("jax.", "multiverso_tpu.")))


def test_import_pulls_in_no_jax():
    # every module of the package, both apps and their tables included
    code = ("import importlib, json, pkgutil, sys, multiverso_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, 'multiverso_tpu_torch.')]; "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"multiverso_tpu_torch.models.word2vec", "multiverso_tpu_torch.convert",
            "multiverso_tpu_torch.tables.kv_table", "multiverso_tpu_torch.models.logreg",
            "multiverso_tpu_torch.tables.sparse_table",
            "multiverso_tpu_torch.tables.ftrl_table", "multiverso_tpu_torch.io",
            "multiverso_tpu_torch.checkpoint",
            "multiverso_tpu_torch.models.lr_io",
            "multiverso_tpu_torch.ops.device_hash",
            "multiverso_tpu_torch.store", "multiverso_tpu_torch.store.coldstore",
            "multiverso_tpu_torch.store.tiered",
            "multiverso_tpu_torch.query", "multiverso_tpu_torch.query.engine",
            "multiverso_tpu_torch.utils.quantization",
            "multiverso_tpu_torch.runtime.contracts",
            "multiverso_tpu_torch.obs.profiler",
            "multiverso_tpu_torch.ext", "multiverso_tpu_torch.ext.param_manager",
            "multiverso_tpu_torch.ext.sharedvar",
            "multiverso_tpu_torch.ext.callbacks",
            "multiverso_tpu_torch.models.resnet",
            "multiverso_tpu_torch.obs.trace",
            "multiverso_tpu_torch.obs.metrics",
            "multiverso_tpu_torch.fault",
            "multiverso_tpu_torch.fault.detector",
            "multiverso_tpu_torch.fault.retry",
            "multiverso_tpu_torch.fault.inject",
            "multiverso_tpu_torch.runtime.admission",
            "multiverso_tpu_torch.runtime.wire",
            "multiverso_tpu_torch.runtime.shm",
            "multiverso_tpu_torch.runtime.net",
            "multiverso_tpu_torch.runtime.remote",
            "multiverso_tpu_torch.utils.backoff",
            "multiverso_tpu_torch.durable",
            "multiverso_tpu_torch.durable.wal",
            "multiverso_tpu_torch.durable.standby",
            "multiverso_tpu_torch.runtime.read",
            "multiverso_tpu_torch.obs.audit",
            "multiverso_tpu_torch.io.mvfs",
            "multiverso_tpu_torch.obs.timeseries",
            "multiverso_tpu_torch.durable.cut",
            "multiverso_tpu_torch.durable.migrate",
            "multiverso_tpu_torch.shard",
            "multiverso_tpu_torch.shard.partition",
            "multiverso_tpu_torch.shard.router",
            "multiverso_tpu_torch.shard.group",
            "multiverso_tpu_torch.shard.reshard",
            "multiverso_tpu_torch.shard._child",
            "multiverso_tpu_torch.models.lda",
            "multiverso_tpu_torch.obs.logger",
            "multiverso_tpu_torch.obs.collector",
            "multiverso_tpu_torch.obs.critpath",
            "multiverso_tpu_torch.obs.chargeback",
            "multiverso_tpu_torch.obs.slo",
            "multiverso_tpu_torch.fault.lockcheck",
            "multiverso_tpu_torch.tune",
            "multiverso_tpu_torch.tune.rules",
            "multiverso_tpu_torch.tune.sensors",
            "multiverso_tpu_torch.autopilot",
            "multiverso_tpu_torch.autopilot.actuators",
            "multiverso_tpu_torch.autopilot.interlock",
            "multiverso_tpu_torch.autopilot.policy",
            "multiverso_tpu_torch.autopilot.sensors",
            "multiverso_tpu_torch.runtime.multihost",
            "multiverso_tpu_torch.parallel.mesh",
            "multiverso_tpu_torch.parallel.ring",
            "multiverso_tpu_torch.c_bridge",
            "multiverso_tpu_torch.native"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                found.append(node.module)
    assert found == []


@pytest.mark.parametrize("argv", [["tests/torch_remote_child.py", "serve"],
                                  ["chip_smoke.py", "--client"]],
                         ids=["remote_child", "chip_smoke_client"])
def test_client_processes_load_no_jax(argv):
    """The port's child script and chip_smoke.py's client mode, run as the
    process they are: after their main returns, nothing of JAX or of the
    JAX package is loaded (the serve mode is stopped before it sleeps)."""
    code = ("import json, runpy, sys, time\n"
            f"sys.argv = {argv!r}\n"
            "time.sleep = sys.exit\n"  # the serve mode parks in a sleep
            "try:\n"
            "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         input="EXIT\n", capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "multiverso_tpu_torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_example_twins_are_checked():
    checked = {p.name for p in PORT_FILES if p.parent.name == "examples"}
    assert set(EXAMPLES) <= checked


def test_init_needs_the_card_unless_cpu_is_asked_for():
    """Whether a card is present is decided here, when the test runs."""
    TORCH_FLAGS.reset()
    try:
        if torch.cuda.is_available():
            mvt.init()
            assert mvt.Zoo.instance().device.type == "cuda"
        else:
            with pytest.raises(mvt.log.FatalError, match="CUDA"):
                mvt.init()
            assert not mvt.Zoo.instance().started
            mvt.init(["-device=cpu"])
            assert mvt.Zoo.instance().device == torch.device("cpu")
    finally:
        mvt.shutdown()
        TORCH_FLAGS.reset()


def test_shard_modules_are_checked():
    """Every module of the sharded serving slice is among the files whose
    imports are checked (and the group's child runs the port's module)."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for name in ("shard/__init__.py", "shard/partition.py", "shard/router.py",
                 "shard/group.py", "shard/reshard.py", "shard/_child.py",
                 "durable/cut.py", "durable/migrate.py", "obs/timeseries.py"):
        assert f"multiverso_tpu_torch/{name}" in checked
    for name in ("shard/group.py", "shard/reshard.py"):
        source = (REPO / "multiverso_tpu_torch" / name).read_text()
        assert '"multiverso_tpu_torch.shard._child"' in source
        assert "JAX_PLATFORMS" not in source


def test_multihost_module_is_checked():
    """The lockstep runtime is among the files whose imports are checked,
    and it forms its world with torch.distributed, not jax.distributed."""
    checked = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "multiverso_tpu_torch/runtime/multihost.py" in checked
    source = (REPO / "multiverso_tpu_torch" / "runtime"
              / "multihost.py").read_text()
    assert "dist.init_process_group(" in source
    assert "JAX_PLATFORMS" not in source and "XLA_FLAGS" not in source


def test_native_sources_drive_the_port_and_build_under_build():
    """The port's C API imports the port's bridge and names no module of
    the JAX package; the library and the C clients are built only under
    ``multiverso_tpu_torch/_build/`` (gitignored), never beside the
    sources."""
    import re

    from multiverso_tpu_torch import native
    src = REPO / "multiverso_tpu_torch" / "native"
    c_api = (src / "c_api.cpp").read_text()
    assert 'PyImport_ImportModule("multiverso_tpu_torch.c_bridge")' in c_api
    for path in sorted(src.glob("*.[ch]*")):
        text = path.read_text()
        assert not re.search(r"multiverso_tpu\.(?!so)", text), path.name
        assert "jax" not in text.lower(), path.name
    assert native.BUILD_DIR == REPO / "multiverso_tpu_torch" / "_build" / "native"
    assert "multiverso_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    assert not list(src.glob("*.so")) and not list(src.glob("*.o"))
    assert not any((src / c).exists() for c in native.CLIENTS)
    bridge = (REPO / "multiverso_tpu_torch" / "c_bridge.py").read_text()
    assert "import multiverso_tpu_torch as mvt" in bridge
