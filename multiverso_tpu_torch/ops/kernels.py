"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled once, at first use, by ``nvcc`` into a shared
library with a plain C interface, and loaded with ``ctypes``. The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and never confused with a stale build. Builds land in
``multiverso_tpu_torch/_build/`` (listed in ``.gitignore``); nothing is
built while a module is imported.

``nvcc`` is looked up through ``CUDA_HOME``, then PyTorch's own
``torch.utils.cpp_extension.CUDA_HOME``, then ``PATH``. Where there is
none, :func:`load` raises: there is no fallback to a host path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p
_DTYPES = ("f32", "f64", "f16", "i32", "i64")
# (table, ids, deltas or out, rows, batch, vecs_per_row[, grid, block_x,
# block_y][, in_l2], stream)
_ROWS_ARGS = (_PTR, _PTR, _PTR, _I64, _I64, _I64)
_GEOMETRY = (_I64, _I64, _I64)
#: C entry point -> argument types; every one returns cudaGetLastError().
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "rows": {
        **{f"mvt_scatter_add_rows_{s}": _ROWS_ARGS + _GEOMETRY + (_I64, _PTR)
           for s in _DTYPES},
        **{f"mvt_scatter_add_rows_coalesced_{s}": _ROWS_ARGS + (_PTR,)
           for s in _DTYPES},
        "mvt_gather_rows": _ROWS_ARGS + _GEOMETRY + (_PTR,),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, spills) for each built source.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when the toolkit is absent."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except (ImportError, OSError):
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def build(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; return
    the library path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}-{digest}.{os.getpid()}.so"
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{build_logs[name]}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use, with
    ``argtypes``/``restype`` set for every entry point."""
    with _lock:
        cdll = _loaded.get(name)
        if cdll is None:
            cdll = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(cdll, fn).argtypes = list(argtypes)
                getattr(cdll, fn).restype = ctypes.c_int
            _loaded[name] = cdll
        return cdll
