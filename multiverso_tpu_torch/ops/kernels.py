"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled once, at first use, by ``nvcc`` into a shared
library with a plain C interface, and loaded with ``ctypes``. The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and never confused with a stale build (:func:`cached_build`, which
the native library's build shares). Builds land in
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
from typing import Dict, Optional, Sequence, Tuple

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
    "sgns": {
        # (w_in, ld_in, rows_in, w_out, ld_out, rows_out, block, win, neg,
        # slots, n_slots, T, D, W, K, G, flags, lr, cap, ids, deltas,
        # scratch, scratch_floats, result, stream)
        "mvt_sgns_chunk": ((_PTR, _I64, _I64) * 2 + (_PTR,) * 4
                           + (_I64,) * 7 + (ctypes.c_double,) * 2
                           + (_PTR,) * 3 + (_I64, _PTR, _PTR)),
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


def cached_build(out_dir: Path, stem: str, suffix: str,
                 inputs: Sequence[Path],
                 cmd: Sequence[str]) -> Tuple[Path, Optional[str]]:
    """Build ``out_dir/<stem>-<digest><suffix>`` with ``cmd`` unless it
    exists. The digest covers the inputs' bytes and the command, so an
    edited source or flag builds anew and a stale build is never loaded.
    ``cmd`` names its output ``{out}``: a temporary file, renamed over the
    target once the compiler succeeds (atomic: a concurrent build sees all
    or nothing). Returns (the path, the compiler's output, or None where
    the build existed); raises with that output where the compiler fails."""
    h = hashlib.sha256()
    for f in inputs:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    for arg in cmd:
        h.update(arg.encode() + b"\0")
    target = out_dir / f"{stem}-{h.hexdigest()[:16]}{suffix}"
    if target.is_file():
        return target, None
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{os.getpid()}.{threading.get_ident()}.{target.name}"
    proc = subprocess.run([a.replace("{out}", str(tmp)) for a in cmd],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {target.name} failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, target)
    return target, log


def build(name: str, nvcc: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists; return
    the library path."""
    src = CSRC / f"{name}.cu"
    lib, log = cached_build(BUILD_DIR, f"lib{name}", ".so", [src],
                            [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", "{out}",
                             str(src)])
    if log is not None:
        build_logs[name] = log
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
