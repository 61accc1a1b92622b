"""Build and load the port's native library (port of
``multiverso_tpu/native/``, whose ``Makefile`` this replaces).

``libmultiverso_tpu.so`` holds the flat C API the Lua and C# bindings load
(``c_api.{h,cpp}``: an embedded-CPython shim over
:mod:`multiverso_tpu_torch.c_bridge`), the host allocator
(``allocator.cpp``), the sparse and quantized wire codecs
(``sparse_filter.cpp``, ``quant_filter.cpp``) and the multithreaded libsvm
reader (``text_reader.cpp``). The sources are the JAX package's, with the
bridge import and the messages naming the port.

:func:`load` compiles the library with ``g++`` at first use (never at
import) into ``multiverso_tpu_torch/_build/native/`` (listed in
``.gitignore``) and loads it with ``ctypes``. The build is the CUDA
kernels' (:func:`multiverso_tpu_torch.ops.kernels.cached_build`): atomic,
into a file named by the digest of the sources and the command, so an
edited source is rebuilt; ``libmultiverso_tpu.so`` is a symbolic link to
the current build, the name the bindings and the C clients load. Where the
build fails, :func:`load` raises: there is no fallback.

The library links no libpython: a Python process that loads it already
holds the interpreter's symbols. The two C clients (``test_c_api.c``, the
C API's end-to-end check, and ``test_lua_ffi.c``, the Lua binding's call
sequence replayed through ``dlopen``) link libpython for embedding
(:func:`build_client`; the flags come from ``sysconfig``, as
``python3-config --ldflags --embed`` prints them), which needs a shared
libpython (:func:`embed_supported`). The bindings load the port's build
unchanged with ``LD_LIBRARY_PATH`` pointed at :data:`BUILD_DIR`; a host
that is not Python must load libpython first (``LD_PRELOAD``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build" / "native"
LIB_NAME = "libmultiverso_tpu.so"
SOURCES = ("c_api.cpp", "allocator.cpp", "sparse_filter.cpp",
           "text_reader.cpp", "quant_filter.cpp")
HEADERS = ("c_api.h", "allocator.h", "sparse_filter.h", "text_reader.h")
CLIENTS = ("test_c_api", "test_lua_ffi")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
CFLAGS = ("-O2",)


class LibsvmResult(ctypes.Structure):
    """``MVTRResult`` (``text_reader.h``): arrays owned by the library,
    released with ``MVTR_FreeResult``."""
    _fields_ = [("n_rows", ctypes.c_longlong),
                ("max_nnz", ctypes.c_int),
                ("labels", ctypes.POINTER(ctypes.c_int)),
                ("indices", ctypes.POINTER(ctypes.c_int)),
                ("values", ctypes.POINTER(ctypes.c_float))]


_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)
_SIZE = ctypes.c_size_t
_VOIDP = ctypes.c_void_p
#: exported function -> (restype, argtypes)
SIGNATURES: Dict[str, Tuple[object, tuple]] = {
    "MVTPU_SparseEncode": (_SIZE, (_F32P, _SIZE, _U8P, _SIZE)),
    "MVTPU_SparseDecode": (ctypes.c_int, (_U8P, _SIZE, _F32P, _SIZE)),
    "MVTPU_QuantPack": (None, (_F32P, _SIZE, ctypes.c_float, ctypes.c_float,
                               ctypes.c_int, _U8P)),
    "MVTPU_QuantUnpack": (None, (_U8P, _SIZE, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_int, _F32P)),
    "MVTPU_ConfigureAllocator": (ctypes.c_int, (ctypes.c_char_p, _SIZE)),
    "MVTPU_AllocatorType": (ctypes.c_char_p, ()),
    "MVTPU_Alloc": (_VOIDP, (_SIZE,)),
    "MVTPU_Free": (None, (_VOIDP,)),
    "MVTPU_Refer": (None, (_VOIDP,)),
    "MVTPU_AllocatorLiveBlocks": (_SIZE, ()),
    "MVTPU_AllocatorPooledBlocks": (_SIZE, ()),
    "MVTR_ParseLibsvmFile": (ctypes.c_int, (ctypes.c_char_p, ctypes.c_int,
                                            ctypes.POINTER(LibsvmResult))),
    "MVTR_FreeResult": (None, (ctypes.POINTER(LibsvmResult),)),
    # the C API (c_api.h); a TableHandler is a void*
    "MV_Init": (None, (_I32P, ctypes.POINTER(ctypes.c_char_p))),
    "MV_ShutDown": (None, ()),
    "MV_Barrier": (None, ()),
    "MV_SetFlag": (None, (ctypes.c_char_p, ctypes.c_char_p)),
    "MV_NewArrayTable": (None, (ctypes.c_int, ctypes.POINTER(_VOIDP))),
    "MV_GetArrayTable": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_AddArrayTable": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_AddAsyncArrayTable": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_NewMatrixTable": (None, (ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(_VOIDP))),
    "MV_GetMatrixTableAll": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_AddMatrixTableAll": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_AddAsyncMatrixTableAll": (None, (_VOIDP, _F32P, ctypes.c_int)),
    "MV_GetMatrixTableByRows": (None, (_VOIDP, _F32P, ctypes.c_int, _I32P,
                                       ctypes.c_int)),
    "MV_AddMatrixTableByRows": (None, (_VOIDP, _F32P, ctypes.c_int, _I32P,
                                       ctypes.c_int)),
    "MV_AddAsyncMatrixTableByRows": (None, (_VOIDP, _F32P, ctypes.c_int,
                                            _I32P, ctypes.c_int)),
    **{name: (ctypes.c_int, ()) for name in (
        "MV_NumWorkers", "MV_NumServers", "MV_WorkerId", "MV_ServerId",
        "MV_Rank", "MV_Size")},
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the compiler's output and seconds of each target this process built
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _tool(env: str, names: Tuple[str, ...]) -> str:
    for name in ((os.environ[env],) if os.environ.get(env) else ()) + names:
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(f"no {'/'.join(names)} on PATH (set {env}): the "
                       f"native library cannot be built")


def python_includes() -> List[str]:
    """The ``-I`` flags of this interpreter's headers."""
    paths = sysconfig.get_paths()
    dirs = dict.fromkeys(p for p in (paths.get("include"),
                                     paths.get("platinclude")) if p)
    for d in dirs:
        if not (Path(d) / "Python.h").is_file():
            raise RuntimeError(f"no Python.h in {d}: the native library "
                               f"cannot be built")
    return [f"-I{d}" for d in dirs]


def embed_config() -> Dict[str, object]:
    """The ``sysconfig`` variables that decide whether a C program can
    embed this interpreter."""
    return {k: sysconfig.get_config_var(k)
            for k in ("Py_ENABLE_SHARED", "LDLIBRARY", "LIBDIR", "LIBPL",
                      "LDVERSION")}


def shared_libpython() -> Optional[Path]:
    """The shared libpython a C program links to embed this interpreter:
    ``LDLIBRARY`` where the interpreter is built shared; otherwise
    ``libpython<LDVERSION>.so`` where the distribution installs one beside
    a statically linked interpreter (as Debian's does). None where there
    is none."""
    cfg = embed_config()
    names = [f"libpython{cfg['LDVERSION']}.so"]
    if cfg["Py_ENABLE_SHARED"]:
        names.insert(0, str(cfg["LDLIBRARY"]))
    for d in (cfg["LIBDIR"], cfg["LIBPL"]):
        for name in names:
            if d and name.endswith(".so") and (Path(str(d)) / name).exists():
                return Path(str(d)) / name
    return None


def embed_supported() -> Tuple[bool, str]:
    """(whether the C clients can link libpython, why not)."""
    cfg = embed_config()
    if shared_libpython() is None:
        return False, (f"no shared libpython (Py_ENABLE_SHARED="
                       f"{cfg['Py_ENABLE_SHARED']}, LDLIBRARY="
                       f"{cfg['LDLIBRARY']}, none in {cfg['LIBDIR']} or "
                       f"{cfg['LIBPL']})")
    return True, ""


def embed_ldflags() -> List[str]:
    """``python3-config --ldflags --embed``, from ``sysconfig``, with the
    shared libpython's directory on the run path."""
    cfg = sysconfig.get_config_vars()
    lib = shared_libpython()
    libdir = str(lib.parent) if lib is not None else cfg["LIBDIR"]
    flags = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
             f"-lpython{cfg['LDVERSION']}"]
    for key in ("LIBS", "SYSLIBS"):
        flags += str(cfg.get(key) or "").split()
    return flags


def _cached_build(name: str, stem: str, suffix: str, inputs: List[Path],
                  cmd: List[str]) -> Path:
    """:func:`~multiverso_tpu_torch.ops.kernels.cached_build` into
    :data:`BUILD_DIR`, recording the compiler's output and seconds under
    ``name`` when it ran."""
    from multiverso_tpu_torch.ops.kernels import cached_build
    t0 = time.perf_counter()
    path, log = cached_build(BUILD_DIR, stem, suffix, inputs, cmd)
    if log is not None:
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
    return path


def build() -> Path:
    """Compile the library unless an up-to-date build exists, point
    ``libmultiverso_tpu.so`` at it, and return the link's path."""
    cmd = [_tool("CXX", ("g++", "c++")), *CXXFLAGS, *python_includes(),
           *[str(SRC_DIR / f) for f in SOURCES], "-o", "{out}"]
    target = _cached_build(LIB_NAME, "libmultiverso_tpu", ".so",
                           [SRC_DIR / f for f in SOURCES + HEADERS], cmd)
    link = BUILD_DIR / LIB_NAME
    if not (link.is_symlink() and os.readlink(link) == target.name):
        tmp = BUILD_DIR / f".{os.getpid()}.{threading.get_ident()}.{LIB_NAME}"
        os.symlink(target.name, tmp)
        os.replace(tmp, link)   # atomic, as the build itself
    return link


def build_client(name: str) -> Path:
    """Compile the C client ``name`` (``test_c_api`` or ``test_lua_ffi``)
    beside the library; raises where libpython cannot be embedded."""
    if name not in CLIENTS:
        raise ValueError(f"unknown C client {name!r} (have {CLIENTS})")
    ok, why = embed_supported()
    if not ok:
        raise RuntimeError(f"{name} cannot embed Python: {why}")
    lib = build()
    src = SRC_DIR / f"{name}.c"
    link = (["-L", str(BUILD_DIR), "-lmultiverso_tpu",
             "-Wl,-rpath,$ORIGIN"] if name == "test_c_api" else ["-ldl"])
    cmd = [_tool("CC", ("gcc", "cc")), *CFLAGS, f"-I{SRC_DIR}", str(src),
           "-o", "{out}", *link, *embed_ldflags(), "-lm"]
    # the library's bytes are an input: a rebuilt library relinks
    return _cached_build(name, name, "", [src, SRC_DIR / "c_api.h",
                                          lib.resolve()], cmd)


def client_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """An environment for a C client: ``PYTHONPATH`` carries the checkout
    and this interpreter's ``sys.path``, so the embedded interpreter finds
    the port and its packages whatever prefix it starts from."""
    import sys
    env = dict(os.environ if env is None else env)
    paths = [str(SRC_DIR.parent.parent)] + [p for p in sys.path
                                            if p and os.path.isdir(p)]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


def loaded() -> Optional[ctypes.CDLL]:
    """The library if this process has loaded it, else None."""
    return _lib


def load() -> ctypes.CDLL:
    """The loaded library, built at first use, with ``restype`` and
    ``argtypes`` set for every export; the allocator is configured from
    the flags on the way (:func:`configure_allocator`)."""
    global _lib
    if _lib is None:
        path = build()
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(path))
                for fn, (restype, argtypes) in SIGNATURES.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = list(argtypes)
                _lib = lib
        configure_allocator()
    return _lib


def configure_allocator() -> int:
    """Push the ``allocator_type`` / ``allocator_alignment`` flags into the
    native host pool (reference: the flags were read at allocator
    construction, ``src/util/allocator.cpp:10,153``). Too-late configuration
    (something already allocated) is reported, not fatal. Returns the
    library's code (0 when it took the configuration)."""
    from multiverso_tpu_torch import log
    from multiverso_tpu_torch.config import get_flag
    kind = str(get_flag("allocator_type"))
    rc = load().MVTPU_ConfigureAllocator(
        kind.encode(), int(get_flag("allocator_alignment")))
    if rc == -1:
        log.info("native allocator already instantiated; allocator_type=%s "
                 "ignored for this process", kind)
    elif rc == -2:
        log.error("unknown allocator_type %r (want smart|default)", kind)
    elif rc == -3:
        log.error("allocator_alignment=%s is not a power of two >= %d; "
                  "keeping the previous alignment",
                  get_flag("allocator_alignment"), 8)
    return rc
