"""The port's native layer (``multiverso_tpu_torch/native/``): the library
built at first use into ``multiverso_tpu_torch/_build/native/``, the C API
driven by a real C client (subprocess, ``-device=cpu``), the allocator and
its flags, the wire codecs (native and numpy byte for byte, and equal to
the JAX package's) and the native libsvm reader against the Python
parser. Twins of ``tests/test_native.py`` and of the native-reader cases
of ``tests/test_lr_io.py``."""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu_torch import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native_lib():
    return native.load()


def _embed_env():
    return native.client_env()


def test_c_api_end_to_end():
    """A plain C program links the port's library, embeds Python, and drives
    the port's tables (on the CPU here)."""
    binary = native.build_client("test_c_api")
    result = subprocess.run([str(binary), "-device=cpu"], env=_embed_env(),
                            capture_output=True, text=True, timeout=240)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "c_api smoke test passed" in result.stdout


def test_native_allocator_pools(native_lib):
    lib = native_lib
    p = lib.MVTPU_Alloc(100)  # bucketed to 128
    assert p
    # refcounting: a second reference keeps the block live across one Free
    lib.MVTPU_Refer(p)
    lib.MVTPU_Free(p)
    ctypes.memset(p, 0x5A, 100)  # still valid
    pooled_before = lib.MVTPU_AllocatorPooledBlocks()
    lib.MVTPU_Free(p)
    assert lib.MVTPU_AllocatorPooledBlocks() == pooled_before + 1
    # reuse from the pool
    q = lib.MVTPU_Alloc(120)
    assert q == p  # same 128-byte bucket, LIFO reuse
    lib.MVTPU_Free(q)


@pytest.mark.parametrize("force_numpy", [True, False])
def test_sparse_filter_roundtrip(native_lib, force_numpy):
    from multiverso_tpu_torch.utils import quantization as q
    rng = np.random.default_rng(0)
    # sparse case
    data = np.zeros(1000, np.float32)
    idx = rng.choice(1000, 50, replace=False)
    data[idx] = rng.normal(size=50).astype(np.float32)
    payload = q.sparse_encode(data, force_numpy=force_numpy)
    assert len(payload) < 1000 * 4  # actually compressed
    out = q.sparse_decode(payload, 1000, force_numpy=force_numpy)
    np.testing.assert_array_equal(out, data)
    # dense case passes through
    dense = rng.normal(size=256).astype(np.float32)
    payload = q.sparse_encode(dense, force_numpy=force_numpy)
    out = q.sparse_decode(payload, 256, force_numpy=force_numpy)
    np.testing.assert_array_equal(out, dense)


def test_sparse_filter_native_numpy_agree(native_lib):
    from multiverso_tpu_torch.utils import quantization as q
    assert q.native_available()
    data = np.zeros(64, np.float32)
    data[[3, 9]] = [1.5, -2.5]
    assert q.sparse_encode(data) == q.sparse_encode(data, force_numpy=True)


@pytest.mark.parametrize("force_numpy", [True, False])
def test_sparse_decode_rejects_garbage(force_numpy):
    from multiverso_tpu_torch.utils import quantization as q
    with pytest.raises(ValueError):
        q.sparse_decode(b"garbagegarbagegarbage", 4, force_numpy=force_numpy)


def test_codec_payloads_equal_the_jax_packages():
    """A sparse vector, a dense vector and a quantized pack at each width:
    the port's native and numpy payloads are the JAX package's bytes (its
    default path and its numpy codec), and each side decodes the other's."""
    from multiverso_tpu.utils import quantization as jq
    from multiverso_tpu_torch.utils import quantization as q
    rng = np.random.default_rng(7)
    sparse = np.zeros(4099, np.float32)
    sparse[rng.choice(4099, 300, replace=False)] = rng.normal(size=300)
    dense = (rng.normal(size=4099) * 3).astype(np.float32)
    for x in (sparse, dense):
        got = q.sparse_encode(x)
        assert got == q.sparse_encode(x, force_numpy=True)
        assert got == jq.sparse_encode(x) == jq.sparse_encode(
            x, force_numpy=True)
        np.testing.assert_array_equal(jq.sparse_decode(got, x.size), x)
        for bits in (1, 2, 4, 8):
            pack = q.quant_encode(x, bits)
            assert pack == q.quant_encode(x, bits, force_numpy=True)
            assert pack == jq.quant_encode(x, bits) == jq.quant_encode(
                x, bits, force_numpy=True)
            np.testing.assert_array_equal(
                q.quant_decode(pack, x.size),
                jq.quant_decode(pack, x.size, force_numpy=True))


ALLOC_TYPE_SNIPPET = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.MVTPU_ConfigureAllocator.restype = ctypes.c_int
lib.MVTPU_ConfigureAllocator.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
lib.MVTPU_AllocatorType.restype = ctypes.c_char_p
lib.MVTPU_Alloc.restype = ctypes.c_void_p
lib.MVTPU_Alloc.argtypes = [ctypes.c_size_t]
lib.MVTPU_Free.argtypes = [ctypes.c_void_p]
assert lib.MVTPU_ConfigureAllocator(b"zzz", 16) == -2
assert lib.MVTPU_ConfigureAllocator(b"default", 64) == 0
assert lib.MVTPU_AllocatorType() == b"default"
p = lib.MVTPU_Alloc(100)
assert p % 64 == 0, "alignment flag not honored"
assert lib.MVTPU_AllocatorLiveBlocks() == 1
lib.MVTPU_Free(ctypes.c_void_p(p))
# default allocator releases memory: nothing pooled, nothing live
assert lib.MVTPU_AllocatorLiveBlocks() == 0
assert lib.MVTPU_AllocatorPooledBlocks() == 0
# reconfiguration after first use: same config ok, different config refused
assert lib.MVTPU_ConfigureAllocator(b"default", 64) == 0
assert lib.MVTPU_ConfigureAllocator(b"smart", 16) == -1
print("alloc type ok")
"""


def test_allocator_type_flag(native_lib):
    """allocator_type/allocator_alignment are real configuration: the
    `default` allocator frees immediately (no pool) and honors alignment.
    Run in a subprocess: the singleton latches on first use per process."""
    lib_path = native.BUILD_DIR / native.LIB_NAME
    result = subprocess.run(
        [sys.executable, "-c", ALLOC_TYPE_SNIPPET, str(lib_path)],
        capture_output=True, text=True, timeout=60)
    assert result.returncode == 0, result.stderr[-2000:]
    assert "alloc type ok" in result.stdout


INIT_PLUMB_SNIPPET = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import native
seen = {}
# loaded after init: the library takes the flags when it loads
mvt.init(device="cpu", allocator_type="default", allocator_alignment=64)
seen["before_load"] = native.loaded() is None
from multiverso_tpu_torch.utils.quantization import _load_native
lib = _load_native()
seen["after_load"] = lib.MVTPU_AllocatorType().decode()
mvt.shutdown()
# loaded before init: init pushes the flags in
mvt.init(device="cpu", allocator_type="smart", allocator_alignment=16)
seen["reinit"] = lib.MVTPU_AllocatorType().decode()
p = lib.MVTPU_Alloc(100)
seen["aligned16"] = p % 16 == 0
lib.MVTPU_Free(p)
mvt.shutdown()
print(json.dumps(seen))
"""


def test_init_plumbs_allocator_flags(native_lib):
    """``mvt.init()`` pushes the allocator flags into the native library,
    or the library takes them when first loaded after init; init itself
    never builds it."""
    result = subprocess.run(
        [sys.executable, "-c", INIT_PLUMB_SNIPPET, str(REPO)],
        capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    seen = json.loads(result.stdout.strip().splitlines()[-1])
    assert seen == {"before_load": True, "after_load": "default",
                    "reinit": "smart", "aligned16": True}


def test_library_is_built_at_first_use_not_at_import():
    """Importing every module of the port loads no native library, and a
    load names the port's build directory."""
    code = ("import importlib, pkgutil, multiverso_tpu_torch as p\n"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "p.__path__, 'multiverso_tpu_torch.')]\n"
            "from multiverso_tpu_torch import native\n"
            "assert native.loaded() is None\n"
            "lib = native.load()\n"
            "print(lib._name)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_embed_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(REPO / "multiverso_tpu_torch" / "_build"
                                     / "native" / "libmultiverso_tpu.so")


def test_cached_build_names_by_digest_and_rebuilds_on_edit(tmp_path):
    """The build shared by the native library and the CUDA kernels: a file
    named by the digest of its inputs and command, built once, built anew
    after an edit, and no temporary file left; a failed compile raises
    with the compiler's output and leaves nothing behind."""
    from multiverso_tpu_torch.ops.kernels import cached_build
    src = tmp_path / "f.c"
    src.write_text("int f(void) { return 1; }\n")
    out = tmp_path / "out"
    cmd = [native._tool("CC", ("gcc", "cc")), "-shared", "-fPIC", str(src),
           "-o", "{out}"]
    first, log = cached_build(out, "libf", ".so", [src], cmd)
    assert log is not None and first.is_file()
    assert first.name.startswith("libf-") and first.suffix == ".so"
    assert cached_build(out, "libf", ".so", [src], cmd) == (first, None)
    src.write_text("int f(void) { return 2; }\n")
    second, log = cached_build(out, "libf", ".so", [src], cmd)
    assert second != first and log is not None
    assert ctypes.CDLL(str(second)).f() == 2
    src.write_text("int f(void) { return }\n")
    with pytest.raises(RuntimeError, match="failed"):
        cached_build(out, "libf", ".so", [src], cmd)
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [first.name, second.name])


# -- the native libsvm reader (twins of tests/test_lr_io.py) --------------------

def test_native_libsvm_parser_matches_python(tmp_path):
    """native/text_reader.cpp must be byte-identical to the Python parser
    across the format's edge cases (value-less tokens, blank lines,
    truncation at max_nnz, float labels, negative values)."""
    from multiverso_tpu_torch.models.logreg import (load_libsvm,
                                                    load_libsvm_native,
                                                    parse_libsvm_line)

    lines = [
        "1 0:0.5 3:1.25 7:-2.0",
        "",                          # blank: skipped
        "0 2:0.1 4:0.2 5:0.3 6:0.4 8:0.5",   # truncates at max_nnz=4
        "-1 1:1e-3 9:2.5E2",
        "2.0 0:1",                   # float label -> int
        "1 5: 6:2.0",                # value-less "5:" -> 1.0
        "0 7",                       # bare feature -> 1.0
        "   ",                       # whitespace-only: skipped
        "3 1:0.25",
        "+1 0:+0.5 2:+.25 3:+1e2",   # canonical '+1' label, '+' values
        "+2.5 +4:+3",                # '+' float label, '+' feature id
    ]
    path = tmp_path / "edge.libsvm"
    path.write_text("\n".join(lines) + "\n")

    native_out = load_libsvm_native(str(path), max_nnz=4)
    assert native_out is not None
    ys, idxs, vals = [], [], []
    for line in lines:
        if not line.strip():
            continue
        y, idx, val = parse_libsvm_line(line, 4)
        ys.append(y)
        idxs.append(idx)
        vals.append(val)
    np.testing.assert_array_equal(native_out["y"], np.array(ys, np.int32))
    np.testing.assert_array_equal(native_out["idx"], np.stack(idxs))
    np.testing.assert_array_equal(native_out["val"], np.stack(vals))
    fast_edge = load_libsvm(str(path), max_nnz=4)
    for key in ("y", "idx", "val"):
        np.testing.assert_array_equal(fast_edge[key], native_out[key])
    # the stream path (file://) runs the Python parser: the same arrays
    via_stream = load_libsvm("file://" + str(path), max_nnz=4)
    for key in ("y", "idx", "val"):
        np.testing.assert_array_equal(via_stream[key], native_out[key])

    rng = np.random.default_rng(0)
    big = []
    for _ in range(500):
        nnz = rng.integers(1, 9)
        feats = sorted(rng.choice(100, nnz, replace=False))
        toks = " ".join(f"{f}:{rng.normal():.6g}" for f in feats)
        big.append(f"{rng.integers(0, 3)} {toks}")
    bpath = tmp_path / "big.libsvm"
    bpath.write_text("\n".join(big) + "\n")
    fast = load_libsvm(str(bpath), max_nnz=8)
    nat = load_libsvm_native(str(bpath), max_nnz=8)
    ys2, idxs2, vals2 = [], [], []
    for line in big:
        y, idx, val = parse_libsvm_line(line, 8)
        ys2.append(y)
        idxs2.append(idx)
        vals2.append(val)
    np.testing.assert_array_equal(nat["y"], np.array(ys2, np.int32))
    np.testing.assert_array_equal(nat["idx"], np.stack(idxs2))
    np.testing.assert_array_equal(nat["val"], np.stack(vals2))
    for key in ("y", "idx", "val"):
        np.testing.assert_array_equal(fast[key], nat[key])

    # malformed input must not succeed natively: the native call declines
    # and the Python parser raises
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 3:abc 4:1.0\n")
    assert load_libsvm_native(str(bad), max_nnz=4) is None
    with pytest.raises(ValueError):
        load_libsvm(str(bad), max_nnz=4)
    for badplus in ("++1 0:0.5", "+-1 0:0.5", "1 0:++2"):
        bp = tmp_path / "badplus.libsvm"
        bp.write_text(badplus + "\n")
        assert load_libsvm_native(str(bp), max_nnz=4) is None
        with pytest.raises(ValueError):
            load_libsvm(str(bp), max_nnz=4)


def test_libsvm_edge_contracts(tmp_path):
    """Empty files return empty arrays on both paths; nan/overflow labels
    fail the native parse; a missing file is declined, not built around."""
    from multiverso_tpu_torch.models.logreg import (load_libsvm,
                                                    load_libsvm_native)

    empty = tmp_path / "empty.libsvm"
    empty.write_text("\n  \n")
    via_dispatch = load_libsvm("file://" + str(empty), max_nnz=4)
    assert via_dispatch["y"].shape == (0,)
    nat = load_libsvm_native(str(empty), max_nnz=4)
    for key in ("y", "idx", "val"):
        np.testing.assert_array_equal(nat[key], via_dispatch[key])
        assert nat[key].dtype == via_dispatch[key].dtype
    bad_label = tmp_path / "nanlabel.libsvm"
    bad_label.write_text("nan 1:0.5\n")
    assert load_libsvm_native(str(bad_label), max_nnz=4) is None
    overflow = tmp_path / "big.libsvm"
    overflow.write_text("4000000000 1:0.5\n")
    assert load_libsvm_native(str(overflow), max_nnz=4) is None
    assert load_libsvm_native(str(tmp_path / "missing.libsvm")) is None


def test_native_libsvm_parser_fuzz_equivalence(tmp_path):
    """Seeded fuzz: random well-formed lines drawn from the format's
    grammar (varied whitespace runs, value-less and bare tokens, float
    labels, scientific notation, truncation) parse identically on both
    paths, and equal the JAX package's Python parser."""
    from multiverso_tpu.models.logreg import parse_libsvm_line as jparse
    from multiverso_tpu_torch.models.logreg import (load_libsvm_native,
                                                    parse_libsvm_line)

    rng = np.random.default_rng(42)
    max_nnz = 6

    def token(f):
        r = rng.random()
        if r < 0.15:
            return str(f)            # bare feature -> 1.0
        if r < 0.25:
            return f"{f}:"           # value-less -> 1.0
        if r < 0.45:
            return f"{f}:{rng.normal():.8e}"  # scientific
        if r < 0.55:
            return f"{f}:+{abs(rng.normal()):.6f}"  # '+'-prefixed value
        if r < 0.65:
            return f"{f}:{rng.integers(-9, 9)}"
        return f"{f}:{rng.normal():.6f}"

    lines = []
    for _ in range(300):
        label = rng.choice(["0", "1", "-1", "2.0", "3.75", "+1", "+0.5"])
        nnz = int(rng.integers(0, 10))
        feats = rng.choice(1000, size=nnz, replace=False)
        ws = lambda: " " * int(rng.integers(1, 4)) + (  # noqa: E731
            "\t" if rng.random() < 0.2 else "")
        body = "".join(ws() + token(f) for f in feats)
        lines.append(f"{label}{body}" + (" " if rng.random() < 0.3 else ""))
        if rng.random() < 0.1:
            lines.append("")  # blank
    path = tmp_path / "fuzz.libsvm"
    path.write_text("\n".join(lines) + "\n")

    nat = load_libsvm_native(str(path), max_nnz=max_nnz)
    assert nat is not None
    rows = [parse_libsvm_line(line, max_nnz) for line in lines
            if line.strip()]
    jrows = [jparse(line, max_nnz) for line in lines if line.strip()]
    for got, want in zip(rows, jrows):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(nat["y"], np.array([r[0] for r in rows],
                                                     np.int32))
    np.testing.assert_array_equal(nat["idx"], np.stack([r[1] for r in rows]))
    np.testing.assert_array_equal(nat["val"], np.stack([r[2] for r in rows]))
