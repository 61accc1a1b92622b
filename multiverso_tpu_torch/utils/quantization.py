"""Wire compression: SparseFilter and the quantized delta codec with error
feedback (port of ``multiverso_tpu/utils/quantization.py``).

Reference capability (not copied): ``SparseFilter<data,index>`` encodes a
blob as (index, value) pairs when more than half of it is zeros;
``OneBitsFilter`` was an empty stub
(``include/multiverso/util/quantization_util.h:37-161``). Deltas quantize
to 1/2/4/8 bits per value with client-side residual accumulation (error
feedback), so the quantization error feeds into the next push.

The payloads are byte-identical to the JAX package's (magics 'MVSF' and
'MVQF'): the scale comes from min/max only, which no summation order
changes, and the elementwise quantize is float32 with round-half-to-even.
The cold tier (``store/coldstore.py``) packs spilled rows with this codec
and the query plane scores its codes in the compressed domain.

Each codec runs natively (``native/sparse_filter.cpp``,
``native/quant_filter.cpp`` in the port's ``libmultiverso_tpu.so``,
loaded with ``ctypes``) unless ``force_numpy=True`` asks for the numpy
version; both write the same bytes. The library is built at first use
(:mod:`multiverso_tpu_torch.native`), and a failed build raises: the
codecs never fall back to numpy quietly.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

_MAGIC = 0x4653564D  # 'MVSF'


def _load_native() -> ctypes.CDLL:
    """The port's native library, built at first use; raises when the build
    fails (no numpy fallback)."""
    from multiverso_tpu_torch import native
    return native.load()


def native_available() -> bool:
    """True once the native codecs are loaded: builds the library at first
    use and raises when that fails."""
    return _load_native() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sparse_encode(data: np.ndarray, force_numpy: bool = False) -> bytes:
    """Encode a float32 array; sparse form when <50% nonzero."""
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    if not force_numpy:
        # worst case: header(16) + nnz(8) + count*(4+4)
        cap = 24 + data.size * 8
        out = np.empty(cap, dtype=np.uint8)
        n = _load_native().MVTPU_SparseEncode(
            _ptr(data, ctypes.c_float), data.size, _ptr(out, ctypes.c_uint8),
            cap)
        return out[:n].tobytes()
    nz = np.nonzero(data)[0]
    sparse = 2 * len(nz) < data.size
    header = struct.pack("<IIQ", _MAGIC, 1 if sparse else 0, data.size)
    if not sparse:
        return header + data.tobytes()
    pairs = np.empty((len(nz), 2), dtype=np.uint32)
    pairs[:, 0] = nz.astype(np.uint32)
    pairs[:, 1] = data[nz].view(np.uint32)
    return header + struct.pack("<Q", len(nz)) + pairs.tobytes()


def sparse_decode(payload: bytes, count: int,
                  force_numpy: bool = False) -> np.ndarray:
    if not force_numpy:
        out = np.zeros(count, dtype=np.float32)
        buf = np.frombuffer(payload, dtype=np.uint8)
        if not _load_native().MVTPU_SparseDecode(
                _ptr(buf, ctypes.c_uint8), len(payload),
                _ptr(out, ctypes.c_float), count):
            raise ValueError("malformed sparse payload")
        return out
    magic, kind, n = struct.unpack_from("<IIQ", payload, 0)
    if magic != _MAGIC or n != count:
        raise ValueError("malformed sparse payload")
    if kind == 0:
        return np.frombuffer(payload, dtype=np.float32, count=count,
                             offset=16).copy()
    (nnz,) = struct.unpack_from("<Q", payload, 16)
    pairs = np.frombuffer(payload, dtype=np.uint32, count=nnz * 2,
                          offset=24).reshape(nnz, 2)
    out = np.zeros(count, dtype=np.float32)
    out[pairs[:, 0]] = pairs[:, 1].view(np.float32)
    return out


# -- quantized delta codec (the OneBits slot) --------------------------------

_QMAGIC = 0x4651564D  # 'MVQF'
_QBITS = (1, 2, 4, 8)


def _quant_params(data: np.ndarray, bits: int):
    """(lo, step, inv_step) as float32, from min/max only, so the
    derivation does not depend on any summation order."""
    lo = np.float32(data.min()) if data.size else np.float32(0.0)
    hi = np.float32(data.max()) if data.size else np.float32(0.0)
    levels = (1 << bits) - 1
    step = np.float32((hi - lo) / np.float32(levels))
    inv = np.float32(0.0) if step == 0 else np.float32(1.0) / step
    return lo, step, inv


def _unpack_codes(payload: bytes, count: int):
    """(codes uint16 (count,), lo, step, bits) of a quant payload."""
    magic, bits, n = struct.unpack_from("<IIQ", payload, 0)
    if magic != _QMAGIC or n != count or bits not in _QBITS:
        raise ValueError("malformed quant payload")
    lo, step = struct.unpack_from("<ff", payload, 16)
    per_byte = 8 // bits
    n_bytes = -(-count // per_byte)
    packed = np.frombuffer(payload, dtype=np.uint8, offset=24,
                           count=n_bytes)
    shifts = (np.arange(per_byte, dtype=np.uint16) * bits)
    mask = np.uint16((1 << bits) - 1)
    q = ((packed[:, None].astype(np.uint16) >> shifts) & mask).reshape(-1)
    return q[:count], np.float32(lo), np.float32(step), int(bits)


def quant_encode(data: np.ndarray, bits: int,
                 force_numpy: bool = False) -> bytes:
    """Quantize a float32 array to ``bits`` (1|2|4|8) per value.

    Layout: <u32 magic><u32 bits><u64 count><f32 lo><f32 step> + packed
    codes (little-endian within each byte). Lossy by design: pair with
    :class:`ErrorFeedback` so the error re-enters the next delta."""
    if bits not in _QBITS:
        raise ValueError(f"quant bits must be one of {_QBITS}, got {bits}")
    data = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    lo, step, inv = _quant_params(data, bits)
    header = struct.pack("<IIQff", _QMAGIC, bits, data.size, float(lo),
                         float(step))
    per_byte = 8 // bits
    n_bytes = -(-data.size // per_byte)
    if not force_numpy:
        out = np.zeros(n_bytes, dtype=np.uint8)
        _load_native().MVTPU_QuantPack(
            _ptr(data, ctypes.c_float), data.size, float(lo), float(inv),
            bits, _ptr(out, ctypes.c_uint8))
        return header + out.tobytes()
    levels = (1 << bits) - 1
    # float32 elementwise + rint (round-half-to-even), as the C++ nearbyintf
    q = np.rint((data - lo) * inv).astype(np.float32)
    q = np.clip(q, 0, levels).astype(np.uint8)
    pad = n_bytes * per_byte - data.size
    if pad:
        q = np.concatenate([q, np.zeros(pad, np.uint8)])
    q = q.reshape(-1, per_byte)
    shifts = (np.arange(per_byte, dtype=np.uint16) * bits)
    packed = (q.astype(np.uint16) << shifts).sum(axis=1).astype(np.uint8)
    return header + packed.tobytes()


def quant_decode(payload: bytes, count: int,
                 force_numpy: bool = False) -> np.ndarray:
    """Decode a quant payload back to float32 (count values)."""
    if not force_numpy:
        magic, bits, n = struct.unpack_from("<IIQ", payload, 0)
        if magic != _QMAGIC or n != count or bits not in _QBITS:
            raise ValueError("malformed quant payload")
        lo, step = struct.unpack_from("<ff", payload, 16)
        n_bytes = -(-count // (8 // bits))
        buf = np.frombuffer(payload, dtype=np.uint8, offset=24, count=n_bytes)
        out = np.zeros(count, dtype=np.float32)
        _load_native().MVTPU_QuantUnpack(
            _ptr(buf, ctypes.c_uint8), count, lo, step, bits,
            _ptr(out, ctypes.c_float))
        return out
    q, lo, step, _bits = _unpack_codes(payload, count)
    return (lo + q.astype(np.float32) * step).astype(np.float32)


def quant_codes(payload: bytes, count: int):
    """Unpack a quant payload's integer codes WITHOUT dequantizing:
    ``(codes float32 (count,), lo, step, bits)``. The compressed-domain
    scoring of the query plane folds lo/step into the score algebra,
    ``dot(q, lo + c*step) = lo*sum(q) + step*(q @ c.T)``. Codes come back
    as float32, exactly: every code is an integer <= 255."""
    q, lo, step, bits = _unpack_codes(payload, count)
    return q.astype(np.float32), lo, step, bits


class QuantizedDelta:
    """An already-encoded quant payload riding as one uint8 blob; the
    server side decodes it back to float32 before ``process_add``."""

    __slots__ = ("payload", "shape")

    def __init__(self, payload: bytes, shape) -> None:
        self.payload = payload
        self.shape = tuple(shape)


class ErrorFeedback:
    """Client-side residual accumulator for quantized pushes: each delta
    is quantized TOGETHER with the residual of all previous quantization
    errors for the touched rows, and the new error replaces it (the 1-bit
    SGD recipe, at 1/2/4/8 bits)."""

    def __init__(self, shape, bits: int) -> None:
        self.residual = np.zeros(shape, np.float32)
        self.bits = int(bits)

    def compress(self, values: np.ndarray, ids=None) -> QuantizedDelta:
        values = np.asarray(values, np.float32)
        if ids is None:
            x = values.reshape(self.residual.shape) + self.residual
        else:
            # explicit trailing dims: reshape(0, -1) rejects empty batches
            x = (values.reshape((len(ids),) + self.residual.shape[1:])
                 + self.residual[np.asarray(ids, np.int64)])
        payload = quant_encode(x, self.bits)
        dec = quant_decode(payload, x.size).reshape(x.shape)
        if ids is None:
            self.residual = x - dec
        else:
            self.residual[np.asarray(ids, np.int64)] = x - dec
        return QuantizedDelta(payload, x.shape)
