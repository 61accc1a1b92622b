"""The port's wire codecs (``multiverso_tpu_torch/utils/quantization.py``)
against the JAX package's numpy codecs: the same inputs give the same
bytes, each package decodes the other's payloads, and the error feedback
carries the same residuals. Everything here is exact (bytes, and float32
values decoded from equal bytes)."""

import numpy as np
import pytest

from multiverso_tpu.utils import quantization as jq
from multiverso_tpu_torch.utils import quantization as q

BITS = (1, 2, 4, 8)
# deliberately non-multiples of the per-byte packing factor (8/bits)
LENGTHS = (0, 1, 3, 7, 13, 64, 100, 1023)


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 5).astype(np.float32)
    if n > 4:
        x[::5] = 0.0
    return x


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", LENGTHS)
def test_quant_bytes_identical_and_cross_decode(bits, n):
    x = _data(bits * 1000 + n, n)
    payload = q.quant_encode(x, bits)
    assert payload == jq.quant_encode(x, bits, force_numpy=True)
    dec = q.quant_decode(payload, n)
    np.testing.assert_array_equal(dec, jq.quant_decode(payload, n,
                                                       force_numpy=True))
    assert dec.dtype == np.float32 and dec.shape == (n,)
    if n:
        step = np.frombuffer(payload, np.float32, 1, offset=20)[0]
        assert np.abs(dec - x).max() <= step / 2 + 1e-6
    assert len(payload) == 24 + -(-n * bits // 8)
    codes, lo, step, got_bits = q.quant_codes(payload, n)
    want = jq.quant_codes(payload, n)
    np.testing.assert_array_equal(codes, want[0])
    assert (lo, step, got_bits) == want[1:]


@pytest.mark.parametrize("n", LENGTHS)
def test_sparse_bytes_identical_and_cross_decode(n):
    for x in (_data(n, n), np.zeros(n, np.float32),
              np.where(np.arange(n) % 7 == 0, 1.5, 0.0).astype(np.float32)):
        payload = q.sparse_encode(x)
        assert payload == jq.sparse_encode(x, force_numpy=True)
        np.testing.assert_array_equal(q.sparse_decode(payload, n), x)
        np.testing.assert_array_equal(
            jq.sparse_decode(payload, n, force_numpy=True), x)


@pytest.mark.parametrize("bits", BITS)
def test_quant_constant_and_extreme_values(bits):
    c = np.full(33, -7.25, np.float32)
    np.testing.assert_array_equal(q.quant_decode(q.quant_encode(c, bits), 33), c)
    x = np.array([-100.0, 100.0] + [0.0] * 9, np.float32)
    dec = q.quant_decode(q.quant_encode(x, bits), len(x))
    assert dec[0] == -100.0
    assert dec[1] == pytest.approx(100.0, abs=1e-3)


def test_malformed_payloads_raise_and_native_is_absent():
    # the name predates the native codecs: the library is built at first
    # use now, and the malformed payloads raise on both paths
    assert q.native_available() is True
    with pytest.raises(ValueError):
        q.quant_decode(q.quant_encode(np.ones(8, np.float32), 4,
                                      force_numpy=True), 9, force_numpy=True)
    x = np.ones(8, np.float32)
    with pytest.raises(ValueError):
        q.quant_encode(x, 3)
    payload = q.quant_encode(x, 4)
    with pytest.raises(ValueError):
        q.quant_decode(payload, 9)
    with pytest.raises(ValueError):
        q.quant_decode(b"\x00" * len(payload), 8)
    with pytest.raises(ValueError):
        q.quant_codes(payload, 7)
    with pytest.raises(ValueError):
        q.sparse_decode(q.sparse_encode(x), 9)


@pytest.mark.parametrize("bits", BITS)
def test_error_feedback_matches_jax(bits):
    """Dense and row-addressed pushes: the same payloads and residuals."""
    rng = np.random.default_rng(bits)
    ours, ref = q.ErrorFeedback((10, 6), bits), jq.ErrorFeedback((10, 6), bits)
    for step in range(6):
        if step % 2:
            ids = rng.choice(10, 4, replace=False)
            vals = rng.normal(size=(4, 6)).astype(np.float32)
        else:
            ids = None
            vals = rng.normal(size=(10, 6)).astype(np.float32)
        a, b = ours.compress(vals, ids), ref.compress(vals, ids)
        assert isinstance(a, q.QuantizedDelta)
        assert a.payload == b.payload and a.shape == b.shape
        np.testing.assert_array_equal(ours.residual, ref.residual)
    empty = ours.compress(np.zeros((0, 6), np.float32), ids=[])
    assert empty.shape == (0, 6)
