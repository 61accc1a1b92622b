"""The server tables' device-to-host read (``ServerTable._host_read``): a
fresh C-contiguous copy with the logical shape, dtype and values, that no
later in-place change shows through, and its counters. From a CUDA
device the read lands in page-locked memory from PyTorch's caching host
allocator, which the replies of whole-table Gets reuse once dropped; a
read under ``_PINNED_READ_MIN_BYTES`` stays pageable.

The tests marked ``card`` need a CUDA card and skip here; on the card,
where there is no JAX, run them without this directory's conftest:
``python -m pytest --noconftest -q tests/test_torch_host_read.py``. This
file imports no JAX.
"""

import numpy as np
import pytest
import torch

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch.config import FLAGS
from multiverso_tpu_torch.dashboard import Dashboard
from multiverso_tpu_torch.tables import base
from multiverso_tpu_torch.tables.base import ServerTable

#: 1.6 MB a whole-table read: above the page-locked path's least read
ROWS, COLS = 8192, 50


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the page-locked read is CUDA's")
    return torch.device(request.param)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the page-locked read is CUDA's")
    return torch.device("cuda", 0)


@pytest.fixture
def port():
    """Starts the port's runtime on a device with one matrix table of ROWS
    x COLS float32; stopped after the test."""
    FLAGS.reset()

    def start(device):
        mvt.init(device=str(device))
        table = mvt.create_table("matrix", ROWS, COLS, np.float32)
        Dashboard.reset()
        return table

    try:
        yield start
    finally:
        if mvt.Zoo.instance().started:
            mvt.shutdown()
        FLAGS.reset()


def _padded_rows(device, rows=6000):
    """Rows padded to 52 columns read as their logical 50, as a matrix
    table stores them: 1.2 MB."""
    full = torch.arange(rows * 52, dtype=torch.float32, device=device)
    return full.reshape(rows, 52), (slice(None), slice(0, 50))


def _small_padded_rows(device):
    """8 KB: under the page-locked path's least read."""
    return _padded_rows(device, rows=40)


def _strided_array(device):
    """Every third of 420,003 int64s: 1.12 MB."""
    return (torch.arange(420_003, dtype=torch.int64, device=device),
            slice(1, None, 3))


def _empty_rows(device):
    return torch.zeros((8, 52), dtype=torch.float32, device=device), slice(0, 0)


VIEWS = {"padded_rows": _padded_rows, "small_padded_rows": _small_padded_rows,
         "strided_array": _strided_array, "empty_rows": _empty_rows}


def _page_locked(host):
    return isinstance(host.base, torch.Tensor) and host.base.is_pinned()


def _takes_page_locked_path(src):
    return src.is_cuda and src.nbytes >= base._PINNED_READ_MIN_BYTES


@pytest.fixture(params=sorted(VIEWS))
def view(request, device):
    """(source tensor, index): a view that is not C-contiguous, or empty."""
    Dashboard.reset()
    return VIEWS[request.param](device)


def test_read_is_a_contiguous_copy_of_the_view(view):
    src, index = view
    host = ServerTable._host_read(src[index])
    want = src[index].cpu().numpy()
    assert host.flags["C_CONTIGUOUS"]
    assert host.shape == want.shape and host.dtype == want.dtype
    np.testing.assert_array_equal(host, want)


def test_read_does_not_alias_its_source(view):
    src, index = view
    host = ServerTable._host_read(src[index])
    before = host.copy()
    src.add_(1)
    if src.is_cuda:
        torch.cuda.synchronize()
    np.testing.assert_array_equal(host, before)
    assert not np.shares_memory(host, src.cpu().numpy())


def test_read_counts_its_bytes(view):
    src, index = view
    host = ServerTable._host_read(src[index])
    ServerTable._host_read(src[index])
    assert Dashboard.counter_value("SERVER_HOST_READ_BYTES") == 2 * host.nbytes
    assert Dashboard.watch("SERVER_HOST_READ").count == 2


def test_read_counts_page_locked_bytes_on_a_card_only(view):
    src, index = view
    host = ServerTable._host_read(src[index])
    through_pinned = _takes_page_locked_path(src[index])
    assert _page_locked(host) == through_pinned
    pinned = Dashboard.counter_value("SERVER_HOST_READ_PINNED_BYTES")
    assert pinned == (host.nbytes if through_pinned else 0)
    if not through_pinned:
        assert Dashboard.counter_value("SERVER_HOST_READ_PIN_NEW") == 0


# -- whole-table Gets through the dispatcher ----------------------------------

def _delta(seed):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, COLS)).astype(np.float32)


def test_held_reply_keeps_its_values_across_an_add_and_a_get(port, device):
    table = port(device)
    first = _delta(1)
    table.add(first)
    held = table.get()
    np.testing.assert_array_equal(held, first)
    table.add(_delta(2))
    later = table.get()
    np.testing.assert_array_equal(held, first)
    np.testing.assert_allclose(later, first + _delta(2), rtol=1e-6)


def test_live_replies_share_no_memory(port, device):
    table = port(device)
    replies = []
    for seed in range(3):
        table.add(_delta(seed))
        replies.append(table.get())
    for i, a in enumerate(replies):
        for b in replies[i + 1:]:
            assert not np.shares_memory(a, b)
    want = np.zeros((ROWS, COLS), np.float32)
    for seed, reply in enumerate(replies):
        want += _delta(seed)
        np.testing.assert_allclose(reply, want, rtol=1e-6, atol=1e-6)


def test_whole_get_counts_rows_times_columns(port, device):
    table = port(device)
    for _ in range(3):
        table.get()
    read = 3 * ROWS * COLS * 4
    assert Dashboard.counter_value("SERVER_HOST_READ_BYTES") == read
    assert (Dashboard.counter_value("SERVER_HOST_READ_PINNED_BYTES")
            == (read if device.type == "cuda" else 0))


@pytest.mark.card
def test_whole_get_reply_is_page_locked(port, card):
    table = port(card)
    reply = table.get()
    assert _page_locked(reply)
    assert reply.flags["C_CONTIGUOUS"] and reply.shape == (ROWS, COLS)


@pytest.mark.card
def test_dropped_replies_reuse_their_page_locked_block(port, card):
    table = port(card)
    table.get()  # dropped: its block goes back to the cache
    after_first = Dashboard.counter_value("SERVER_HOST_READ_PIN_NEW")
    for _ in range(19):
        table.get()
    assert Dashboard.counter_value("SERVER_HOST_READ_PIN_NEW") - after_first <= 1
