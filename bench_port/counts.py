"""The bytes and operations that a cell's requests need, counted from the
benchmark's own inputs and never from what the program launches, so that
the yardstick reads the same work whatever kernels do it. Each count is
the least the work needs: every input byte read once, every output byte
written once. A share of a roofline built on it cannot pass 100% unless
the time leaves out part of the work.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

ID_BYTES = 4  # int32 row ids


def add_bytes(ids: np.ndarray, num_col: int, itemsize: int = 4) -> int:
    """A row Add: each distinct row's delta and id read, the row read and
    written once. Duplicate ids sum into one delta before they reach the
    table, so they cost nothing more on the device."""
    unique = len(np.unique(ids))
    return unique * (3 * num_col * itemsize + ID_BYTES)


def get_bytes(ids: np.ndarray, num_col: int, itemsize: int = 4) -> int:
    """A row Get: each id read, each distinct row read once, each reply row
    written once."""
    n = len(ids)
    return n * ID_BYTES + len(np.unique(ids)) * num_col * itemsize \
        + n * num_col * itemsize


def whole_get_bytes(num_row: int, num_col: int, itemsize: int = 4) -> int:
    """A Get of the whole table: each row read once and written out once."""
    return 2 * num_row * num_col * itemsize


def pairs_per_center(window: int, chunk: int) -> float:
    """Expected skip-gram pairs of a kept centre in a full chunk of
    ``chunk`` kept tokens, with the window drawn uniform in [1, window] and
    no pair across the chunk's edges."""
    t = np.arange(chunk)
    total = 0.0
    for b in range(1, window + 1):
        total += (np.minimum(b, t) + np.minimum(b, chunk - 1 - t)).sum()
    return total / window / chunk


def sgns_flops(kept_tokens: float, window: int, negatives: int, dim: int,
               chunk: int) -> float:
    """Operations of skip-gram with negative sampling over ``kept_tokens``
    centres, as the configuration states it: each pair's score and its two
    gradients (3 products of ``dim``, 2 operations each), and each centre's
    ``negatives`` scores and gradients, one negative set a centre shared
    by all its pairs."""
    pairs = kept_tokens * pairs_per_center(window, chunk)
    return 6.0 * dim * (pairs + kept_tokens * negatives)


def kept_tokens(tokens: np.ndarray, keep: np.ndarray) -> float:
    """Expected tokens left after subsampling: the keep probabilities of
    the tokens fed, summed."""
    return float(keep[tokens].astype(np.float64).sum())


def sgns_bytes(blocks: Iterable[np.ndarray], dim: int, tables: int = 2,
               itemsize: int = 4) -> int:
    """Bytes of one pass over each block: every distinct token's row of
    each table read and written once. A block is one submission, whose
    rows stay with the step between its chunks."""
    return sum(2 * tables * len(np.unique(b)) * dim * itemsize
               for b in blocks)
