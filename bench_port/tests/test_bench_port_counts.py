"""The yardstick's counts at sizes checked by hand."""

import numpy as np
import pytest

import counts
import peaks


def test_row_bytes():
    ids = np.array([3, 3, 7], np.int32)
    # 2 distinct rows of 2 floats: delta, row read, row write, id
    assert counts.add_bytes(ids, 2) == 2 * (3 * 8 + 4)
    # 3 ids read, 2 rows read, 3 rows written
    assert counts.get_bytes(ids, 2) == 3 * 4 + 2 * 8 + 3 * 8


def test_pairs_per_center_by_hand():
    # window 1, chunk 4: positions have 1, 2, 2, 1 neighbours
    assert counts.pairs_per_center(1, 4) == pytest.approx(6 / 4)
    # window 2, chunk 3: b=1 -> 1,2,1; b=2 -> 2,2,2; mean over b then t
    assert counts.pairs_per_center(2, 3) == pytest.approx((4 + 6) / 2 / 3)
    # a long chunk tends to window + 1
    assert counts.pairs_per_center(5, 8192) == pytest.approx(6, rel=2e-3)


def test_sgns_flops_and_bytes():
    # 10 centres, window 1, chunk 2 (1 pair each), 2 negatives, dim 3
    assert counts.sgns_flops(10, 1, 2, 3, 2) == 6 * 3 * (10 + 20)
    keep = np.array([1.0, 0.5], np.float32)
    assert counts.kept_tokens(np.array([0, 1, 1]), keep) == 2.0
    assert counts.sgns_bytes([np.array([1, 1, 2])], 3) == 2 * 2 * 2 * 3 * 4


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_s(67e12, 6.7e12) == pytest.approx(2.0)
