"""Every generator repeats exactly for a seed and differs across seeds."""

import json

import numpy as np
import pytest

from conftest import BENCH
import generate


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _cycles(seed, **changes):
    return generate.CycleTraffic(seed, dict(_traffic("perf_cycle"), **changes),
                                 20000, 50, 4)


def test_cycle_traffic_repeats_for_a_seed():
    seed = 2 ** 31 + 12345  # seeds run past 32 signed bits
    a, b, c = _cycles(seed), _cycles(seed), _cycles(seed + 1)
    for w in range(4):
        for n in a.percents:
            np.testing.assert_array_equal(a.deltas[w][n], b.deltas[w][n])
        assert not np.array_equal(a.deltas[w][50], c.deltas[w][50])
        assert [a.keep(w) for _ in range(50)] == [b.keep(w) for _ in range(50)]
    assert not np.array_equal(a.deltas[0][10], a.deltas[1][10])


def test_cycle_rows_are_the_percent_of_the_table():
    gen = _cycles(3)
    assert [gen.percent(c) for c in range(12)] == [
        10, 20, 30, 40, 50, 60, 70, 80, 90, 100, 10, 20]
    for n in gen.percents:
        rows = gen.rows[n]
        assert rows.dtype == np.int32 and len(rows) == 20000 * n // 100
        assert len(np.unique(rows)) == len(rows) and rows.max() < 20000
        assert gen.deltas[2][n].shape == (len(rows), 50)
    with pytest.raises(ValueError):
        _cycles(3, percents=[15])


def test_corpus_and_weights_repeat_for_a_seed():
    counts = generate.zipf_counts(5000)
    a = generate.corpus(99, 10000, counts, "cpu")
    assert np.array_equal(a, generate.corpus(99, 10000, counts, "cpu"))
    assert not np.array_equal(a, generate.corpus(100, 10000, counts, "cpu"))
    assert a.min() >= 0 and a.max() < 5000 and np.mean(a == 0) > 0.05
    w = generate.uniform_weights(99, 10, 4, -0.5, 0.5, "cpu")
    assert w.equal(generate.uniform_weights(99, 10, 4, -0.5, 0.5, "cpu"))


@pytest.mark.parametrize("pool", [None, 4096])
def test_chunk_draws_keyed_by_submission_and_chunk(pool):
    cdf = generate.unigram_cdf(generate.zipf_counts(1000))
    d = generate.ChunkDraws(5, 5, 5, None if pool else cdf)
    x = d.draws(2, 3, 1024, 128, pool)
    d.draws(0, 0, 1024, 128, pool)  # another key in between changes nothing
    y = d.hook(2)(3, 1024, 128, pool)
    assert all(np.array_equal(x[k], y[k]) for k in x)
    seq = d.sequential_hook()  # submissions in order, each from chunk 0
    for s in range(3):
        for i in range(4):
            z = seq(i, 1024, 128, pool)
    assert all(np.array_equal(d.draws(2, 3, 1024, 128, pool)[k], z[k]) for k in z)
    assert x["win"].min() >= 1 and x["win"].max() <= 5
    assert x["neg"].shape == (128, 5) and x["neg"].max() < (pool or 1000)
