"""The general traffic generator: every input of every cell, made from the
run's seed by the parameters of its traffic file. The same seed gives the
same inputs; the port and the reference are handed the same ones.

* Cycle traffic: per worker, the upstream perf harness's cycles of a
  whole-table Get, an Add of a share of the rows and a whole-table Get,
  with standard-normal deltas drawn once (so the window draws none).
* Corpus traffic: token ids zipf over the vocabulary's ranks with the
  word counts ``max(1e7 / rank, 5)``, made on the device in one call and
  kept in host memory; the skip-gram step's window sizes and negatives,
  keyed by (submission, chunk) so that their order of use does not matter.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

#: Seed words: each stream of draws is keyed by the run's seed and one of
#: these, so two streams never share draws.
ROWS, POOL, CORPUS, WEIGHTS, CHUNKS = 1, 2, 5, 6, 7


def seed_int(seed: int) -> int:
    """The run's seed as a non-negative integer below 2**63, the range
    every generator here takes."""
    return int(seed) % (1 << 63)


# -- cycle traffic (matrix cells) ----------------------------------------------

class CycleTraffic:
    """The upstream perf harness's cycle on a matrix table: a Get of the
    whole table, an Add of ``percent`` of its rows, a Get of the whole
    table, the percent going through the traffic file's ``percents`` one
    cycle after another. A percent ``n`` adds the rows whose id modulo 10
    is below ``n // 10``. Each worker adds its own standard-normal deltas,
    one block a percent, drawn once on ``device`` from the seed and kept
    in host memory (so the window draws nothing). One Get in
    ``get_sample``, drawn from the seed, keeps its reply for the check."""

    def __init__(self, seed: int, traffic: dict, num_row: int, num_col: int,
                 workers: int, device="cpu") -> None:
        self.seed = seed_int(seed)
        self.num_row, self.num_col = num_row, num_col
        self.percents = [int(n) for n in traffic["percents"]]
        if not all(n % 10 == 0 and 10 <= n <= 100 for n in self.percents):
            raise ValueError(f"percents must be tens in [10, 100]: {self.percents}")
        self.sample = int(traffic["get_sample"])
        kinds = sorted(set(self.percents))
        self.rows = {n: np.flatnonzero(np.arange(num_row) % 10 < n // 10)
                     .astype(np.int32) for n in kinds}
        sizes = [len(self.rows[n]) for n in kinds]
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        self.deltas = []  # per worker: percent -> (rows, num_col) float32
        for w in range(workers):
            gen.manual_seed(self.seed ^ (POOL << 32) ^ w)
            block = torch.randn((sum(sizes), num_col), generator=gen,
                                device=dev, dtype=torch.float32).cpu().numpy()
            parts = np.split(block, np.cumsum(sizes)[:-1])
            self.deltas.append(dict(zip(kinds, parts)))
        self.rngs = [np.random.default_rng([self.seed, ROWS, w])
                     for w in range(workers)]

    def percent(self, cycle: int) -> int:
        return self.percents[cycle % len(self.percents)]

    def keep(self, w: int) -> bool:
        """Whether worker ``w``'s next Get keeps its reply for the check."""
        return bool(self.rngs[w].integers(self.sample) == 0)


# -- corpus traffic (word2vec cells) ---------------------------------------------

def zipf_counts(vocab: int) -> np.ndarray:
    """Word counts ``max(1e7 / rank, 5)`` over ranks 1..vocab: ids are ranks,
    id 0 the most frequent, as a frequency-sorted dictionary has them."""
    return np.maximum((1e7 / np.arange(1, vocab + 1)).astype(np.int64), 5)


def corpus(seed: int, tokens: int, counts: np.ndarray,
           device: torch.device) -> np.ndarray:
    """``tokens`` token ids drawn from ``counts`` (inverse CDF) on
    ``device`` from the seed, returned as host int32."""
    dev = torch.device(device)
    cdf = torch.from_numpy(np.cumsum(counts / counts.sum())).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_int(seed) ^ CORPUS)
    u = torch.rand(tokens, generator=gen, device=dev, dtype=torch.float64)
    ids = torch.clamp(torch.searchsorted(cdf, u, right=True),
                      max=len(counts) - 1)
    return ids.to(torch.int32).cpu().numpy()


def uniform_weights(seed: int, rows: int, dim: int, low: float, high: float,
                    device: torch.device) -> torch.Tensor:
    """A (rows, dim) float32 tensor uniform in [low, high) on ``device``,
    drawn in one call from the seed."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed_int(seed) ^ WEIGHTS)
    return torch.empty((rows, dim), dtype=torch.float32,
                       device=device).uniform_(low, high, generator=gen)


def unigram_cdf(counts: np.ndarray, power: float = 0.75) -> np.ndarray:
    """Cumulative counts**power: word2vec's negative distribution."""
    p = counts.astype(np.float64) ** power
    return np.cumsum(p / p.sum())


class ChunkDraws:
    """The skip-gram step's draws, made from the seed: for chunk ``i`` of
    submission ``s``, window sizes in [1, window] (one a token) and
    ``negatives`` negatives a group of centres. Negatives are indices into
    the submission's pool where the trainer draws one (``pool`` given),
    word ids from ``neg_cdf`` otherwise."""

    def __init__(self, seed: int, window: int, negatives: int,
                 neg_cdf: Optional[np.ndarray] = None) -> None:
        self.seed = seed_int(seed)
        self.window, self.negatives = window, negatives
        self.neg_cdf = neg_cdf

    def draws(self, s: int, i: int, t: int, tg: int,
              pool: Optional[int]) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, CHUNKS, s, i])
        win = rng.integers(1, self.window + 1, t, dtype=np.int64)
        if pool is not None:
            neg = rng.integers(0, pool, (tg, self.negatives), dtype=np.int64)
        else:
            neg = np.minimum(np.searchsorted(
                self.neg_cdf, rng.random((tg, self.negatives)), side="right"),
                len(self.neg_cdf) - 1).astype(np.int64)
        return {"win": win, "neg": neg}

    def hook(self, s: int) -> Callable:
        """The trainer's ``draw_hook`` for submission ``s``."""
        def hook(i, t, tg, pool):
            return self.draws(s, i, t, tg, pool)
        return hook

    def sequential_hook(self) -> Callable:
        """A ``draw_hook`` for submissions 0, 1, ... in the order the
        trainer makes them: each starts at its chunk 0."""
        submission = [-1]

        def hook(i, t, tg, pool):
            if i == 0:
                submission[0] += 1
            return self.draws(submission[0], i, t, tg, pool)
        return hook
