"""Categorical sampling for embedding training (port of
``multiverso_tpu/ops/sampling.py``).

The alias method (Walker 1977): one uniform index picks a bucket, a second
uniform chooses between the bucket's resident and its alias — O(1) per
draw. The table is built on the host in numpy (the same code as the JAX
package's, so both build identical tables); the draws run in torch on the
table's device from an explicit ``torch.Generator``. JAX's threefry bits
and torch's generator differ, so a sampler also takes precomputed indices
and uniforms: tests push the same draws through both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.parallel import mesh as mesh_lib


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side O(V) construction: returns (threshold, alias) arrays.

    Draw: ``i ~ U{0..V-1}; u ~ U[0,1); sample = i if u < threshold[i] else
    alias[i]``.
    """
    probs = np.asarray(probs, dtype=np.float64)
    v = len(probs)
    probs = probs / probs.sum()
    scaled = probs * v
    threshold = np.zeros(v, dtype=np.float32)
    alias = np.zeros(v, dtype=np.int32)
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    work = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        threshold[s] = work[s]
        alias[s] = l
        work[l] -= 1.0 - work[s]
        (small if work[l] < 1.0 else large).append(l)
    for i in large + small:  # numerical leftovers: always accept
        threshold[i] = 1.0
        alias[i] = i
    return threshold, alias


class AliasSampler:
    """``sampler(shape, generator)`` -> int64 ids on the sampler's device,
    drawn from ``probs`` (unnormalised). ``sampler.pick(idx, u)`` maps
    given bucket indices and uniforms to ids, for injected draws."""

    def __init__(self, probs: np.ndarray, device: torch.device) -> None:
        threshold, alias = build_alias_table(probs)
        self.size = len(threshold)
        self.threshold = torch.from_numpy(threshold).to(device)
        self.alias = torch.from_numpy(alias).to(device, torch.int64)
        self.device = torch.device(device)

    def pick(self, idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        idx = idx.to(self.device, torch.int64)
        u = u.to(self.device, torch.float32)
        return torch.where(u < self.threshold[idx], idx, self.alias[idx])

    def __call__(self, shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        idx = torch.randint(0, self.size, shape, generator=generator,
                            device=self.device)
        u = torch.rand(shape, generator=generator, device=self.device)
        return self.pick(idx, u)


def make_alias_sampler(probs: np.ndarray, device="cuda") -> AliasSampler:
    """A sampler on ``device``: ``cuda`` unless the CPU is asked for."""
    return AliasSampler(probs, mesh_lib.build_device(str(device)))


def unigram_negative_sampler(counts: np.ndarray, power: float = 0.75,
                             device="cuda") -> AliasSampler:
    """The word2vec negative distribution: counts^0.75, alias-sampled."""
    p = np.asarray(counts, dtype=np.float64) ** power
    return make_alias_sampler(p, device)
