"""Latent Dirichlet Allocation by block-stale collapsed Gibbs sampling on
parameter-server tables — the lightLDA shape (port of
``multiverso_tpu/models/lda.py``).

The word-topic counts live in a shared ``matrix`` table that workers pull
candidate rows from and push count deltas to, and the topic totals in a
small ``array`` table, as in the JAX package. On the card every pull runs
the row-gather kernel and every push the row-scatter kernel
(``ops/rows.py``); the sweep itself is plain torch ops on the table's
device, as it is XLA ops (not a Pallas kernel) in the reference.

One Gibbs SWEEP over a block of documents rebuilds the doc-topic counts
from the current assignments with exact self-exclusion, evaluates every
token's conditional ``(N_dk - self + α)(N_wk + β)/(N_k + Vβ)`` in log
space, and draws new topics with the Gumbel-argmax trick. Tokens sample
against the block-start table snapshot (the stale/Jacobi approximation
every distributed LDA uses).

Differences from the JAX package:

* The uniform draws come from a ``torch.Generator`` on the table's device,
  seeded from ``config.seed``; ``draw_hook(sweep_index, shape) -> u``
  (or the sweep's ``uniform=`` argument) injects others, so parity tests
  push JAX's draws through both packages.
* The count deltas are summed with one ``index_add_`` of +1 / -1 per live
  token on the flattened ``(R, K)`` delta instead of a row scatter of the
  ``(D*L, K)`` one-hot difference: the same integer-valued sums, without
  the ``(D, L, K)`` difference tensor.
* An in-process worker pushes its word-topic delta from the device
  (``add_device_async``); the reference reads it to the host first.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch import log
from multiverso_tpu_torch.parallel import mesh as mesh_lib

#: ``draw_hook(sweep_index, shape) -> u``: uniform draws in ``[1e-10, 1)``
#: of the sweep's ``(D, L, K)`` shape, for sweep ``sweep_index`` (from 0).
DrawHook = Callable[[int, tuple], object]

#: The smallest uniform draw (``jax.random.uniform``'s ``minval`` in the
#: reference), so ``-log(-log(u))`` stays finite.
U_MIN = 1e-10


class LDAConfig:
    def __init__(self, vocab_size: int, num_topics: int, alpha: float = 0.5,
                 beta: float = 0.1, seed: int = 0) -> None:
        self.vocab_size = int(vocab_size)
        self.num_topics = int(num_topics)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.seed = int(seed)


def uniform_draws(shape, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """Uniform draws in ``[U_MIN, 1)`` the way ``jax.random.uniform``
    spreads its ``[0, 1)`` floats over ``[minval, maxval)``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u.mul_(1.0 - U_MIN).add_(U_MIN).clamp_min_(U_MIN)


def _make_sweep(config: LDAConfig, device="cuda"):
    """One block Gibbs sweep on ``device`` (``cuda`` unless the caller asks
    for the CPU): ``(wt_rows (R, K), nk (K,), slots (D, L) compact
    word-slot ids with -1 pad, z (D, L), uniform=None, generator=None) ->
    (z_new, d_wt (R, K), d_nk (K,), moved)``. ``uniform`` ((D, L, K)
    float32 in ``[1e-10, 1)``) overrides the draws from ``generator``.
    Every input must already be on ``device``."""
    dev = mesh_lib.build_device(str(device))
    K = config.num_topics
    alpha, beta = config.alpha, config.beta
    v_beta = config.vocab_size * beta

    def sweep(wt_rows, nk, slots, z, uniform=None, generator=None):
        D, L = slots.shape
        live = slots >= 0
        livef = live.to(torch.float32)
        slot_safe = slots.clamp_min(0).long()
        z64 = z.long()
        # doc-topic counts with exact self-exclusion: every term is an
        # integer, and alpha is added last, in the reference's order
        doc_counts = torch.zeros((D, K), dtype=torch.float32, device=dev)
        doc_counts.scatter_add_(1, z64, livef)
        logp = doc_counts[:, None, :].expand(D, L, K).contiguous()
        del doc_counts
        logp.scatter_add_(2, z64[..., None], -livef[..., None])
        logp.add_(alpha).log_()
        wt = wt_rows[slot_safe]                            # (D, L, K)
        logp.add_(wt.add_(beta).log_())
        del wt
        logp.sub_(torch.log(nk + v_beta))
        if uniform is None:
            g = uniform_draws((D, L, K), generator, dev)
        else:
            g = uniform.to(dev, torch.float32).clone()
        logp.add_(g.log_().neg_().log_().neg_())
        del g
        z_new = torch.where(live, logp.argmax(dim=-1), z64)
        del logp
        # count deltas in the COMPACT row space (R rows): +1 at each live
        # token's new topic, -1 at its old one; integer-valued, so the
        # order of the additions cannot change the sums
        R = wt_rows.shape[0]
        d_wt = torch.zeros(R * K, dtype=torch.float32, device=dev)
        flat_slots = slot_safe[live]
        d_wt.index_add_(0, flat_slots * K + z_new[live],
                        torch.ones(flat_slots.shape, dtype=torch.float32,
                                   device=dev))
        d_wt.index_add_(0, flat_slots * K + z64[live],
                        torch.full(flat_slots.shape, -1.0,
                                   dtype=torch.float32, device=dev))
        d_wt = d_wt.view(R, K)
        d_nk = d_wt.sum(dim=0)
        moved = (live & (z_new != z64)).sum()
        return z_new.to(torch.int32), d_wt, d_nk, moved

    return sweep


class PSGibbsLDA:
    """Block-parallel collapsed Gibbs LDA over shared tables.

    ``docs`` is a list of int32 token arrays. Call :meth:`sweep` per
    iteration; word-topic state lives in the tables, assignments ``z``
    locally (lightLDA kept z local per worker the same way)."""

    def __init__(self, config: LDAConfig, docs, pad_to: Optional[int] = None,
                 tables=None, z: Optional[np.ndarray] = None,
                 device: Optional[str] = None) -> None:
        """``tables=(word_topic, topic_counts)`` shares existing tables —
        the multi-worker topology: each worker owns a doc shard and its
        local ``z``, all push count deltas into the SAME tables (lightLDA's
        data-parallel shape). ``z`` starts from given assignments (for
        example a JAX instance's, see ``convert.lda_state_from_jax``)
        instead of the seeded draw. The sweep runs on the word-topic
        table's device; ``device`` names it for tables that live in
        another process (``cuda`` unless the CPU is asked for)."""
        import multiverso_tpu_torch as mvt
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        K = config.num_topics
        L = pad_to or max(len(d) for d in docs)
        D = len(docs)
        self.tokens = np.full((D, L), -1, np.int32)
        for i, d in enumerate(docs):
            if len(d) > L:
                log.fatal("doc %d longer (%d) than pad_to %d", i, len(d), L)
            self.tokens[i, : len(d)] = d
        self.z = self.rng.integers(0, K, size=(D, L)).astype(np.int32)
        if z is not None:
            z = np.asarray(z, dtype=np.int32)
            if z.shape != self.tokens.shape:
                log.fatal("z of shape %s for tokens of shape %s", z.shape,
                          self.tokens.shape)
            self.z = z.copy()
        self.z[self.tokens < 0] = 0

        # shared state: word-topic matrix (candidate-row pulls) + totals
        if tables is not None:
            self.word_topic, self.topic_counts = tables
        else:
            self.word_topic = mvt.create_table(
                "matrix", config.vocab_size, K, np.float32)
            self.topic_counts = mvt.create_table("array", K, np.float32)
        server = getattr(self.word_topic, "_server_table", None)
        if device is None and server is not None:
            self.device = server.device
        else:
            self.device = mesh_lib.build_device(str(device or "cuda"))

        # seed the tables with the initial assignment counts (master push)
        live = self.tokens >= 0
        init_wt = np.zeros((config.vocab_size, K), np.float32)
        np.add.at(init_wt, (self.tokens[live], self.z[live]), 1.0)
        nz = np.nonzero(init_wt.any(axis=1))[0].astype(np.int32)
        self.word_topic.add(init_wt[nz], row_ids=nz)
        self.topic_counts.add(init_wt.sum(axis=0))

        self._sweep = _make_sweep(config, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.draw_hook: Optional[DrawHook] = None
        self.sweeps_done = 0
        self._device_io = getattr(self.word_topic, "supports_device_io",
                                  False)
        #: host seconds of the last sweep's phases: pull, sweep, push
        self.last_timings: Dict[str, float] = {}

    def candidate_slots(self):
        """``(words, slots)``: the block's distinct words (the rows a sweep
        pulls and pushes) and every token's index into them (-1 pads)."""
        words = np.unique(self.tokens[self.tokens >= 0]).astype(np.int32)
        # compact slot remap (candidate rows only — the PS contract)
        lut = np.full(self.config.vocab_size, -1, np.int32)
        lut[words] = np.arange(len(words), dtype=np.int32)
        slots = np.where(self.tokens >= 0, lut[np.maximum(self.tokens, 0)],
                         -1).astype(np.int32)
        return words, slots

    def sweep(self) -> int:
        """One Gibbs sweep over every document block; returns how many
        tokens changed topic (the mixing signal)."""
        K = self.config.num_topics
        dev = self.device
        t0 = time.perf_counter()
        words, slots = self.candidate_slots()

        if self._device_io:
            h = self.word_topic.get_device_async(words)
            # (bucket, padded_cols): rows past len(words) are sentinel
            # copies; no slot points at them
            wt_rows = self.word_topic.wait_device(h, words)[:, :K]
        else:
            wt_rows = torch.from_numpy(
                np.asarray(self.word_topic.get(words), np.float32)).to(dev)
        nk = torch.from_numpy(np.asarray(
            self.topic_counts.get(), np.float32)[:K].copy()).to(dev)
        t1 = time.perf_counter()

        D, L = self.tokens.shape
        uniform = None
        if self.draw_hook is not None:
            uniform = torch.as_tensor(
                np.array(self.draw_hook(self.sweeps_done, (D, L, K))),
                dtype=torch.float32).to(dev)
        z_new, d_wt, d_nk, moved = self._sweep(
            wt_rows, nk, torch.from_numpy(slots).to(dev),
            torch.from_numpy(self.z).to(dev), uniform=uniform,
            generator=self.generator)
        self.sweeps_done += 1
        # a host copy of its own: the reference's np.asarray of a jax array
        self.z = np.array(z_new.cpu().numpy(), dtype=np.int32, copy=True)
        d_nk_host = d_nk.cpu().numpy()
        moved = int(moved)
        t2 = time.perf_counter()

        # push deltas for the candidate rows only
        n = len(words)
        if self._device_io:
            self.word_topic.wait(
                self.word_topic.add_device_async(d_wt[:n], words))
        else:
            self.word_topic.add(d_wt[:n].cpu().numpy(), row_ids=words)
        self.topic_counts.add(d_nk_host)
        t3 = time.perf_counter()
        self.last_timings = {"pull": t1 - t0, "sweep": t2 - t1,
                             "push": t3 - t2}
        return moved

    def run(self, sweeps: int, verbose: bool = False) -> None:
        for i in range(sweeps):
            moved = self.sweep()
            if verbose:
                log.info("lda sweep %d: %d tokens moved", i + 1, moved)

    # -- posterior summaries ------------------------------------------------
    def word_topic_counts(self) -> np.ndarray:
        return np.asarray(self.word_topic.get())[:, : self.config.num_topics]

    def doc_topics(self) -> np.ndarray:
        """Per-doc dominant topic from the local assignments."""
        K = self.config.num_topics
        live = self.tokens >= 0
        counts = np.zeros((len(self.tokens), K), np.int64)
        for k in range(K):
            counts[:, k] = ((self.z == k) & live).sum(axis=1)
        return counts.argmax(axis=1)


def synthetic_corpus(vocab: int, topics: int, docs: int, doc_len: int,
                     seed: int = 0, sharpness: float = 0.95):
    """Planted-topic corpus: the vocab splits into ``topics`` equal word
    clusters; each doc draws from one cluster with prob ``sharpness``.
    Returns (docs list, true doc labels)."""
    rng = np.random.default_rng(seed)
    per = vocab // topics
    labels = rng.integers(0, topics, size=docs)
    out = []
    for t in labels:
        own = rng.random(doc_len) < sharpness
        cluster = np.where(own, t, rng.integers(0, topics, size=doc_len))
        toks = cluster * per + rng.integers(0, per, size=doc_len)
        out.append(toks.astype(np.int32))
    return out, labels


def purity(pred: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Cluster purity of predicted doc topics against planted labels."""
    total = 0
    for t in range(k):
        members = labels[pred == t]
        if len(members):
            total += np.bincount(members, minlength=k).max()
    return total / len(labels)
