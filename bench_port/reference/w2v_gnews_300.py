"""Plain reference for ``w2v_gnews_300``: skip-gram with negative sampling
as the configuration states it, written out pair by pair in plain PyTorch
on whole tables. It imports nothing of the program; what it shares with
the program it copies (the word2vec subsampling formula, the alias
construction of the pool of negatives) and freezes here.

One step trains one chunk of ``chunk`` tokens, all of its updates taken
from the weights before the step:

* a kept token ``x[t]`` is a centre; its pairs are the kept tokens
  ``x[t+o]`` of the same chunk with ``0 < |o| <= win[t]``; a centre with
  no pair is inactive;
* centres ``t`` with ``t // group`` alike share ``negatives`` negative
  words; each centre scores them once, and each of its pairs counts that
  term once (the gradient and the loss take it ``npairs[t]`` times);
* the loss is the mean of ``-log sigma(+-score)`` over every pair's
  1 + ``negatives`` terms;
* a row's step is clamped: where ``lr`` times its occurrences (pairs)
  passes ``max_row_step``, its summed step is scaled down to that.

A submission of the PS trainer subsamples its tokens with the trainer's
seeded generator, draws a pool of 16,384 negatives from counts^0.75 with
it, and trains 8,192-token chunks, its negatives drawn as indices into
that pool; its loss weighs each chunk by its pairs. A block of the
device trainer subsamples likewise and trains 8,192-token chunks, its
negatives drawn as word ids; its loss is the chunks' mean.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

POOL = 16384  # the PS trainer's cap on a submission's pool of negatives


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def decayed_lr(lr0: float, words_trained: int, total_words: int) -> float:
    """word2vec's linear learning-rate decay over the planned words:
    lr0 * (1 - words_trained / (total_words + 1)), floored at lr0 * 1e-4."""
    return lr0 * max(1.0 - words_trained / (float(total_words) + 1.0), 1e-4)


def keep_probs(counts: np.ndarray, sample: float) -> np.ndarray:
    """word2vec's subsampling: keep a word of frequency f with probability
    min(1, sqrt(s / f) + s / f)."""
    freq = counts.astype(np.float64) / counts.sum()
    keep = np.minimum(1.0, np.sqrt(sample / np.maximum(freq, 1e-12))
                      + sample / np.maximum(freq, 1e-12))
    return keep.astype(np.float32)


def alias_table(probs: np.ndarray):
    """Walker's alias table, built as the trainer builds its pool sampler:
    (threshold float32, alias int32); a draw keeps bucket ``i`` when its
    uniform is below ``threshold[i]`` and takes ``alias[i]`` otherwise."""
    probs = np.asarray(probs, dtype=np.float64)
    v = len(probs)
    scaled = probs / probs.sum() * v
    threshold = np.zeros(v, dtype=np.float32)
    alias = np.zeros(v, dtype=np.int32)
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    work = scaled.copy()
    while small and large:
        s = small.pop()
        g = large.pop()
        threshold[s] = work[s]
        alias[s] = g
        work[g] -= 1.0 - work[s]
        (small if work[g] < 1.0 else large).append(g)
    for i in large + small:
        threshold[i] = 1.0
        alias[i] = i
    return threshold, alias


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest), as a
    TF32 product takes its inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """The reference trainer over whole tables of ``dtype`` on ``device``.
    ``tf32`` rounds the inputs of every product to TF32 (the control: the
    card's libraries may pick full float32 kernels for these small inner
    sizes whatever the TF32 switch says, so the rounding is done here);
    ``half`` leaves out the second half of every chunk's tokens (a
    planted fault)."""

    def __init__(self, config: dict, counts: np.ndarray, device,
                 dtype: torch.dtype = torch.float64, tf32: bool = False,
                 half: bool = False) -> None:
        self.cfg = config
        self.counts = counts
        self.device = torch.device(device)
        self.dtype, self.tf32, self.half = dtype, tf32, half
        self.keep = keep_probs(counts, config["sample"])
        self.window, self.negatives = config["window"], config["negatives"]
        self.group, self.lr = config["neg_sharing"], config["lr"]
        self.cap = config["max_row_step"]
        self._alias = None

    # -- one step ---------------------------------------------------------
    def step(self, w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor,
             win: torch.Tensor, negs: torch.Tensor, lr: float):
        """Train one chunk ``x`` (word ids, -1 for none) in place; returns
        (loss, pairs) as Python numbers."""
        dev, dt = w_in.device, w_in.dtype
        T, D = x.shape[0], w_in.shape[1]
        G, K = self.group, self.negatives
        if self.half:
            x = x.clone()
            x[T // 2:] = -1
        valid = x >= 0
        xs = x.clamp(min=0)
        centre, context = [], []
        for o in range(-self.window, self.window + 1):
            if o == 0:
                continue
            t = torch.arange(max(0, -o), min(T, T - o), device=dev)
            ok = valid[t] & valid[t + o] & (win[t] >= abs(o))
            centre.append(t[ok])
            context.append(t[ok] + o)
        tp, cp = torch.cat(centre), torch.cat(context)
        pairs = tp.numel()
        npairs = torch.bincount(tp, minlength=T).to(dt)
        p = to_tf32 if self.tf32 else (lambda t: t)
        v = w_in[xs]                                         # (T, D)
        u_pos = w_out[xs[cp]]                                # (P, D)
        s_pos = torch.einsum("pd,pd->p", p(v[tp]), p(u_pos))
        g_pos = torch.sigmoid(s_pos) - 1.0
        vg = v.view(T // G, G, D)
        u_neg = w_out[negs]                                  # (T/G, K, D)
        s_neg = torch.einsum("gcd,gkd->gck", p(vg), p(u_neg))
        npg = npairs.view(T // G, G)
        g_neg = torch.sigmoid(s_neg) * (npg > 0).to(dt)[:, :, None]
        loss = -(F.logsigmoid(s_pos).sum()
                 + (F.logsigmoid(-s_neg).sum(dim=2) * npg).sum()
                 ) / max(pairs * (1 + K), 1)
        grad_v = torch.zeros_like(v).index_add_(0, tp, p(g_pos)[:, None]
                                                * p(u_pos))
        grad_v += npairs[:, None] * torch.einsum(
            "gck,gkd->gcd", p(g_neg), p(u_neg)).reshape(T, D)
        grad_ctx = p(g_pos)[:, None] * p(v[tp])              # to rows xs[cp]
        grad_neg = torch.einsum("gck,gcd,gc->gkd", p(g_neg), p(vg), npg)
        rows = w_in.shape[0]
        in_count = torch.zeros(rows, dtype=dt, device=dev).index_add_(
            0, xs, npairs)
        out_count = torch.zeros(rows, dtype=dt, device=dev)
        out_count.index_add_(0, xs[cp], torch.ones(pairs, dtype=dt, device=dev))
        out_count.index_add_(0, negs.reshape(-1),
                             npg.sum(dim=1).repeat_interleave(K))

        def clamp(count):
            return torch.clamp(self.cap / torch.clamp(lr * count, min=1e-6),
                               max=1.0)

        s_in, s_out = clamp(in_count), clamp(out_count)
        active = npairs > 0
        w_in.index_add_(0, xs[active],
                        (-lr * s_in[xs][:, None] * grad_v)[active])
        w_out.index_add_(0, xs[cp], -lr * s_out[xs[cp]][:, None] * grad_ctx)
        w_out.index_add_(0, negs.reshape(-1), (-lr * s_out[negs][..., None]
                                               * grad_neg).reshape(-1, D))
        return float(loss), pairs

    # -- a submission -------------------------------------------------------
    def pool(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self._alias is None:
            self._alias = alias_table(self.counts.astype(np.float64) ** 0.75)
        threshold, alias = self._alias
        idx = rng.integers(0, len(threshold), size=(n,))
        u = rng.random((n,))
        return np.where(u < threshold[idx], idx, alias[idx]).astype(np.int64)

    def submission(self, w_in, w_out, block: np.ndarray, trainer: str,
                   rng: np.random.Generator,
                   draws: Callable[[int, int, int, Optional[int]], Dict],
                   lr: float) -> float:
        """Train one submission (``trainer`` ``ps``) or block (``device``)
        of raw tokens; ``rng`` is the trainer's generator, ``draws(i, t,
        tg, pool)`` the chunk draws. Returns its loss."""
        block = block[rng.random(len(block)) < self.keep[block]]
        G, W, K = self.group, self.window, self.negatives
        if trainer == "ps":
            n_pool = next_pow2(min(POOL, max(1024, len(block) * W * K)))
            pool = self.pool(rng, n_pool)
            chunk = next_pow2(max(128, self.cfg["batch_pairs"] // max(W, 1)))
            chunk = min(chunk, next_pow2(max(len(block), G)))
            if chunk % G:
                chunk *= G
        else:
            pool, n_pool, chunk = None, None, self.cfg["block_tokens"]
        losses: List[float] = []
        weights: List[int] = []
        for i, lo in enumerate(range(0, len(block), chunk)):
            x = np.full(chunk, -1, np.int64)
            part = block[lo:lo + chunk]
            x[:len(part)] = part
            d = draws(i, chunk, chunk // G, n_pool)
            negs = d["neg"] if pool is None else pool[d["neg"]]
            loss, pairs = self.step(
                w_in, w_out, torch.from_numpy(x).to(self.device),
                torch.from_numpy(np.asarray(d["win"], np.int64)).to(self.device),
                torch.from_numpy(np.asarray(negs, np.int64)).to(self.device),
                lr)
            losses.append(loss)
            weights.append(pairs)
        if not losses:
            return 0.0
        if trainer == "ps":
            return float(np.dot(losses, weights)) / max(sum(weights), 1)
        return float(np.mean(losses))

    def replay(self, w0: torch.Tensor, blocks: List[np.ndarray], trainer: str,
               rng: np.random.Generator, draws_for: Callable[[int], Callable],
               lrs: Optional[List[float]] = None) -> Dict:
        """Train from (w0, zeros) through ``blocks``, a step each, step ``s``
        at ``lrs[s]`` (the configuration's lr where None). Returns the
        losses, each leaf's change after the first step, and the change
        of each leaf after the last (dense, in ``dtype``)."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            w_in = w0.to(self.dtype).clone()
            w_out = torch.zeros_like(w_in)
            losses, first = [], None
            for s, block in enumerate(blocks):
                losses.append(self.submission(w_in, w_out, block, trainer, rng,
                                              draws_for(s),
                                              self.lr if lrs is None else lrs[s]))
                if s == 0:
                    first = [leaf_norm(w_in, w0), leaf_norm(w_out, None)]
            w_in -= w0.to(self.dtype)
            return {"losses": losses, "norms1": first,
                    "delta": [w_in, w_out]}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def leaf_norm(cur: torch.Tensor, base: Optional[torch.Tensor],
              rows: int = 1 << 18) -> float:
    """float64 norm of ``cur - base`` (of ``cur`` where ``base`` is None),
    in blocks of rows."""
    total = 0.0
    for lo in range(0, cur.shape[0], rows):
        d = cur[lo:lo + rows].double()
        if base is not None:
            d = d - base[lo:lo + rows].double()
        total += float((d * d).sum())
    return total ** 0.5
