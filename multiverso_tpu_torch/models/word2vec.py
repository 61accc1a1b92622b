"""Word2Vec (skip-gram / CBOW, negative-sampling / hierarchical-softmax) on
torch tensors (port of ``multiverso_tpu/models/word2vec.py``).

Reference capability (not copied): the WordEmbedding app — skip-gram/CBOW
with HS or negative sampling trained against parameter-server matrix tables,
with a block loader and words/sec logging
(``Applications/WordEmbedding/src/{wordembedding,trainer,distributed_wordembedding}.cpp``).

The math is the JAX package's, step for step: the structured block step
(one gather per centre, positive contexts by rolling the block's own
output rows, shared negatives), the pair step with its stability clamp,
and the two trainers. What changes with the framework:

* Each step is eager torch, but for the block step's chunk on a card:
  from token ids and draws to its row deltas it is a chain of four
  hand-written kernels (``ops/sgns.py``, ``csrc/sgns.cu``), where XLA
  fused the JAX step. ``jax.lax.scan`` is a Python loop; steps
  update the parameter tensors in place (``index_add_`` for the
  duplicate-accumulating scatters inside a step) and return them. On CUDA
  ``index_add_`` sums duplicate rows with atomics in a varying order, so
  under a deterministic server (the ``deterministic`` flag, read when a
  step is built) the steps add rows with ``index_put_(accumulate=True)``
  instead: it sorts the ids and sums each id's rows in index order, with
  no atomics, so two runs are bitwise equal (on the CPU both are the same
  serial loop).
* Random draws come from a ``torch.Generator`` on the tables' device.
  JAX's threefry bits differ from torch's, so every step also takes
  injected draws (``draws``), and both trainers take a ``draw_hook``:
  tests push JAX's exact draws through both packages. Host draws
  (subsampling, pair windows of the pair path, the negative pool) stay
  numpy with the same seeds, so they agree with no injection.
* :class:`PSTrainer`'s block transaction runs on the dispatcher thread as
  one function over both tables: the candidate rows come out through
  ``ops.rows.gather_rows`` and both pushes go in through the tables'
  ``row_apply_traceable`` (``scatter_add_rows``, or
  ``scatter_add_rows_coalesced`` with ``rows.COALESCE`` set).

* On remote proxies (``mvt.remote_connect``: ``supports_device_io`` is
  False) :meth:`PSTrainer.submit_block` takes the host branch, as the JAX
  trainer does: host candidate pulls, the pair step on the trainer's own
  device over compact copies, host deltas pushed back. Its draws are all
  host numpy, so the same seeds give the JAX trainer's pairs and
  negatives.

Remote proxies of a client connected with ``read_endpoints`` read through
the read tier (``runtime/read.py``), and a server with the ``wal_dir``
flag logs the pushes, as in the JAX package.

* In a multi-process lockstep world (``runtime/multihost.py``) the fused
  transaction is the named form that rides the lockstep stream, and its
  arguments are host data: the packed ids, and the block step's draws
  made on the host (the hook's, or window sizes and negative slots drawn
  with numpy from ``seed + 1``). A draw made from each rank's
  ``torch.Generator`` would diverge between the ranks' replays. Every rank
  runs the transaction: it gathers the candidate rows it holds, the ranks
  exchange them (``MatrixServer.candidate_rows``), every rank runs the
  block step on the whole candidate set with the same draws, and each
  scatters back only the delta rows it holds
  (``MatrixServer.owned_push``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import multiverso_tpu_torch as mvt
from multiverso_tpu_torch import io as mv_io
from multiverso_tpu_torch import log
from multiverso_tpu_torch.config import get_flag
from multiverso_tpu_torch.dashboard import monitor
from multiverso_tpu_torch.models.vocab import Dictionary, HuffmanEncoder
from multiverso_tpu_torch.obs.devtime import DeviceTime
from multiverso_tpu_torch.ops.rows import ROW_GROUP, gather_rows
from multiverso_tpu_torch.ops.sampling import (build_alias_table,
                                               unigram_negative_sampler)
from multiverso_tpu_torch.ops.sgns import (row_step_scale as _row_step_scale,
                                           scale_from_count as _scale_from_count,
                                           sgns_chunk)
from multiverso_tpu_torch.parallel import mesh as mesh_lib
from multiverso_tpu_torch.runtime.programs import register_program
from multiverso_tpu_torch.runtime.zoo import Zoo
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import async_upload, next_pow2 as _next_pow2

#: ``draw_hook(step, t, tg, pool) -> {"win": (t,), "neg": (tg, K)}``: the
#: random draws of one step. ``step`` counts the steps of one submission
#: (PSTrainer) or one ``train_block`` call (DeviceTrainer) from 0; ``t``
#: is the step's tokens (block step) or pairs (pair step), ``tg`` the rows
#: of negative draws, ``pool`` the slot-alias table's length (PSTrainer's
#: block step) or None. "neg" holds slot indices into that table when
#: ``pool`` is given, vocabulary ids otherwise; "win" (window sizes in
#: ``[1, window]``) is read by the block step only.
DrawHook = Callable[[int, int, int, Optional[int]], Dict[str, np.ndarray]]


@dataclass(frozen=True)
class Word2VecConfig:
    vocab_size: int
    dim: int = 128
    window: int = 5
    negatives: int = 5
    mode: str = "sg"          # "sg" | "cbow"
    objective: str = "ns"     # "ns" | "hs"
    lr: float = 0.025
    batch_pairs: int = 8192   # pairs per device step (pair-mode trainers)
    block_tokens: int = 8192  # tokens per device step (block-mode trainer)
    sample: float = 1e-3      # subsampling threshold
    max_code_length: int = 40
    grad_combine: str = "sum"  # "sum" (bounded per-occurrence SGD) | "mean"
    # Stability bound for "sum": a row whose occurrences would move it more
    # than max_row_step (in units of its mean per-occurrence gradient) gets
    # its batch update clamped to that budget.
    max_row_step: float = 1.0
    # Block-mode negative sharing: one K-sample set serves a group of
    # neg_sharing consecutive centers (1 = per-center).
    neg_sharing: int = 1
    seed: int = 1

    def __post_init__(self):
        if self.grad_combine not in ("sum", "mean"):
            raise ValueError(
                f"grad_combine must be 'sum' or 'mean', got {self.grad_combine!r}")
        if self.neg_sharing < 1:
            raise ValueError(
                f"neg_sharing must be >= 1, got {self.neg_sharing}")
        if self.block_tokens % self.neg_sharing:
            raise ValueError(
                f"neg_sharing {self.neg_sharing} must divide block_tokens "
                f"{self.block_tokens}")


# -- params -----------------------------------------------------------------

def init_params(config: Word2VecConfig,
                device="cuda") -> Dict[str, torch.Tensor]:
    """w_in ~ U(-0.5/dim, 0.5/dim); w_out zeros (word2vec convention), each
    with one sentinel row past the vocabulary. The draws are the JAX
    package's (numpy, ``config.seed``), so both start from the same
    values. The tables go to ``cuda`` unless ``device="cpu"`` is asked
    for."""
    device = mesh_lib.build_device(str(device))
    v = config.vocab_size
    out_rows = v if config.objective == "ns" else max(v - 1, 1)
    rng = np.random.default_rng(config.seed)

    def make(rows: int, random_init: bool) -> torch.Tensor:
        arr = np.zeros((rows + 1, config.dim), dtype=np.float32)
        if random_init:
            arr[:rows] = rng.uniform(-0.5 / config.dim, 0.5 / config.dim,
                                     size=(rows, config.dim))
        return torch.from_numpy(arr).to(device)

    w_in = make(v, random_init=True)
    return {"w_in": w_in, "w_out": make(out_rows, random_init=False)}


# -- the steps ----------------------------------------------------------------

def _as_index(x, device: torch.device) -> torch.Tensor:
    """Injected draws (numpy or torch) as int64 indices on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, torch.int64)


def _ns_targets(contexts: torch.Tensor, negs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids, labels, mask) for negative sampling: 1 positive + K drawn."""
    ids = torch.cat([contexts[:, None], negs], dim=1)               # (B, 1+K)
    labels = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    labels[:, 0] = 1.0
    return ids, labels, torch.ones_like(labels)


def _hs_targets(targets, codes, points, code_mask):
    """(ids, labels, mask) for hierarchical softmax over Huffman paths."""
    ids = points[targets]                                           # (B, L)
    labels = 1.0 - codes[targets].to(torch.float32)                 # (B, L)
    mask = code_mask[targets]                                       # (B, L)
    return ids, labels, mask


def _ordered_adds() -> bool:
    """Whether a step being built adds rows in index order: under the
    ``deterministic`` flag (the deterministic server's contract)."""
    return bool(get_flag("deterministic"))


def _add_rows(table: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor,
              ordered: bool) -> None:
    """In place ``table[ids[i]] += deltas[i]``, duplicate ids included.
    ``ordered`` sums each id's rows in index order without atomics (the
    deterministic server's contract); otherwise ``index_add_``."""
    if ordered:
        table.index_put_((ids,), deltas, accumulate=True)
    else:
        table.index_add_(0, ids, deltas)


def _sgns_core(w_in, w_out, in_ids, in_weights, out_ids, labels, mask, lr,
               combine: str = "sum", max_row_step: float = 1.0,
               ordered: bool = False):
    """Shared gradient core: input rows vs output rows, masked logistic loss.

    in_ids: (B, C) input rows averaged with in_weights (C=1 for skip-gram);
    out_ids/labels/mask: (B, T) output rows and their logistic targets.
    Updates ``w_in``/``w_out`` in place (duplicates accumulate, in index
    order when ``ordered``) and returns (w_in, w_out, loss). The occurrence
    counts sum whole numbers, exact in any order."""
    in_ids = in_ids.long()
    out_ids = out_ids.long()
    v_rows = w_in[in_ids]                                           # (B, C, D)
    v = torch.einsum("bc,bcd->bd", in_weights, v_rows)              # (B, D)
    u = w_out[out_ids]                                              # (B, T, D)
    scores = torch.einsum("bd,btd->bt", v, u)                       # (B, T)
    g = (torch.sigmoid(scores) - labels) * mask                     # (B, T)
    loss = -torch.sum(mask * F.logsigmoid(
        torch.where(labels > 0.5, scores, -scores))) / torch.clamp(mask.sum(), min=1.0)
    grad_v = torch.einsum("bt,btd->bd", g, u)                       # (B, D)
    grad_u = torch.einsum("bt,bd->btd", g, v)                       # (B, T, D)
    grad_rows = torch.einsum("bc,bd->bcd", in_weights, grad_v)      # (B, C, D)
    dim = w_in.shape[1]
    # combine="sum": per-occurrence SGD with the max_row_step clamp;
    # combine="mean": one averaged lr-step per row per batch (see the JAX
    # package's notes on both)
    flat_in = in_ids.reshape(-1)
    flat_out = out_ids.reshape(-1)
    gin = grad_rows.reshape(-1, dim)
    gout = grad_u.reshape(-1, dim)
    if combine == "mean":
        ones_in = torch.ones(flat_in.shape, dtype=v.dtype, device=v.device)
        ones_out = torch.ones(flat_out.shape, dtype=v.dtype, device=v.device)
        in_count = torch.zeros(w_in.shape[0], dtype=v.dtype,
                               device=v.device).index_add_(0, flat_in, ones_in)
        out_count = torch.zeros(w_out.shape[0], dtype=v.dtype,
                                device=v.device).index_add_(0, flat_out, ones_out)
        gin = gin / in_count[flat_in][:, None]
        gout = gout / out_count[flat_out][:, None]
    else:
        in_scale = _row_step_scale(w_in.shape[0], in_ids, in_weights > 0, lr,
                                   max_row_step)
        out_scale = _row_step_scale(w_out.shape[0], out_ids, mask, lr,
                                    max_row_step)
        gin = gin * in_scale[flat_in][:, None]
        gout = gout * out_scale[flat_out][:, None]
    _add_rows(w_in, flat_in, -lr * gin, ordered)
    _add_rows(w_out, flat_out, -lr * gout, ordered)
    return w_in, w_out, loss


def make_train_step(config: Word2VecConfig, dictionary: Dictionary,
                    huffman: Optional[HuffmanEncoder] = None,
                    device="cuda"):
    """The pair step ``step(params, generator, batch, lr, draws=None) ->
    (params, loss)``, updating ``params`` in place.

    batch: for sg — dict(centers (B,), contexts (B,));
           for cbow — dict(centers (B,), context_block (B, 2W) id or -1).
    ``draws`` may carry {"neg": (B, K) vocabulary ids} for ns. The sampler
    and the Huffman arrays live on ``device`` (``cuda`` unless the CPU is
    asked for). Under the ``deterministic`` flag it adds rows in index
    order.
    """
    device = mesh_lib.build_device(str(device))
    ordered = _ordered_adds()
    if config.objective == "ns":
        sampler = unigram_negative_sampler(dictionary.counts, device=device)
        hs_arrays = None
    else:
        if huffman is None:
            huffman = HuffmanEncoder(dictionary.counts, config.max_code_length)
        hs_arrays = (torch.from_numpy(huffman.codes).to(device),
                     torch.from_numpy(huffman.points).to(device, torch.int64),
                     torch.from_numpy(huffman.mask()).to(device))
        sampler = None

    def step(params, generator, batch, lr, draws=None):
        centers = batch["centers"].long()
        if config.mode == "sg":
            in_ids = centers[:, None]
            in_weights = torch.ones(in_ids.shape, dtype=torch.float32,
                                    device=in_ids.device)
            predict = batch["contexts"].long()
        else:  # cbow: average valid context embeddings, predict the center
            ctx = batch["context_block"].long()                     # (B, 2W)
            valid = (ctx >= 0).to(torch.float32)
            in_ids = torch.clamp(ctx, min=0)
            in_weights = valid / torch.clamp(valid.sum(1, keepdim=True), min=1.0)
            predict = centers
        if config.objective == "ns":
            if draws is not None:
                negs = _as_index(draws["neg"], predict.device)
            else:
                negs = sampler((predict.shape[0], config.negatives), generator)
            out_ids, labels, mask = _ns_targets(predict, negs)
        else:
            codes, points, code_mask = hs_arrays
            out_ids, labels, mask = _hs_targets(predict, codes, points, code_mask)
        pair_mask = batch.get("pair_mask")
        if pair_mask is not None:  # tail-padded batch: dead pairs contribute
            in_weights = in_weights * pair_mask[:, None]  # nothing on either
            mask = mask * pair_mask[:, None]              # side of the dot
        w_in, w_out, loss = _sgns_core(params["w_in"], params["w_out"],
                                       in_ids, in_weights, out_ids, labels,
                                       mask, lr, config.grad_combine,
                                       config.max_row_step, ordered)
        return {"w_in": w_in, "w_out": w_out}, loss

    return step


def make_block_train_step(config: Word2VecConfig, dictionary: Dictionary,
                          neg_table: bool = False,
                          device="cuda"):
    """Block-mode step: the host ships ONE int32 token block per step (pad
    with -1); window pair extraction, dynamic-window masking, negative
    sampling and the update all happen on the device.

    ``step(params, generator, block (T,), lr, neg_slots=None,
    with_pairs=False, draws=None) -> (params, loss[, pairs])``, updating
    ``params`` in place. Skip-gram + NS. With ``neg_table`` the negatives
    are uniform draws over ``neg_slots`` (the PS path's slot-alias table);
    otherwise the unigram^0.75 sampler. ``draws`` = {"win": (T,),
    "neg": (T/G, K)} replaces the generator's draws. The sampler lives on
    ``device`` (``cuda`` unless the CPU is asked for). The chunk's deltas
    come from :func:`~multiverso_tpu_torch.ops.sgns.sgns_chunk` (the
    kernels of ``csrc/sgns.cu`` on a card, the eager plain version on the
    CPU) and go in by three scatters; under the ``deterministic`` flag
    they add rows in index order.
    """
    if config.mode != "sg" or config.objective != "ns":
        log.fatal("block step supports sg+ns (the benchmark path)")
    device = mesh_lib.build_device(str(device))
    ordered = _ordered_adds()
    sampler = (None if neg_table
               else unigram_negative_sampler(dictionary.counts, device=device))
    window = config.window
    negatives = config.negatives
    combine = config.grad_combine
    G = config.neg_sharing

    def step(params, generator, block, lr, neg_slots=None, with_pairs=False,
             draws=None):
        w_in, w_out = params["w_in"], params["w_out"]
        dev = w_in.device
        t = block.shape[0]
        if t % G:  # defensive: caller passed a non-config-sized block
            log.fatal("neg_sharing %d must divide block length %d", G, t)
        tg = t // G
        if draws is not None:
            b = _as_index(draws["win"], dev)
            neg = _as_index(draws["neg"], dev)
        else:
            b = torch.randint(1, window + 1, (t,), generator=generator,
                              device=dev)
            neg = (torch.randint(0, neg_slots.shape[0], (tg, negatives),
                                 generator=generator, device=dev)
                   if neg_table else sampler((tg, negatives), generator))
        c = sgns_chunk(w_in, w_out, block.to(dev), b, neg,
                       neg_slots if neg_table else None, lr, window=window,
                       negatives=negatives, group=G, combine=combine,
                       max_row_step=config.max_row_step)
        _add_rows(w_in, c.ids_in, c.d_in, ordered)
        _add_rows(w_out, c.ids_out, c.d_out, ordered)
        _add_rows(w_out, c.ids_neg, c.d_neg, ordered)
        params = {"w_in": w_in, "w_out": w_out}
        if with_pairs:
            return params, c.loss, c.pairs
        return params, c.loss

    return step


def make_corpus_train_step(config: Word2VecConfig, dictionary: Dictionary,
                           device="cuda"):
    """Trains a whole (N, T) stack of token blocks in one call:
    ``step(params, generator, blocks, lr, draws=None) -> (params,
    mean_loss)``, ``draws`` an optional list of per-block draws."""
    block_step = make_block_train_step(config, dictionary, device=device)

    def step(params, generator, blocks, lr, draws=None):
        losses = []
        for i in range(blocks.shape[0]):
            params, loss = block_step(params, generator, blocks[i], lr,
                                      draws=None if draws is None else draws[i])
            losses.append(loss)
        return params, torch.stack(losses).mean()

    return step


# -- host-side pair generation ----------------------------------------------

def subsample_block(block: np.ndarray, keep: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    return block[rng.random(len(block)) < keep[block]]


def generate_sg_pairs(block: np.ndarray, window: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Dynamic-window skip-gram pairs, vectorized over offsets."""
    n = len(block)
    if n < 2:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    b = rng.integers(1, window + 1, size=n)
    centers, contexts = [], []
    for d in range(1, window + 1):
        ok = b >= d
        left = ok[d:]
        centers.append(block[d:][left])
        contexts.append(block[:-d][left])
        right = ok[:-d]
        centers.append(block[:-d][right])
        contexts.append(block[d:][right])
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32))


def generate_cbow_batches(block: np.ndarray, window: int,
                          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(centers, context_block) with -1 padding outside the dynamic window."""
    n = len(block)
    if n < 2:
        return np.zeros(0, np.int32), np.zeros((0, 2 * window), np.int32)
    b = rng.integers(1, window + 1, size=n)
    ctx = np.full((n, 2 * window), -1, dtype=np.int32)
    for d in range(1, window + 1):
        ok = b >= d
        rows = np.arange(d, n)[ok[d:]]
        ctx[rows, window - d] = block[rows - d]
        rows = np.arange(0, n - d)[ok[:-d]]
        ctx[rows, window + d - 1] = block[rows + d]
    valid = (ctx >= 0).any(axis=1)
    return block[valid].astype(np.int32), ctx[valid]


# -- embeddings on disk ----------------------------------------------------------

def save_embeddings(dictionary: Dictionary, embeddings: np.ndarray,
                    address: str, binary: bool = False) -> None:
    """Write embeddings in the word2vec interchange format the reference's
    ``SaveEmbedding`` produced (distributed_wordembedding.cpp:263-306):
    header ``"V D\\n"``, then per word either ``"word v1 … vD\\n"`` (text)
    or ``"word " + D float32 + "\\n"`` (binary, word2vec.c-compatible).
    ``address`` is a URI — any registered Stream scheme works."""
    emb = np.asarray(embeddings, np.float32)
    v = len(dictionary.words)
    if emb.shape[0] < v:
        log.fatal("save_embeddings: %d words but %d rows", v, emb.shape[0])
    with mv_io.get_stream(address, "w") as stream:
        stream.write(f"{v} {emb.shape[1]}\n".encode())
        for i, word in enumerate(dictionary.words):
            stream.write(word.encode() + b" ")
            if binary:
                stream.write(emb[i].tobytes() + b"\n")
            else:
                stream.write(" ".join(f"{x:g}" for x in emb[i]).encode()
                             + b"\n")


def load_embeddings(address: str, binary: bool = False
                    ) -> Tuple[list, np.ndarray]:
    """Inverse of :func:`save_embeddings`: returns (words, (V, D) matrix)."""
    with mv_io.get_stream(address, "r") as stream:
        data = stream.read()
    head, _, rest = data.partition(b"\n")
    v, dim = (int(x) for x in head.split())
    if v == 0:
        return [], np.zeros((0, dim), np.float32)
    words, rows = [], []
    pos = 0
    for _ in range(v):
        sp = rest.index(b" ", pos)
        words.append(rest[pos:sp].decode())
        if binary:
            vec = np.frombuffer(rest, np.float32, dim, sp + 1)
            pos = sp + 1 + 4 * dim + 1  # + trailing newline
        else:
            nl = rest.index(b"\n", sp)
            vec = np.array(rest[sp + 1:nl].split(), np.float32)
            pos = nl + 1
        rows.append(vec)
    return words, np.stack(rows)


# -- the epoch loop -------------------------------------------------------------

def _decayed_lr(lr0: float, words_trained: int, total_words: int) -> float:
    """The reference's linear lr schedule (wordembedding.cpp:38-46):
    lr = lr0 * (1 - words_trained/(total+1)), floored at lr0 * 1e-4.
    Skipped under AdaGrad, like the reference."""
    frac = 1.0 - words_trained / (float(total_words) + 1.0)
    return lr0 * max(frac, 1e-4)


def _plan_blocks(blocks, epochs: int, total_words: Optional[int]):
    """``blocks`` is either a materialized iterable (reused each epoch) or
    a zero-arg callable yielding a fresh stream per epoch; streaming
    callers must supply ``total_words``. Returns (per_epoch_fn,
    total_raw_words)."""
    if callable(blocks):
        if total_words is None:
            log.fatal("streaming blocks require total_words "
                      "(e.g. dictionary.counts.sum() * epochs)")
        return blocks, total_words
    blocks = list(blocks)
    if total_words is None:
        total_words = sum(len(b) for b in blocks) * epochs
    return (lambda: blocks), total_words


def _train_loop(trainer, blocks, epochs: int, log_every_s: float,
                label: str, total_words: Optional[int] = None,
                pipelined: bool = False, group: int = 1) -> None:
    """Shared epoch loop with throttled words/sec logging, and the
    reference's linear lr decay over the planned RAW word volume
    (wordembedding.cpp:38-46).

    ``pipelined`` drives trainers exposing submit_block/finish_block (the
    PS path): block i+1 is submitted before block i's completions are
    awaited, so each block's lr is one block stale. ``group`` coalesces
    that many consecutive blocks into one submission (pipelined mode)."""
    t0 = time.time()
    last = t0
    per_epoch, total = _plan_blocks(blocks, epochs, total_words)
    decay = not getattr(trainer, "use_adagrad", False)
    seen = 0
    pending = None

    def grouped(it):
        buf = []
        for b in it:
            buf.append(b)
            if len(buf) >= group:
                yield np.concatenate(buf) if len(buf) > 1 else buf[0]
                buf = []
        if buf:
            yield np.concatenate(buf) if len(buf) > 1 else buf[0]

    for _ in range(epochs):
        for block in (grouped(per_epoch()) if pipelined and group > 1
                      else per_epoch()):
            lr = (_decayed_lr(trainer.config.lr, seen, total)
                  if decay else None)
            seen += len(block)
            if pipelined:
                nxt = trainer.submit_block(block, lr=lr)
                if pending is not None:
                    trainer.finish_block(pending, fetch_stats=False)
                pending = nxt
            else:
                trainer.train_block(block, lr=lr)
            now = time.time()
            if now - last > log_every_s:
                rate = trainer.words_trained / (now - t0)
                log.info("%sWords/sec: %.0fk  (trained %d)",
                         label, rate / 1e3, trainer.words_trained)
                last = now
    if pending is not None:
        trainer.finish_block(pending)


# -- trainers ---------------------------------------------------------------

class DeviceTrainer:
    """Device-resident training: both embedding tables live on one device
    and the hot loop is host pair-gen → device step. Runs on ``cuda``
    unless ``device="cpu"`` is asked for."""

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 device: str = "cuda",
                 use_block_step: Optional[bool] = None) -> None:
        self.config = config
        self.dictionary = dictionary
        self.device = mesh_lib.build_device(str(device))
        self.params = init_params(config, self.device)
        if use_block_step is None:
            use_block_step = config.mode == "sg" and config.objective == "ns"
        self.use_block_step = use_block_step
        if use_block_step:
            self.block_step_fn = make_block_train_step(config, dictionary,
                                                       device=self.device)
        else:
            self.step_fn = make_train_step(config, dictionary,
                                           device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.draw_hook: Optional[DrawHook] = None
        self.keep = dictionary.keep_probs(config.sample)
        self.rng = np.random.default_rng(config.seed)
        self.words_trained = 0

    def _batches(self, block: np.ndarray) -> Iterator[Dict[str, torch.Tensor]]:
        """Fixed-shape (B,) batches; the tail is zero-padded with a
        ``pair_mask`` rather than dropped, so blocks or corpora smaller
        than ``batch_pairs`` still train."""
        bp = self.config.batch_pairs
        if self.config.mode == "sg":
            centers, other = generate_sg_pairs(block, self.config.window,
                                               self.rng)
            ctx_key = "contexts"
        else:
            centers, other = generate_cbow_batches(block, self.config.window,
                                                   self.rng)
            ctx_key = "context_block"
        dev = self.device
        for i in range(0, len(centers), bp):
            c, o = centers[i:i + bp], other[i:i + bp]
            if len(c) == bp:
                yield {"centers": async_upload(c, dev), ctx_key: async_upload(o, dev)}
            else:
                n = len(c)
                pad = ((0, bp - n),) + ((0, 0),) * (o.ndim - 1)
                yield {"centers": async_upload(np.pad(c, (0, bp - n)), dev),
                       ctx_key: async_upload(np.pad(o, pad), dev),
                       "pair_mask": async_upload(
                           (np.arange(bp) < n).astype(np.float32), dev)}

    def _draws(self, step: int, t: int, tg: int):
        if self.draw_hook is None:
            return None
        return self.draw_hook(step, t, tg, None)

    def train_block(self, block: np.ndarray, lr: Optional[float] = None) -> float:
        """One block: the subsample (``W2V_SUBSAMPLE``), the issue of its
        steps (``W2V_BLOCK_ISSUE``) and the loss read-back, which waits for
        the device (``W2V_BLOCK_SYNC``)."""
        if self.config.sample > 0:  # sample=0 keeps everything: skip the draw
            with monitor("W2V_SUBSAMPLE"):
                block = subsample_block(block, self.keep, self.rng)
        lr = self.config.lr if lr is None else lr
        with monitor("W2V_BLOCK_ISSUE"):
            losses = self._issue_block(block, lr)
        self.words_trained += len(block)
        if not losses:
            return 0.0
        with monitor("W2V_BLOCK_SYNC"):
            return float(torch.stack(losses).mean().item())

    def _issue_block(self, block: np.ndarray, lr: float) -> List[torch.Tensor]:
        """Issue a subsampled block's steps; their losses stay on the
        device."""
        losses = []
        if self.use_block_step:
            t = self.config.block_tokens
            for k, i in enumerate(range(0, len(block), t)):
                chunk = block[i:i + t]
                if len(chunk) < t:  # pad the tail; -1 tokens are masked
                    chunk = np.concatenate(
                        [chunk, np.full(t - len(chunk), -1, np.int32)])
                self.params, loss = self.block_step_fn(
                    self.params, self.generator, async_upload(chunk, self.device),
                    lr, draws=self._draws(k, t, t // self.config.neg_sharing))
                losses.append(loss)
        else:
            for k, batch in enumerate(self._batches(block)):
                b = batch["centers"].shape[0]
                self.params, loss = self.step_fn(
                    self.params, self.generator, batch, lr,
                    draws=(self._draws(k, b, b)
                           if self.config.objective == "ns" else None))
                losses.append(loss)
        return losses

    def train(self, blocks, epochs: int = 1, log_every_s: float = 10.0,
              total_words: Optional[int] = None) -> None:
        _train_loop(self, blocks, epochs, log_every_s, "",
                    total_words=total_words)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def embeddings(self) -> np.ndarray:
        return self.params["w_in"][: self.config.vocab_size].cpu().numpy()


def host_negative_sampler(counts: np.ndarray, power: float = 0.75):
    """Host-side alias sampler over counts^0.75 — the PS client pre-draws its
    negatives so the candidate row set is known BEFORE the pull."""
    p = np.asarray(counts, dtype=np.float64) ** power
    thr, ali = build_alias_table(p)
    v = len(thr)

    def draw(rng: np.random.Generator, shape) -> np.ndarray:
        idx = rng.integers(0, v, size=shape)
        u = rng.random(shape)
        return np.where(u < thr[idx], idx, ali[idx]).astype(np.int32)

    return draw


def _candidate_step_fn(config: Word2VecConfig, ordered: bool):
    """Compact-space pair step for the PS client: trains a stack of N
    minibatches whose ids are remapped into the pulled candidate-row space,
    in order. ``step(w_in_c, w_out_c, batches, lr) -> (w_in_c, w_out_c,
    loss_sum, mask_sum)``, updating the compact tables in place."""
    combine = config.grad_combine
    cap = config.max_row_step

    def step(w_in_c, w_out_c, batches, lr):
        losses, weights = [], []
        for i in range(batches["in_ids"].shape[0]):
            mask = batches["mask"][i]
            w_in_c, w_out_c, loss = _sgns_core(
                w_in_c, w_out_c, batches["in_ids"][i], batches["in_weights"][i],
                batches["out_ids"][i], batches["labels"][i], mask, lr,
                combine, cap, ordered)
            losses.append(loss * torch.clamp(mask.sum(), min=0.0))
            weights.append(mask.sum())
        return w_in_c, w_out_c, torch.stack(losses).sum(), torch.stack(weights).sum()

    return step


def make_candidate_delta_step(config: Word2VecConfig):
    """Device-IO variant: consumes the gather buckets (bucket,
    padded_cols) as they come from the table and returns the PUSH PAYLOAD
    (delta · scale) and a (2,) stats tensor. Labels and mask arrive as
    uint8. Trains on copies: the gathered rows stay as they were. Under
    the ``deterministic`` flag it adds rows in index order."""
    step = _candidate_step_fn(config, _ordered_adds())
    dim = config.dim

    def dstep(cached_in, cached_out, batches, lr, scale):
        w_in = cached_in[:, :dim]
        w_out = cached_out[:, :dim]
        remapped = dict(batches,
                        labels=batches["labels"].to(w_in.dtype),
                        mask=batches["mask"].to(w_in.dtype))
        new_in, new_out, loss_sum, w_sum = step(w_in.clone(), w_out.clone(),
                                                remapped, lr)
        return ((new_in - w_in) * scale, (new_out - w_out) * scale,
                torch.stack([loss_sum, w_sum]))

    return dstep


class PSTrainer:
    """Parameter-server client: embeddings live in MatrixTables; each block
    pulls ONLY its candidate rows, trains a compact local model, and pushes
    per-row deltas (or raw gradients when the server owns the optimizer).

    Reference capability (not copied): the 4-table AdaGrad recipe
    (``Applications/WordEmbedding/src/communicator.cpp:17-32``) with
    candidate-row ``RequestParameter`` pulls and all four mode×objective
    combinations (``distributed_wordembedding.cpp:147-252``). The two
    sum-gradient tables collapse into server updater state
    (``updater_type="adagrad"``)."""

    def __init__(self, config: Word2VecConfig, dictionary: Dictionary,
                 use_adagrad: bool = False) -> None:
        self.config = config
        self.dictionary = dictionary
        self.use_adagrad = bool(use_adagrad)
        v = config.vocab_size
        out_rows = v if config.objective == "ns" else max(v - 1, 1)
        updater = "adagrad" if self.use_adagrad else "default"
        # reference table ids 0..4: input, output, (2 sum-gradient tables —
        # subsumed by server updater state), wordcount
        self.input_table = mvt.create_table(
            "matrix", v, config.dim, np.float32, updater_type=updater,
            init_range=(-0.5 / config.dim, 0.5 / config.dim), seed=config.seed)
        self.output_table = mvt.create_table(
            "matrix", out_rows, config.dim, np.float32, updater_type=updater)
        self.count_table = mvt.create_table("kv", np.int64)
        self.out_rows = out_rows
        self.device = self.input_table._server_table.device
        if config.objective == "hs":
            self.huffman = HuffmanEncoder(dictionary.counts,
                                          config.max_code_length)
            self._hs_mask = self.huffman.mask()
        else:
            self.huffman = None
            self._neg_draw = host_negative_sampler(dictionary.counts)
        self.delta_step_fn = make_candidate_delta_step(config)
        self.keep = dictionary.keep_probs(config.sample)
        self.rng = np.random.default_rng(config.seed)
        self.words_trained = 0
        self.last_block_stats: Dict[str, int] = {}
        # device draws of the block step (window sizes, negative slots);
        # a multi-process world draws them on the host instead
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + 1)
        self._host_draws = np.random.default_rng(config.seed + 1)
        self.draw_hook: Optional[DrawHook] = None
        # sg+ns fast path: the roll-formulation block step run directly on
        # the compact candidate space, with negatives from a fixed-size
        # pool whose slot-alias table preserves the unigram^0.75 marginal
        # (see _submit_block_fast)
        self._fast_sgns = (config.mode == "sg" and config.objective == "ns")
        if self._fast_sgns:
            self._block_step = make_block_train_step(
                config, dictionary, neg_table=True, device=self.device)
            self._txn_name: Optional[str] = None
            # cap on the per-block negative pool
            self.neg_pool = 16384
            self._slot_lut_lock = threading.Lock()
            if self._can_transact():
                self._build_txn_fn()
        if Zoo.instance().multihost is not None:
            # construction is collective: every rank must hold the
            # registered transaction before any rank submits a block (a
            # replayed descriptor naming it could otherwise reach a rank
            # still between its last table and the registration)
            mvt.process_barrier()

    # -- host-side batch shaping ---------------------------------------------
    def _block_pairs(self, block: np.ndarray):
        """(in_tok (P,C), in_w (P,C), predict (P,)) for this block's mode.
        in_tok may contain -1 (masked context slots)."""
        if self.config.mode == "sg":
            centers, contexts = generate_sg_pairs(
                block, self.config.window, self.rng)
            in_tok = centers[:, None]
            in_w = np.ones_like(in_tok, dtype=np.float32)
            return in_tok, in_w, contexts
        centers, ctx = generate_cbow_batches(block, self.config.window, self.rng)
        valid = (ctx >= 0).astype(np.float32)
        in_w = valid / np.maximum(valid.sum(1, keepdims=True), 1.0)
        return ctx, in_w, centers

    def _block_outputs(self, predict: np.ndarray):
        """(out_tok (P,T), labels (P,T), mask (P,T)); out_tok -1 where masked."""
        if self.config.objective == "ns":
            k = self.config.negatives
            negs = self._neg_draw(self.rng, (len(predict), k))
            out_tok = np.concatenate([predict[:, None], negs], axis=1)
            labels = np.zeros_like(out_tok, np.float32)
            labels[:, 0] = 1.0
            mask = np.ones_like(labels)
            return out_tok, labels, mask
        pts = self.huffman.points[predict]                   # (P, L)
        codes = self.huffman.codes[predict]
        mask = self._hs_mask[predict]
        out_tok = np.where(mask > 0, pts, -1).astype(np.int32)
        labels = (1.0 - codes).astype(np.float32) * mask
        return out_tok, labels, mask

    def _device_io(self) -> bool:
        return (getattr(self.input_table, "supports_device_io", False)
                and getattr(self.output_table, "supports_device_io", False))

    def _add_option(self, lr: float) -> AddOption:
        return AddOption(worker_id=self.input_table._channel.worker_id(),
                         learning_rate=lr)

    def train_block(self, block: np.ndarray,
                    lr: Optional[float] = None) -> float:
        pend = self.submit_block(block, lr)
        return self.finish_block(pend)

    def submit_block(self, block: np.ndarray,
                     lr: Optional[float] = None) -> Optional[Dict]:
        """Issue a block's pulls, training and pushes WITHOUT waiting (the
        reference's pipeline mode, distributed_wordembedding.cpp:202-223).
        Returns a pending record for ``finish_block``; None when the block
        degenerates."""
        if self.config.sample > 0:  # sample=0 keeps everything: skip the draw
            with monitor("W2V_SUBSAMPLE"):
                block = subsample_block(block, self.keep, self.rng)
        if len(block) < 2:
            return None
        lr = self.config.lr if lr is None else lr
        device_io = self._device_io()
        # multihost: device IO proper is off, but the NAMED fused
        # transaction rides the lockstep stream — the fast path's txn
        # branch is exactly that
        if self._fast_sgns and (device_io or self._can_transact()):
            return self._submit_block_fast(block, lr)
        in_tok, in_w, predict = self._block_pairs(block)
        if len(predict) == 0:
            return None
        out_tok, labels, mask = self._block_outputs(predict)

        # candidate sets: exactly the rows this block trains; both pulls
        # are issued before either is awaited (a remote client pays one
        # round trip, not two)
        in_cand = np.unique(in_tok[in_tok >= 0]).astype(np.int32)
        out_cand = np.unique(out_tok[out_tok >= 0]).astype(np.int32)
        n_in, n_out = len(in_cand), len(out_cand)
        if device_io:
            # the gather bucket IS the compact space: slots >= n are
            # sentinel copies (at least one, by the server's ensure_pad)
            h_in = self.input_table.get_device_async(in_cand)
            h_out = self.output_table.get_device_async(out_cand)
            cached_in = self.input_table.wait_device(h_in, in_cand)
            cached_out = self.output_table.wait_device(h_out, out_cand)
            r_in, r_out = cached_in.shape[0], cached_out.shape[0]
            sent_in, sent_out = n_in, n_out  # first pad slot
        else:
            # remote proxies: host rows into compact matrices bucketed to
            # a power of two, the last row the sentinel scratch row
            h_in = self.input_table.get_async(in_cand)
            h_out = self.output_table.get_async(out_cand)
            cached_in = self.input_table.wait_get(h_in, in_cand)
            cached_out = self.output_table.wait_get(h_out, out_cand)
            r_in = max(_next_pow2(n_in + 1), 8)
            r_out = max(_next_pow2(n_out + 1), 8)
            sent_in, sent_out = r_in - 1, r_out - 1

        # stack minibatches: pad pairs to a full (N, B, ...) block, N
        # bucketed to a power of two
        bp = self.config.batch_pairs
        p = len(predict)
        n = _next_pow2(-(-p // bp))

        def pad(arr, fill):
            flat = np.full((n * bp,) + arr.shape[1:], fill, arr.dtype)
            flat[:p] = arr
            return flat.reshape((n, bp) + arr.shape[1:])

        # token id → compact slot remap (host)
        in_ids = np.where(
            in_tok >= 0,
            np.searchsorted(in_cand, np.maximum(in_tok, 0)),
            sent_in).astype(np.int32)
        out_ids = np.where(
            out_tok >= 0,
            np.searchsorted(out_cand, np.maximum(out_tok, 0)),
            sent_out).astype(np.int32)
        dev = self.device
        batches_d = {
            "in_ids": async_upload(pad(in_ids, sent_in), dev),
            "in_weights": async_upload(pad(in_w, 0.0), dev),
            "out_ids": async_upload(pad(out_ids, sent_out), dev),
        }
        # labels and mask cross as bytes
        batches_d["labels"] = async_upload(pad(labels.astype(np.uint8), 0), dev)
        batches_d["mask"] = async_upload(pad(mask.astype(np.uint8), 0), dev)
        scale = (-1.0 / lr) if self.use_adagrad else 1.0
        opt = self._add_option(lr) if self.use_adagrad else None
        if not device_io:
            # remote proxies: the zero-padded compact rows go up, the live
            # rows' push payloads come back as host arrays
            dim = self.config.dim
            w_in_c = np.zeros((r_in, dim), np.float32)
            w_in_c[:n_in] = cached_in
            w_out_c = np.zeros((r_out, dim), np.float32)
            w_out_c[:n_out] = cached_out
            delta_in, delta_out, stats = self.delta_step_fn(
                async_upload(w_in_c, dev), async_upload(w_out_c, dev),
                batches_d, lr, scale)
            a1 = self.input_table.add_async(delta_in[:n_in].cpu().numpy(),
                                            row_ids=in_cand, option=opt)
            a2 = self.output_table.add_async(delta_out[:n_out].cpu().numpy(),
                                             row_ids=out_cand, option=opt)
        else:
            # full-bucket pushes with sentinel-aimed pad ids (pad deltas
            # are exactly zero: masked grads carry zero weight)
            ids_in_p = np.concatenate(
                [in_cand, np.full(r_in - n_in, self.input_table.sentinel_row,
                                  np.int32)])
            ids_out_p = np.concatenate(
                [out_cand, np.full(r_out - n_out,
                                   self.output_table.sentinel_row, np.int32)])
            delta_in, delta_out, stats = self.delta_step_fn(
                cached_in, cached_out, batches_d, lr, scale)
            a1 = self.input_table.add_device_async(delta_in, ids_in_p,
                                                   option=opt)
            a2 = self.output_table.add_device_async(delta_out, ids_out_p,
                                                    option=opt)
        return {"a1": a1, "a2": a2, "stats": stats, "n_in": n_in,
                "n_out": n_out, "pairs": p, "block_len": int(len(block))}

    def _can_transact(self) -> bool:
        """Fused transactions need in-process tables (the transaction reads
        the servers' device state) and an async-semantics server."""
        if (getattr(self.input_table, "_server_table", None) is None
                or getattr(self.output_table, "_server_table", None) is None):
            return False
        if not hasattr(self.input_table, "transact_device_async"):
            return False
        server = Zoo.instance().server
        return (getattr(server, "plain_async", False)
                or getattr(server, "supports_named_transact", False))

    def _fast_delta(self, cached_in, cached_out, draws, blocks_c, neg_slots,
                    lr, scale):
        """Train copies of the compact rows over the submission's chunks,
        in order; return (delta_in·scale, delta_out·scale, stats), stats =
        (pair-weighted loss sum, pairs, pairs)."""
        dim = self.config.dim
        w_in = cached_in[:, :dim]
        w_out = cached_out[:, :dim]
        params = {"w_in": w_in.clone(), "w_out": w_out.clone()}
        losses, pairs = [], []
        for i in range(blocks_c.shape[0]):
            params, loss, n_pairs = self._block_step(
                params, self.generator, blocks_c[i], lr, neg_slots,
                with_pairs=True, draws=draws[i])
            losses.append(loss)
            pairs.append(n_pairs)
        losses, pairs = torch.stack(losses), torch.stack(pairs)
        # pair-weighted: pad chunks (0 pairs, 0 loss) contribute nothing
        stats = torch.stack([(losses * pairs).sum(), pairs.sum(), pairs.sum()])
        return ((params["w_in"] - w_in) * scale,
                (params["w_out"] - w_out) * scale, stats)

    def _build_txn_fn(self) -> None:
        """The whole PS block as ONE transaction over both tables' device
        state: gather candidate rows, run the block step, apply both
        tables' updates (linear scatter or server-side AdaGrad row update),
        return the stats triple. Registered by name. Timed on the
        dispatcher in three sections nested in ``SERVER_PROCESS_TRANSACT``
        (``W2V_TXN_GATHER``, ``W2V_TXN_STEP``, ``W2V_TXN_PUSH``) and, on
        CUDA, by the device (``SERVER_TRANSACT_DEVICE``)."""
        srv_in = self.input_table._server_table._unwrapped()
        srv_out = self.output_table._server_table._unwrapped()
        apply_in = srv_in.row_apply_traceable()
        apply_out = srv_out.row_apply_traceable()
        pc_in = srv_in.padded_cols
        pc_out = srv_out.padded_cols
        dim = self.config.dim
        dev = self.device
        device_time = (DeviceTime("SERVER_TRANSACT_DEVICE")
                       if dev.type == "cuda" else None)

        def txn(datas, states, packed, draws, lr, scale, worker, scalars,
                b_in, b_out, n_chunks, chunk):
            # `packed` is ONE int32 array [ids_in | ids_out | blocks_c |
            # slot_alias]: an upload in one process, host data in a
            # multi-process world (as are the draws and scalars)
            began = device_time.begin() if device_time is not None else None
            data_in, data_out = datas
            st_in, st_out = states
            sharded = srv_in.multihost is not None
            if sharded:
                ids_h = packed[:b_in + b_out]
                packed = _as_index(packed, dev).to(torch.int32)
                draws = [None if d is None
                         else {k: _as_index(v, dev) for k, v in d.items()}
                         for d in draws]
                scalars = torch.as_tensor(scalars, dtype=torch.float32,
                                          device=dev)
            ids_in = packed[:b_in]
            ids_out = packed[b_in:b_in + b_out]
            o = b_in + b_out
            blocks_c = packed[o:o + n_chunks * chunk].reshape(n_chunks, chunk)
            slot_alias = packed[o + n_chunks * chunk:]
            with monitor("W2V_TXN_GATHER"):
                if sharded:
                    # the ranks' held candidate rows, exchanged: every rank
                    # trains on the whole candidate set
                    cand_in = srv_in.candidate_rows(ids_h[:b_in])
                    cand_out = srv_out.candidate_rows(ids_h[b_in:])
                else:
                    cand_in = gather_rows(data_in, ids_in)
                    cand_out = gather_rows(data_out, ids_out)
            with monitor("W2V_TXN_STEP"):
                d_in, d_out, stats = self._fast_delta(
                    cand_in, cand_out, draws, blocks_c, slot_alias, lr, scale)
            with monitor("W2V_TXN_PUSH"):
                if pc_in != dim:
                    d_in = F.pad(d_in, (0, pc_in - dim))
                if pc_out != dim:
                    d_out = F.pad(d_out, (0, pc_out - dim))
                if sharded:
                    # each rank writes back only the rows it holds
                    ids_in, d_in = srv_in.owned_push(ids_h[:b_in], d_in)
                    ids_out, d_out = srv_out.owned_push(ids_h[b_in:], d_out)
                if ids_in is not None:
                    data_in, st_in = apply_in(data_in, st_in, ids_in, d_in,
                                              worker, scalars)
                if ids_out is not None:
                    data_out, st_out = apply_out(data_out, st_out, ids_out,
                                                 d_out, worker, scalars)
            if began is not None:
                device_time.end(began)
            return [data_in, data_out], [st_in, st_out], stats

        self._txn_name = register_program(
            f"mv.w2v.block_txn/{self.input_table.table_id}"
            f"/{self.output_table.table_id}", txn)

    def _chunk_draws(self, n_chunks: int, chunk: int, pool: int,
                     host: bool = False) -> List:
        """Per-chunk draws for one submission: None (the step draws from
        ``self.generator``) or the hook's, on the device. ``host`` (a
        multi-process world's descriptor) keeps them numpy, and without a
        hook draws them with numpy: window sizes in ``[1, window]``,
        negative slots in ``[0, pool)``."""
        tg = chunk // self.config.neg_sharing
        if host:
            if self.draw_hook is not None:
                return [{k: np.asarray(v) for k, v in
                         self.draw_hook(i, chunk, tg, pool).items()}
                        for i in range(n_chunks)]
            rng = self._host_draws
            return [{"win": rng.integers(1, self.config.window + 1,
                                         size=chunk, dtype=np.int32),
                     "neg": rng.integers(0, pool, size=(
                         tg, self.config.negatives), dtype=np.int32)}
                    for _ in range(n_chunks)]
        if self.draw_hook is None:
            return [None] * n_chunks
        return [{k: _as_index(v, self.device)
                 for k, v in self.draw_hook(i, chunk, tg, pool).items()}
                for i in range(n_chunks)]

    def _submit_block_fast(self, block: np.ndarray, lr: float
                           ) -> Optional[Dict]:
        """sg+ns fast path: run the roll-formulation block step directly on
        the compact candidate space.

        Layout: compact slot space = [unique block tokens | pool-only
        negative ids | sentinel pads]; the SAME slot numbering indexes the
        compact w_in and w_out buckets. Negatives: ``neg_pool`` draws from
        the host unigram^0.75 sampler become a (P,) slot-alias table whose
        duplicate entries encode the marginal exactly; the step draws
        uniform indices into it. Push ids are unique by construction
        (pool-only ids exclude block tokens), as the row scatter requires:
        two sorted runs, not sorted as a whole.

        Timed on the caller's thread: ``W2V_SHAPE`` (the compact space, the
        pool, the chunk layout and, for the transaction, the pack) and
        ``W2V_UPLOAD`` (the packed upload and the hand-off to the
        dispatcher)."""
        use_txn = self._can_transact()
        multihost = Zoo.instance().multihost is not None
        if use_txn and self._txn_name is None:
            self._build_txn_fn()
        with monitor("W2V_SHAPE"):
            blk_u = np.unique(block).astype(np.int32)
            n_blk = len(blk_u)
            p_draws = _next_pow2(min(
                self.neg_pool,
                max(1024, len(block) * self.config.window
                    * self.config.negatives)))
            draws = self._neg_draw(self.rng, (p_draws,)).reshape(-1)
            # persistent vocab->compact-slot lookup table, reset only at the
            # touched entries (in ``finally``: a dirty table would map the
            # next block's draws onto THIS block's slots). Worker threads
            # that share this trainer take turns with it: two blocks filling
            # it at once would map each other's tokens onto wrong slots.
            with self._slot_lut_lock:
                lut = getattr(self, "_slot_lut", None)
                if lut is None:
                    lut = self._slot_lut = np.full(self.config.vocab_size,
                                                   -1, np.int32)
                pool_only = None
                try:
                    lut[blk_u] = np.arange(n_blk, dtype=np.int32)
                    pool_only = np.unique(
                        draws[lut[draws] < 0]).astype(np.int32)
                    lut[pool_only] = n_blk + np.arange(len(pool_only),
                                                       dtype=np.int32)
                    ids_out = np.concatenate([blk_u, pool_only])
                    slot_alias = lut[draws]
                    flat = lut[block]
                finally:
                    lut[blk_u] = -1
                    if pool_only is not None:
                        lut[pool_only] = -1

            # chunk the block at roughly the pair path's update granularity
            # (batch_pairs pairs ~ bp/window tokens): the max_row_step clamp
            # is per step
            G = self.config.neg_sharing
            chunk = _next_pow2(max(128, self.config.batch_pairs
                                   // max(self.config.window, 1)))
            chunk = min(chunk, _next_pow2(max(len(block), G)))
            if chunk % G:
                chunk *= G  # keep the grouped-negatives constraint
            n_chunks = _next_pow2(-(-len(block) // chunk))
            blocks_c = np.full((n_chunks, chunk), -1, np.int32)
            blocks_c.reshape(-1)[: len(block)] = flat  # lut-remapped above
            chunk_draws = self._chunk_draws(n_chunks, chunk, p_draws,
                                            host=multihost)
            if use_txn:
                b_in = max(_next_pow2(n_blk + 1), ROW_GROUP)
                b_out = max(_next_pow2(len(ids_out) + 1), ROW_GROUP)
                ids_in_p = np.concatenate(
                    [blk_u, np.full(b_in - n_blk,
                                    self.input_table.sentinel_row, np.int32)])
                ids_out_p = np.concatenate(
                    [ids_out, np.full(b_out - len(ids_out),
                                      self.output_table.sentinel_row,
                                      np.int32)])
                packed = np.concatenate(
                    [ids_in_p, ids_out_p, blocks_c.reshape(-1), slot_alias])
        scale = (-1.0 / lr) if self.use_adagrad else 1.0
        opt = self._add_option(lr)

        if use_txn:
            # ONE dispatcher op: gather both tables' candidate rows, train,
            # and apply both updates
            with monitor("W2V_UPLOAD"):
                st = self.input_table._server_table
                if multihost:
                    # multihost descriptor: HOST args only (the transaction
                    # uploads them on every rank)
                    worker, scalars = st._option_host(opt)
                else:
                    worker, scalars = st._option_consts(opt)
                    packed = async_upload(packed, self.device)
                h = self.input_table.transact_device_async(
                    self._txn_name, [self.output_table],
                    args=(packed, chunk_draws, lr, scale, worker, scalars,
                          b_in, b_out, n_chunks, chunk))
            # the candidate gathers happen inside the transaction; keep the
            # pull accounting so "bytes ∝ candidate rows" stays observable
            self.input_table.rows_pulled += n_blk
            self.output_table.rows_pulled += len(ids_out)
            return {"txn": h, "block_len": len(block), "n_in": n_blk,
                    "n_out": len(ids_out), "pairs": -1, "stats": None}

        h_in = self.input_table.get_device_async(blk_u)
        h_out = self.output_table.get_device_async(ids_out)
        cached_in = self.input_table.wait_device(h_in, blk_u)
        cached_out = self.output_table.wait_device(h_out, ids_out)

        delta_in, delta_out, stats = self._fast_delta(
            cached_in, cached_out, chunk_draws,
            async_upload(blocks_c, self.device),
            async_upload(slot_alias, self.device), lr, scale)
        r_in, r_out = cached_in.shape[0], cached_out.shape[0]
        ids_in_p = np.concatenate(
            [blk_u, np.full(r_in - n_blk, self.input_table.sentinel_row,
                            np.int32)])
        ids_out_p = np.concatenate(
            [ids_out, np.full(r_out - len(ids_out),
                              self.output_table.sentinel_row, np.int32)])
        opt = opt if self.use_adagrad else None
        a1 = self.input_table.add_device_async(delta_in, ids_in_p, option=opt)
        a2 = self.output_table.add_device_async(delta_out, ids_out_p, option=opt)
        return {"a1": a1, "a2": a2, "stats": stats, "block_len": len(block),
                "n_in": n_blk, "n_out": len(ids_out), "pairs": -1}

    def finish_block(self, pend: Optional[Dict],
                     fetch_stats: bool = True) -> float:
        """Reclaim a submitted block's completions. ``fetch_stats=False``
        skips the loss read-back (a device-to-host copy that would stall
        the pipelined loop)."""
        if pend is None:
            return 0.0
        with monitor("W2V_FINISH_WAIT"):
            if "txn" in pend:
                # fused transaction: one completion carries the stats triple
                pend["stats"] = self.input_table.wait(pend["txn"])
            else:
                self.input_table.wait(pend["a1"])
                self.output_table.wait(pend["a2"])
        # the word count is a shared tally, not a training round: it goes
        # in as administrative access, outside the BSP/SSP clocks (a table
        # that only ever takes Adds would stall BSP at its second round)
        with Zoo.instance().admin():
            self.count_table.add([0], [pend["block_len"]])
        self.words_trained += pend["block_len"]
        self.last_block_stats = {"in_rows": pend["n_in"],
                                 "out_rows": pend["n_out"],
                                 "pairs": pend["pairs"]}
        if not fetch_stats:
            return 0.0
        vals = pend["stats"].cpu().numpy()
        loss_sum, w_sum = vals[0], vals[1]
        if len(vals) > 2 and pend.get("pairs", -1) < 0:
            pend["pairs"] = int(vals[2])  # fast path: counted on the device
            self.last_block_stats["pairs"] = pend["pairs"]
        return float(loss_sum) / max(float(w_sum), 1.0)

    def train(self, blocks, epochs: int = 1, log_every_s: float = 10.0,
              total_words: Optional[int] = None, group: int = 1) -> None:
        """Pipelined epoch loop: block i+1's host shaping, pulls and
        training are issued BEFORE block i's completions are awaited.
        ``group`` coalesces that many blocks per submission (see
        ``_train_loop``)."""
        _train_loop(self, blocks, epochs, log_every_s, "PS ",
                    total_words=total_words, pipelined=True, group=group)

    def embeddings(self) -> np.ndarray:
        return self.input_table.get()
