"""The skip-gram negative-sampling chunk step of word2vec's block trainers
(``models/word2vec.py`` ``make_block_train_step``): from one chunk's token
ids and random draws to the three delta arrays that the step scatters
into its tables, the loss and the pair count.

Three parts, side by side, as in :mod:`.rows`:

* the wrapper (:func:`sgns_chunk`): checks its inputs, then dispatches on
  the device the tables lie on. On a CUDA device it launches the chain of
  hand-written kernels of ``csrc/sgns.cu`` or raises; on the CPU it runs
  the plain version. There is no fallback from the card to the plain
  version and no switch that routes it there.
* the plain PyTorch version (:func:`sgns_chunk_plain`): the eager step,
  rolls and all. The CPU tests use it and the card tests hold the kernels
  against it.
* a launch counter, ``sgns_chunk.launches``: one per kernel launch
  (:data:`KERNELS` a chunk), and nowhere else.

The kernels replace no TPU kernel: the JAX package's block step is one
``jit``, which XLA fuses. Their notes (what bounds them, what the design
does about it) are at the top of ``csrc/sgns.cu``.

The chunk's arithmetic, shared by both versions: centre ``t``'s pairs are
the live tokens at offsets ``-W..-1, 1..W`` within its drawn window
``win[t]`` and inside the chunk; a group of ``group`` consecutive centres
shares ``negatives`` drawn rows (``neg``, or ``neg_slots[neg]`` with a
slot table); a dead centre (no pair) maps to the input table's last row,
a pad token to the output table's last row, a dead group's negatives to
it too. ``combine="sum"`` scales each row's summed gradient by the
``max_row_step`` clamp of its occurrence count in pairs;
``combine="mean"`` divides by its count. The deltas carry ``-lr``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from multiverso_tpu_torch.ops import kernels
from multiverso_tpu_torch.ops.rows import _launch, _on_card, _raise_on_error

#: Kernels a chunk launches (``csrc/sgns.cu``: clear, prep, score, grad).
KERNELS = 4

_INDEX_DTYPES = (torch.int32, torch.int64)

# flags of mvt_sgns_chunk (``csrc/sgns.cu``)
_BLOCK64, _WIN64, _NEG64, _SLOTS64, _NEG_TABLE, _MEAN = 1, 2, 4, 8, 16, 32
_WARPS = 8  # csrc/sgns.cu kWarps: a loss partial a block of 8 centres


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _scratch_floats(t: int, window: int, negatives: int, group: int,
                    rows_in: int, rows_out: int) -> int:
    """Floats of scratch that ``mvt_sgns_chunk`` lays out (``csrc/sgns.cu``
    ``layout``, which refuses less): npairs, g, g_neg, the group flags,
    both tables' counts, then float64 loss and pair partials."""
    counts = (t * (1 + 2 * window + negatives) + 2 * (t // group)
              + rows_in + rows_out)
    return _cdiv(counts, 2) * 2 + 4 * _cdiv(t, _WARPS)


class ChunkDeltas(NamedTuple):
    """A chunk's row updates, each to be added to its table (duplicates
    accumulate): ``ids_in`` (T,) into the input table with ``d_in`` (T, D);
    ``ids_out`` (T,) and ``ids_neg`` (T/G*K,) into the output table with
    ``d_out`` and ``d_neg``; ``loss`` and ``pairs``, 0-d float32."""
    ids_in: torch.Tensor
    d_in: torch.Tensor
    ids_out: torch.Tensor
    d_out: torch.Tensor
    ids_neg: torch.Tensor
    d_neg: torch.Tensor
    loss: torch.Tensor
    pairs: torch.Tensor


def scale_from_count(count: torch.Tensor, lr, cap: float) -> torch.Tensor:
    """Stability clamp from a per-row occurrence count: rows whose
    occurrence-weighted step budget lr·count exceeds ``cap`` are scaled so
    their total batch step equals the cap; all others keep exact sum
    semantics."""
    return torch.clamp(cap / torch.clamp(lr * count, min=1e-6), max=1.0)


def row_step_scale(num_rows: int, row_ids: torch.Tensor,
                   occ_weights: torch.Tensor, lr, cap: float) -> torch.Tensor:
    """:func:`scale_from_count` over a scatter-aggregated count."""
    count = torch.zeros(num_rows, dtype=torch.float32, device=row_ids.device)
    count.index_add_(0, row_ids.reshape(-1),
                     occ_weights.reshape(-1).to(torch.float32))
    return scale_from_count(count, lr, cap)


def sgns_chunk_plain(w_in: torch.Tensor, w_out: torch.Tensor,
                     block: torch.Tensor, win: torch.Tensor, neg: torch.Tensor,
                     neg_slots: Optional[torch.Tensor], lr: float, *,
                     window: int, negatives: int, group: int,
                     combine: str = "sum",
                     max_row_step: float = 1.0) -> ChunkDeltas:
    """Plain PyTorch version of :func:`sgns_chunk`: the eager step."""
    # Structured form: keep the (T, 2W) pair layout. The input row of a
    # center is gathered ONCE for its 2W pairs, negatives are shared per
    # center, and gradients are pre-reduced over the window axis before
    # scattering.
    dev = w_in.device
    offsets = [o for o in range(-window, window + 1) if o != 0]     # (2W,)
    G = group
    sentinel_in = w_in.shape[0] - 1
    sentinel_out = w_out.shape[0] - 1
    block = block.to(dev, torch.int64)
    t = block.shape[0]
    tg = t // G
    off = torch.tensor(offsets, dtype=torch.int64, device=dev)
    valid_tok = block >= 0
    pos = torch.arange(t, device=dev)
    ctx_pos = pos[:, None] + off[None, :]                           # (T, 2W)
    in_range = (ctx_pos >= 0) & (ctx_pos < t)
    contexts = block[torch.clamp(ctx_pos, 0, t - 1)]                # (T, 2W)
    pair_mask = (in_range & (off.abs()[None, :] <= win[:, None])
                 & valid_tok[:, None] & (contexts >= 0))            # (T, 2W)
    pm = pair_mask.to(torch.float32)
    npairs = pm.sum(dim=1)                                          # (T,)
    active = npairs > 0

    centers_id = torch.where(valid_tok & active, block, sentinel_in)
    blk_out_ids = torch.where(valid_tok, block, sentinel_out)       # (T,)
    act_g = active.reshape(tg, G)
    negs_c = neg_slots.long()[neg] if neg_slots is not None else neg  # (TG, K)
    negs_id = torch.where(act_g.any(dim=1)[:, None], negs_c,
                          sentinel_out)                             # (TG, K)

    v = w_in[centers_id]                                            # (T, D)
    # every positive context row is some block position's own w_out row:
    # ONE (T, D) gather serves all 2W offsets via rolls
    u_blk = w_out[blk_out_ids]                                      # (T, D)
    u_neg = w_out[negs_id]                                          # (TG, K, D)
    vg = v.reshape(tg, G, v.shape[1])                               # (TG, G, D)

    s_neg = torch.einsum("gcd,gkd->gck", vg, u_neg)                 # (TG, G, K)
    # negatives are shared across the center's pairs -> their per-pair
    # gradients coincide; the pair-mean is just sigmoid(s)
    g_neg = torch.sigmoid(s_neg) * act_g[:, :, None]                # (TG, G, K)

    loss_pos = torch.zeros((), dtype=torch.float32, device=dev)
    grad_v_pos = torch.zeros_like(v)
    g_out_local = torch.zeros_like(u_blk)  # positive grads by POSITION
    occ_ctx = torch.zeros(t, dtype=torch.float32, device=dev)
    for j, o in enumerate(offsets):        # 2W
        u_o = torch.roll(u_blk, -o, dims=0)  # row t -> w_out[block[t+o]]
        pmj = pm[:, j]                     # edge wraps masked by pm
        s = torch.sum(v * u_o, dim=1)                               # (T,)
        g = (torch.sigmoid(s) - 1.0) * pmj
        loss_pos = loss_pos + torch.sum(F.logsigmoid(s) * pmj)
        grad_v_pos += g[:, None] * u_o
        # the contribution of center t lands on context POSITION t+o
        g_out_local += torch.roll(g[:, None] * v, o, dims=0)
        occ_ctx += torch.roll(pmj, o)

    # each of a center's npairs pairs contributes the same shared-negative
    # term, so the negative loss scales by npairs
    n_terms = pm.sum() * (1 + negatives)
    npg = npairs.reshape(tg, G)
    loss = (-loss_pos
            - (F.logsigmoid(-s_neg).sum(dim=2) * npg).sum()
            ) / torch.clamp(n_terms, min=1.0)

    # per-center shared-negative input gradient (both combine modes)
    neg_v = torch.einsum("gck,gkd->gcd", g_neg, u_neg).reshape(t, -1)
    if combine == "sum":
        grad_v = grad_v_pos + npairs[:, None] * neg_v               # (T, D)
        grad_u_neg = torch.einsum("gck,gcd,gc->gkd", g_neg, vg, npg)
        neg_occ = npg.sum(dim=1)[:, None].expand(tg, negatives)
    else:
        grad_v = (grad_v_pos / torch.clamp(npairs, min=1.0)[:, None]
                  + neg_v)                                          # (T, D)
        grad_u_neg = torch.einsum("gck,gcd->gkd", g_neg, vg)        # (TG, K, D)
        neg_occ = act_g.sum(dim=1).to(torch.float32)[:, None].expand(
            tg, negatives)

    # one combined out-row occurrence map
    out_count = torch.zeros(w_out.shape[0], dtype=torch.float32, device=dev)
    out_count.index_add_(0, blk_out_ids, occ_ctx)
    out_count.index_add_(0, negs_id.reshape(-1), neg_occ.reshape(-1))
    if combine == "mean":
        in_count = torch.zeros(w_in.shape[0], dtype=torch.float32,
                               device=dev)
        in_count.index_add_(0, centers_id,
                            torch.ones(t, dtype=torch.float32, device=dev))
        gin = grad_v / in_count[centers_id][:, None]
        denom = torch.clamp(out_count, min=1.0)
        g_out_local = g_out_local / denom[blk_out_ids][:, None]
        grad_u_neg = grad_u_neg / denom[negs_id][:, :, None]
    else:
        # occurrence-units are pairs: npairs per center position, pm per
        # positive out-entry, npairs per negative out-entry
        cap = max_row_step
        in_scale = row_step_scale(w_in.shape[0], centers_id, npairs, lr, cap)
        out_scale = scale_from_count(out_count, lr, cap)
        gin = grad_v * in_scale[centers_id][:, None]
        g_out_local = g_out_local * out_scale[blk_out_ids][:, None]
        grad_u_neg = grad_u_neg * out_scale[negs_id][:, :, None]
    dim = w_in.shape[1]
    return ChunkDeltas(centers_id, -lr * gin, blk_out_ids, -lr * g_out_local,
                       negs_id.reshape(-1), (-lr * grad_u_neg).reshape(-1, dim),
                       loss, pm.sum())


def _check(op: str, w_in, w_out, block, win, neg, neg_slots, window: int,
           negatives: int, group: int, combine: str) -> None:
    """The checks both versions share; raises ValueError."""
    for name, w in (("w_in", w_in), ("w_out", w_out)):
        if w.dim() != 2 or w.dtype != torch.float32:
            raise ValueError(f"{op}: {name} must be a 2-D float32 table, got "
                             f"{w.dtype}{tuple(w.shape)}")
        if w.shape[0] < 1:
            raise ValueError(f"{op}: {name} has no rows")
    if w_in.shape[1] != w_out.shape[1] or w_in.shape[1] < 1:
        raise ValueError(f"{op}: w_in and w_out widths {w_in.shape[1]} and "
                         f"{w_out.shape[1]} differ or are 0")
    if combine not in ("sum", "mean"):
        raise ValueError(f"{op}: combine must be 'sum' or 'mean', got {combine!r}")
    if window < 0 or negatives < 0 or group < 1:
        raise ValueError(f"{op}: window {window}, negatives {negatives}, "
                         f"group {group}")
    if block.dim() != 1 or block.dtype not in _INDEX_DTYPES or block.shape[0] < 1:
        raise ValueError(f"{op}: block must be a non-empty 1-D int32/int64 "
                         f"tensor, got {block.dtype}{tuple(block.shape)}")
    t = block.shape[0]
    if t % group:
        raise ValueError(f"{op}: group {group} must divide the chunk's {t} tokens")
    if win.shape != (t,) or win.dtype not in _INDEX_DTYPES:
        raise ValueError(f"{op}: win must be ({t},) int32/int64, got "
                         f"{win.dtype}{tuple(win.shape)}")
    if neg.shape != (t // group, negatives) or neg.dtype not in _INDEX_DTYPES:
        raise ValueError(f"{op}: neg must be ({t // group}, {negatives}) "
                         f"int32/int64, got {neg.dtype}{tuple(neg.shape)}")
    if neg_slots is not None and (neg_slots.dim() != 1
                                  or neg_slots.dtype not in _INDEX_DTYPES):
        raise ValueError(f"{op}: neg_slots must be a 1-D int32/int64 tensor, "
                         f"got {neg_slots.dtype}{tuple(neg_slots.shape)}")
    dev = w_in.device
    for name, x in (("w_out", w_out), ("block", block), ("win", win),
                    ("neg", neg), ("neg_slots", neg_slots)):
        if x is not None and x.device != dev:
            raise ValueError(f"{op}: {name} on {x.device}, w_in on {dev}")


_entries: dict = {}


def _entry(name: str):
    """The ctypes function ``name`` of ``csrc/sgns.cu``, resolved once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(kernels.load("sgns"), name)
    return fn


def sgns_chunk(w_in: torch.Tensor, w_out: torch.Tensor, block: torch.Tensor,
               win: torch.Tensor, neg: torch.Tensor,
               neg_slots: Optional[torch.Tensor], lr: float, *, window: int,
               negatives: int, group: int, combine: str = "sum",
               max_row_step: float = 1.0) -> ChunkDeltas:
    """One chunk of skip-gram negative sampling over the tables ``w_in`` and
    ``w_out`` (read, not written): ``block`` (T,) token ids, -1 for pads;
    ``win`` (T,) window sizes in ``[1, window]``; ``neg`` (T/group,
    negatives) negative rows, or slot indices into ``neg_slots`` where it
    is given. Returns the :class:`ChunkDeltas` that the step adds to its
    tables.

    Raises ValueError where the tables are not 2-D float32 of one width,
    ``group`` does not divide T, the draws' shapes or dtypes (int32 or
    int64) do not match, or the tensors lie on different devices; on the
    card also where a tensor is not contiguous or a table's columns are
    strided. A failed launch raises RuntimeError."""
    op = "sgns_chunk"
    _check(op, w_in, w_out, block, win, neg, neg_slots, window, negatives,
           group, combine)
    if not _on_card(op, w_in):
        return sgns_chunk_plain(w_in, w_out, block, win, neg, neg_slots, lr,
                                window=window, negatives=negatives,
                                group=group, combine=combine,
                                max_row_step=max_row_step)
    for name, x in (("block", block), ("win", win), ("neg", neg),
                    ("neg_slots", neg_slots)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    for name, w in (("w_in", w_in), ("w_out", w_out)):
        if w.stride(1) != 1:
            raise ValueError(f"{op}: {name}'s columns must be contiguous")
    t, dim = block.shape[0], w_in.shape[1]
    n_rows = 2 * t + t // group * negatives
    dev = w_in.device
    rows_in, rows_out = w_in.shape[0], w_out.shape[0]
    # ids (int64), deltas and scratch carved out of one allocation, each
    # part 16-byte aligned; the loss and pair count apart, so that a
    # caller who keeps them keeps no more
    n_ids, n_deltas = _cdiv(2 * n_rows, 4) * 4, _cdiv(n_rows * dim, 4) * 4
    n_scratch = _scratch_floats(t, window, negatives, group, rows_in, rows_out)
    buf = torch.empty(n_ids + n_deltas + n_scratch, dtype=torch.float32,
                      device=dev)
    ids = buf[:2 * n_rows].view(torch.int64)
    deltas = buf[n_ids:n_ids + n_rows * dim].view(n_rows, dim)
    scratch = buf[n_ids + n_deltas:]
    result = torch.empty(2, dtype=torch.float32, device=dev)
    flags = ((_BLOCK64 if block.dtype == torch.int64 else 0)
             | (_WIN64 if win.dtype == torch.int64 else 0)
             | (_NEG64 if neg.dtype == torch.int64 else 0)
             | (_MEAN if combine == "mean" else 0))
    slots_ptr, n_slots = None, 0
    if neg_slots is not None:
        flags |= _NEG_TABLE | (_SLOTS64 if neg_slots.dtype == torch.int64 else 0)
        slots_ptr, n_slots = neg_slots.data_ptr(), neg_slots.shape[0]
    code = _launch(_entry("mvt_sgns_chunk"), w_in.get_device(),
                   w_in.data_ptr(), w_in.stride(0), rows_in,
                   w_out.data_ptr(), w_out.stride(0), rows_out,
                   block.data_ptr(), win.data_ptr(), neg.data_ptr(), slots_ptr,
                   n_slots, t, dim, window, negatives, group, flags,
                   float(lr), float(max_row_step), ids.data_ptr(),
                   deltas.data_ptr(), scratch.data_ptr(), n_scratch,
                   result.data_ptr())
    sgns_chunk.launches += KERNELS
    _raise_on_error(op, code)
    return ChunkDeltas(ids[:t], deltas[:t], ids[t:2 * t], deltas[t:2 * t],
                       ids[2 * t:], deltas[2 * t:], result[0], result[1])


sgns_chunk.launches = 0
