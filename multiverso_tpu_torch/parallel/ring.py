"""Sequence/context parallelism: ring attention and the Ulysses all-to-all
(port of ``multiverso_tpu/parallel/ring.py``).

The JAX package runs these inside ``shard_map`` over a mesh axis. Here the
axis is a ``torch.distributed`` process group (``group=``; the default
world when None): the axis index is the rank in the group and the axis
size is the group's size. Every rank of the group calls the function on its
own ``(B, T_local, H, D)`` block of a global ``(B, T, H, D)`` sequence
split contiguously on T (rank ``r`` holds ``[r*T_local, (r+1)*T_local)``).

* :func:`ring_attention` — blockwise attention with the K/V blocks
  rotating one hop around the group per step (``lax.ppermute`` there, a
  ``batch_isend_irecv`` here), folded into a streaming online softmax, so
  no rank ever holds more than one ``(B, H, T_local, T_local)`` score block.
* :func:`ulysses_all_to_all` — the reshard between the sequence-split and
  the head-split layouts, one all-to-all each way (on gloo, one batch of
  point-to-point pairs: gloo lacks all-to-all in some torch releases).
* :func:`reference_attention` — full-sequence attention on one device, the
  oracle of both.

The hop and the all-to-all are ``torch.autograd.Function``s whose backward
is the inverse exchange (how JAX differentiates ``ppermute`` and
``all_to_all``); the block math is plain torch that autograd carries, a
``bias_fn`` included. The block math is no Pallas kernel in the JAX
package either (``jnp.einsum``), so it has no CUDA kernel here.

Transport: on an NCCL group device tensors go to the wire directly. Gloo
takes CUDA tensors for ``broadcast`` and ``all_reduce`` only, so on a gloo
group (the only backend that runs several ranks on one card) a device
tensor is staged through host memory and back; the choice is made from
``dist.get_backend(group)``. Give the ring a group of its own
(``dist.new_group(backend="gloo")`` on every rank, in the same order):
the lockstep runtime pairs its table collectives by their order on the
world group (``runtime/multihost.py``), and ring traffic there would
interleave with them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _block_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # q: (B, Tq, H, D), k: (B, Tk, H, D) -> (B, H, Tq, Tk)
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale


def _direct(group) -> bool:
    """True where the group's backend takes device tensors for p2p and
    all-to-all (NCCL); gloo takes host tensors only."""
    return dist.get_backend(group) == "nccl"


def _peer(group, r: int) -> int:
    """The global rank of the group's rank ``r`` (p2p ops take global
    ranks)."""
    return r if group is None else dist.get_global_rank(group, r)


def _to_wire(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    if _direct(group):
        return [t.contiguous() for t in tensors]
    return [t.detach().to("cpu").contiguous() for t in tensors]


def _shift(tensors: Sequence[torch.Tensor], group, step: int) -> List[torch.Tensor]:
    """Send each tensor to rank ``(r + step) % n`` of ``group`` and return
    what rank ``(r - step) % n`` sent, on the tensors' own device."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    if n == 1:
        return [t.clone() for t in tensors]
    send = _to_wire(tensors, group)
    recv = [torch.empty_like(t) for t in send]
    to, frm = _peer(group, (r + step) % n), _peer(group, (r - step) % n)
    ops = []
    for s, d in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, to, group))
        ops.append(dist.P2POp(dist.irecv, d, frm, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [d.to(t.device) for d, t in zip(recv, tensors)]


class _RingHop(torch.autograd.Function):
    """One hop around the ring: rank r's tensors go to r+1, r-1's arrive.
    The backward sends the gradients the other way (the inverse
    permutation)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        # materialized: an unused output's gradient arrives as zeros
        return (None, *_shift(grads, ctx.group, -1))


def ring_shift(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Rotate ``tensors`` one hop: each rank of ``group`` sends to the next
    and receives from the previous; differentiable."""
    return list(_RingHop.apply(group, *tensors))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   q_offset: Optional[int] = None,
                   bias_fn=None) -> torch.Tensor:
    """Blockwise ring attention over the ranks of ``group``.

    Args:
      q, k, v: this rank's ``(B, T_local, H, D)`` blocks of a global
        ``(B, T, H, D)`` sequence split contiguously on T over the group.
      group: the process group (the default world when None). Every rank
        of it calls this with the same shapes.
      causal: mask with GLOBAL positions.
      q_offset: global position of this block's first query; defaults to
        ``rank * T_local``.
      bias_fn: optional ``bias_fn(q_pos, kv_pos) -> bias`` called once per
        ring step with the GLOBAL position vectors ``(Tq,)`` / ``(Tk,)``
        (int64, on the queries' device); the bias (broadcastable to
        ``(B, H, Tq, Tk)``) is added to the scores before the softmax, so
        no ``(T, T)`` bias is ever built.

    Returns this rank's ``(B, T_local, H, D)`` block of full-sequence
    attention. The K/V block visits every rank; each step folds the local
    queries against one block into the running max ``m``, normalizer ``l``
    and unnormalized output ``o``.
    """
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    if q_offset is None:
        q_offset = idx * T
    dev = q.device
    q_pos = q_offset + torch.arange(T, device=dev)
    m = torch.full((B, H, T), -math.inf, dtype=q.dtype, device=dev)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=dev)
    o = torch.zeros((B, H, T, D), dtype=q.dtype, device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        # the block in hand came from rank idx - step (what JAX rotates)
        kv_idx = (idx - step) % n
        s = _block_scores(q, k_blk, scale)
        kv_pos = kv_idx * T + torch.arange(T, device=dev)
        if bias_fn is not None:
            s = s + bias_fn(q_pos, kv_pos)
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
            s = s.masked_fill(~mask[None, None], -math.inf)
        # the running max only shifts the exponent: out = o / l does not
        # depend on it, so it carries no gradient (m is a constant to
        # autograd, as the flash recurrence treats it)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        dead = torch.isinf(m_new) & (m_new < 0)
        # exp(-inf - -inf) guards: where m_new is still -inf (no visible
        # key yet) p stays 0 and the correction stays 1; the exponent is
        # taken of a finite operand there, so no NaN reaches the backward
        m_safe = m_new.masked_fill(dead, 0.0)
        corr = torch.exp(m - m_safe).masked_fill(dead, 1.0)
        p = torch.exp(s - m_safe[..., None]).masked_fill(dead[..., None], 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        m = m_new
        if step + 1 < n:
            k_blk, v_blk = ring_shift((k_blk, v_blk), group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def _all_to_all(chunks: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Chunk j goes to rank j; returns the chunks every rank sent here, in
    rank order, on the chunks' device. NCCL runs ``dist.all_to_all``; on
    gloo (which lacks all-to-all in some torch releases) the same exchange
    runs as one batch of point-to-point pairs."""
    n = dist.get_world_size(group)
    if n == 1:
        return [c.clone() for c in chunks]
    send = _to_wire(chunks, group)
    recv = [torch.empty_like(c) for c in send]
    if _direct(group):
        dist.all_to_all(recv, send, group=group)
    else:
        me = dist.get_rank(group)
        recv[me].copy_(send[me])
        ops = []
        for j in range(n):
            if j != me:
                ops.append(dist.P2POp(dist.isend, send[j], _peer(group, j),
                                      group))
                ops.append(dist.P2POp(dist.irecv, recv[j], _peer(group, j),
                                      group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [r.to(c.device) for r, c in zip(recv, chunks)]


def _exchange(x: torch.Tensor, group, split_dim: int,
              cat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    chunks = list(torch.chunk(x, n, dim=split_dim))
    return torch.cat(_all_to_all(chunks, group), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    """``lax.all_to_all(tiled=True)``: split ``split_dim`` into one chunk
    per rank, exchange, concatenate on ``cat_dim``. The backward is the
    inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return _exchange(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.group, ctx.cat_dim, ctx.split_dim),
                None, None, None)


def ulysses_all_to_all(x: torch.Tensor, group=None,
                       to_heads: bool = True) -> torch.Tensor:
    """Ulysses reshard between the sequence-split and head-split layouts.

    With group size N and per-rank ``(B, T_local, H, D)``:

    * ``to_heads=True``: gather the FULL sequence for H/N heads, returning
      ``(B, T_local * N, H // N, D)``; any single-device attention then
      runs unchanged on its head slice.
    * ``to_heads=False``: the inverse, back to ``(B, T_local, H, D)``.

    N must divide the head count. One all-to-all each way; differentiable.
    """
    n = dist.get_world_size(group)
    if to_heads:
        H = x.shape[2]
        if H % n != 0:
            name = "world" if group is None else getattr(group, "group_name",
                                                         "group")
            raise ValueError(
                f"ulysses_all_to_all: the '{name}' axis size {n} "
                f"must divide the head count {H} (each shard takes "
                f"H/{n} heads)")
        return _AllToAll.apply(x, group, 2, 1)
    return _AllToAll.apply(x, group, 1, 2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, bias_fn=None) -> torch.Tensor:
    """Full-sequence single-device attention (the oracle of the parallel
    paths; also usable per head slice after a Ulysses reshard). Shapes
    ``(B, T, H, D)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    t = q.shape[1]
    if bias_fn is not None:
        pos = torch.arange(t, device=q.device)
        s = s + bias_fn(pos, pos)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask[None, None], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out.permute(0, 2, 1, 3)
