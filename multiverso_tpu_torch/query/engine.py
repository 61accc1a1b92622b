"""Top-k retrieval per table kind, and the merge algebra (port of
``multiverso_tpu/query/engine.py``).

One ordering contract rules every path in this module: candidates rank by
score DESCENDING, ties by id ASCENDING (``np.lexsort((ids, -scores))`` per
query row). Because the single-table engine and a merge of partial
answers both finish with exactly this ordering, a top-k assembled from
partials equals, ids and score order, an oracle over the same rows,
ties at the k boundary included.

Three serving shapes:

* **MatrixServer** — the logical ``[:num_row, :num_col]`` block of the
  table's tensor (never the column pads, never the sentinel row) is scored
  on the table's device in float32 (TF32 off) and cut to k there by
  :func:`device_topk`.
* **SparseServer** — live rows stack, key-sorted (so index order is id
  order), into one block that goes to the same device path.
* **TieredSparseServer** — hot rows score as one host block; cold segments
  stream through :meth:`TieredStore.scan_blocks` under the ``query_scan``
  wait site, scored **in the compressed domain** where a segment is
  quantized at >= 4 bits (``dot(q, lo + c*step) = lo*sum(q) +
  step*(q @ c.T)``, the cosine row norm from the code moments) and
  decoded otherwise. A scan touches neither the promotion sketch, nor the
  fetch cache, nor the hot dict, so a query leaves the tier hit rate where
  it found it.

``torch.topk`` promises no order among equal scores (``lax.top_k``, which
the JAX package uses, keeps the lower index), so :func:`device_topk` does
not trust it at the k boundary: it takes the k-th score from ``topk``,
keeps every score above it and the lowest-id ties at it, then orders on
(score desc, id asc). Host scoring is float32 end to end.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.dashboard import count
from multiverso_tpu_torch.obs.profiler import wait_site
from multiverso_tpu_torch.tables.matrix_table import MatrixServer
from multiverso_tpu_torch.tables.sparse_table import (SparseFTRLServer,
                                                      SparseServer,
                                                      TieredSparseServer)

_METRICS = ("dot", "cosine")
# zero-norm guard: a zero row or query cosine-scores 0.0 (its dot is 0)
# instead of dividing by zero; shared by the device and host paths
_EPS = np.float32(1e-30)

# compressed-domain floor: below 4 bits the code grid is so coarse that
# scoring it buys nothing over decoding
_COMPRESSED_MIN_BITS = 4


def check_request(request) -> Tuple[np.ndarray, int, str]:
    """Validate and normalize one query: ``(vecs, k, metric)`` ->
    ``(float32 (n_q, dim) contiguous, k >= 1, metric)``. Raises
    ValueError on malformed input."""
    try:
        vecs, k, metric = request
    except (TypeError, ValueError):
        raise ValueError(
            f"query request must be (vecs, k, metric), got {type(request)}")
    vecs = np.ascontiguousarray(vecs, dtype=np.float32)
    if vecs.ndim == 1:
        vecs = vecs.reshape(1, -1)
    if vecs.ndim != 2:
        raise ValueError(f"query vecs must be (n_q, dim), got {vecs.shape}")
    k = int(k)
    if k < 1:
        raise ValueError(f"query k must be >= 1, got {k}")
    metric = str(metric)
    if metric not in _METRICS:
        raise ValueError(f"query metric must be one of {_METRICS}, "
                         f"got {metric!r}")
    return vecs, k, metric


def order_rows(ids: np.ndarray, scores: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Impose THE ordering contract per query row: score descending, ties
    by ascending id."""
    order = np.lexsort((ids, -scores), axis=-1)
    ids = np.take_along_axis(ids, order, axis=1)
    scores = np.take_along_axis(scores, order, axis=1)
    return (ids.astype(np.int64, copy=False),
            scores.astype(np.float32, copy=False))


def merge_topk(parts: List[Tuple[np.ndarray, np.ndarray]], k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge partial top-k answers (per block, later per shard), possibly
    ragged, into the top-k under the ordering contract."""
    ids = np.concatenate(
        [np.asarray(p[0], dtype=np.int64).reshape(len(p[0]), -1)
         for p in parts], axis=1)
    scores = np.concatenate(
        [np.asarray(p[1], dtype=np.float32).reshape(len(p[1]), -1)
         for p in parts], axis=1)
    ids, scores = order_rows(ids, scores)
    return ids[:, :k], scores[:, :k]


# -- fused score + top-k on the table's device --------------------------------

@contextlib.contextmanager
def _full_fp32():
    """Matrix products in full float32 (TF32 off), like the JAX package's
    CPU product; restores the caller's setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=float(_EPS))


def score_block(block: torch.Tensor, vecs: torch.Tensor,
                cosine: bool) -> torch.Tensor:
    """``(n_q, rows)`` float32 scores of every query against every row of
    ``block``, on the block's device."""
    q = vecs.to(torch.float32)
    b = block.to(torch.float32)
    if cosine:
        q = _normalize(q)
        b = _normalize(b)
    with _full_fp32():
        return q @ b.T


def device_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of each row of ``scores`` under the ordering contract:
    ``(indices int64 (n_q, k), scores (n_q, k))``, score descending, ties
    to the lower index, also across the k boundary. ``k <= columns``."""
    top = torch.topk(scores, k, dim=1, sorted=True).values
    kth = top[:, k - 1:k]
    above = scores > kth
    at = scores == kth
    # of the ties at the k-th score, keep the lowest indices that fill k
    need = k - above.sum(dim=1, keepdim=True)
    keep = above | (at & (torch.cumsum(at.to(torch.int32), dim=1) <= need))
    # exactly k per row; nonzero walks each row in ascending index
    idx = torch.nonzero(keep)[:, 1].reshape(scores.shape[0], k)
    picked = torch.gather(scores, 1, idx)
    # a stable sort keeps equal scores in ascending index
    picked, order = torch.sort(picked, dim=1, descending=True, stable=True)
    return torch.gather(idx, 1, order), picked


def _block_topk(block: torch.Tensor, vecs: np.ndarray, k: int, metric: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Score on the block's device, cut to k there, read the k columns
    back: ``(row indices, scores)`` in contract order."""
    q = torch.from_numpy(vecs).to(block.device)
    idx, scores = device_topk(score_block(block, q, metric == "cosine"), k)
    return (idx.cpu().numpy().astype(np.int64, copy=False),
            scores.cpu().numpy().astype(np.float32, copy=False))


# -- host scoring (tiered hot block + cold segments) -------------------------

def _score_rows(vecs: np.ndarray, rows: np.ndarray, metric: str
                ) -> np.ndarray:
    """(n_q, n) float32 scores of decoded host rows."""
    if metric == "cosine":
        vecs = vecs / np.maximum(
            np.linalg.norm(vecs, axis=1, keepdims=True), _EPS)
        rows = rows / np.maximum(
            np.linalg.norm(rows, axis=1, keepdims=True), _EPS)
    return (vecs @ rows.T).astype(np.float32, copy=False)


def _score_codes(vecs: np.ndarray, codes: np.ndarray, lo: np.float32,
                 step: np.float32, metric: str) -> np.ndarray:
    """Compressed-domain scores: every row is ``lo + codes*step``
    elementwise, so the dot folds to ``lo*sum(q) + step*(q @ codes.T)``
    and the row norm (cosine) comes from the code moments; no per-element
    dequantize materializes."""
    lo = np.float32(lo)
    step = np.float32(step)
    if metric == "cosine":
        vecs = vecs / np.maximum(
            np.linalg.norm(vecs, axis=1, keepdims=True), _EPS)
    numer = (lo * vecs.sum(axis=1, keepdims=True)
             + step * (vecs @ codes.T)).astype(np.float32, copy=False)
    if metric == "dot":
        return numer
    width = np.float32(codes.shape[1])
    norm_sq = (width * lo * lo
               + np.float32(2.0) * lo * step * codes.sum(axis=1)
               + step * step * (codes * codes).sum(axis=1))
    norms = np.sqrt(np.maximum(norm_sq, np.float32(0.0)),
                    dtype=np.float32)
    return (numer / np.maximum(norms, _EPS)).astype(np.float32,
                                                    copy=False)


def _block_topk_np(keys: np.ndarray, scores: np.ndarray, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block host top-k in contract order; keys map score columns back
    to ids."""
    k_eff = min(k, scores.shape[1])
    ids = np.broadcast_to(keys.reshape(1, -1), scores.shape)
    ids, scores = order_rows(np.ascontiguousarray(ids),
                             np.ascontiguousarray(scores))
    return ids[:, :k_eff], scores[:, :k_eff]


# -- per-kind serving --------------------------------------------------------

def _empty(n_q: int) -> Tuple[np.ndarray, np.ndarray]:
    return (np.zeros((n_q, 0), np.int64), np.zeros((n_q, 0), np.float32))


def _query_matrix(table: MatrixServer, vecs: np.ndarray, k: int,
                  metric: str) -> Tuple[np.ndarray, np.ndarray]:
    if vecs.shape[1] != table.num_col:
        raise ValueError(f"query dim {vecs.shape[1]} != table width "
                         f"{table.num_col}")
    if table.num_row == 0:
        return _empty(len(vecs))
    # logical block only: the column pads and the sentinel row never rank
    block = table.data[:table.num_row, :table.num_col]
    return _block_topk(block, vecs, min(k, table.num_row), metric)


def _query_sparse(table: SparseServer, vecs: np.ndarray, k: int,
                  metric: str) -> Tuple[np.ndarray, np.ndarray]:
    if vecs.shape[1] != table.width:
        raise ValueError(f"query dim {vecs.shape[1]} != table width "
                         f"{table.width}")
    store = table._store
    if not store:
        return _empty(len(vecs))
    keys = np.fromiter(store.keys(), dtype=np.int64, count=len(store))
    keys.sort()  # index order = id order, for the tie contract
    block = np.stack([store[key] for key in keys.tolist()]).astype(
        np.float32, copy=False)
    idx, scores = _block_topk(torch.from_numpy(block).to(table.device), vecs,
                              min(k, len(keys)), metric)
    return keys[idx], scores


def _query_tiered(table: TieredSparseServer, vecs: np.ndarray, k: int,
                  metric: str) -> Tuple[np.ndarray, np.ndarray]:
    if vecs.shape[1] != table.width:
        raise ValueError(f"query dim {vecs.shape[1]} != table width "
                         f"{table.width}")
    parts: List[Tuple[np.ndarray, np.ndarray]] = []
    with wait_site("query_scan"):
        for keys, rows, quant in table._tier.scan_blocks():
            if not len(keys):
                continue
            if quant is not None:
                lo, step, bits, codes = quant
                if bits >= _COMPRESSED_MIN_BITS:
                    count("QUERY_COMPRESSED_SEGMENTS")
                    scores = _score_codes(vecs, codes, lo, step, metric)
                else:
                    # too coarse to fold: dequantize (the fetch path's
                    # values) and score plain
                    rows = (np.float32(lo)
                            + codes * np.float32(step)).astype(
                                np.float32, copy=False)
                    scores = _score_rows(vecs, rows, metric)
                count("QUERY_COLD_SEGMENTS_SCANNED")
            else:
                if rows.dtype != np.float32:
                    rows = rows.astype(np.float32)
                scores = _score_rows(vecs, rows, metric)
            parts.append(_block_topk_np(keys, scores, k))
            # running merge: the candidate set stays <= 2k wide however
            # many cold segments the scan streams through
            if len(parts) > 1:
                parts = [merge_topk(parts, k)]
    if not parts:
        return _empty(len(vecs))
    return merge_topk(parts, k)


def query_table(table, request) -> Tuple[np.ndarray, np.ndarray]:
    """Serve one query against one server table: ``(vecs, k, metric)`` ->
    ``(ids int64 (n_q, k'), scores float32 (n_q, k'))`` with
    ``k' = min(k, rows)``, in contract order. Matrix ids are row indices,
    sparse and tiered ids are keys. Refuses kinds without row-shaped,
    scorable state."""
    vecs, k, metric = check_request(request)
    if isinstance(table, MatrixServer):
        return _query_matrix(table, vecs, k, metric)
    if isinstance(table, TieredSparseServer):
        return _query_tiered(table, vecs, k, metric)
    if isinstance(table, SparseFTRLServer):
        raise TypeError("top-k query is unsupported on FTRL tables: the "
                        "stored (z, n) state is not the weight vector")
    if isinstance(table, SparseServer):
        return _query_sparse(table, vecs, k, metric)
    raise TypeError(f"top-k query needs row-shaped table state; "
                    f"{type(table).__name__} has none")
