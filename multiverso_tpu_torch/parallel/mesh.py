"""Device placement and layout helpers (port of ``multiverso_tpu/parallel/mesh.py``).

The JAX package places every table on a ``jax.sharding.Mesh`` whose
``server`` axis is the reference's server ranks. Here one torch device is
one server shard, so in one process placement reduces to picking that
device. In a multi-process lockstep world (``runtime/multihost.py``) the
mesh is the world's ranks, one device each: :func:`build_mesh` lays them
out in the ``mesh_shape`` flag's shape, and :func:`table_sharding` gives a
rank its contiguous row range of a table (``shard_ranges``: equal chunks,
the remainder to the last rank), where the JAX package split the rows over
its mesh's devices. The layout helpers keep the JAX package's semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import log

#: Row vectors are a whole number of these bytes: the row kernels move one
#: 16-byte vector per thread (``csrc/rows.cu``).
VECTOR_BYTES = 16


def parse_mesh_shape(text: str) -> Optional[Tuple[int, ...]]:
    """Parse '2x4'-style mesh shape flags; empty → None (auto 1-D)."""
    text = text.strip()
    if not text:
        return None
    return tuple(int(tok) for tok in text.replace("*", "x").split("x"))


@dataclass(frozen=True)
class RankMesh:
    """A world's ranks laid out on named axes (one device per rank): the
    counterpart of the JAX package's device mesh. ``ranks`` holds the rank
    at each mesh position."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def build_mesh(world: int = 1, shape: Optional[Tuple[int, ...]] = None,
               axis_names: Sequence[str] = ("server",)) -> RankMesh:
    """The world's ``world`` ranks in ``shape`` (auto: 1-D over every
    rank, trailing axes of size 1). A shape that does not hold exactly
    the world's ranks is fatal."""
    if shape is None:
        shape = (int(world),) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        log.fatal("mesh_shape %s has %d axes but mesh_axes names %d (%s)",
                  "x".join(map(str, shape)), len(shape), len(axis_names),
                  ",".join(axis_names))
    if int(np.prod(shape)) != int(world):
        log.fatal("mesh_shape %s holds %d ranks; the world has %d",
                  "x".join(map(str, shape)), int(np.prod(shape)), world)
    return RankMesh(np.arange(int(world)).reshape(shape), tuple(axis_names))


def table_sharding(total: int, rank: int = 0, world: int = 1
                   ) -> Tuple[int, int]:
    """Rank ``rank``'s row range ``[lo, hi)`` of a ``total``-row table
    split over ``world`` ranks (reference analog: range sharding over
    server ranks, ``src/table/matrix_table.cpp:25-45``)."""
    return shard_ranges(int(total), int(world))[int(rank)]


def replicated(total: int) -> Tuple[int, int]:
    """The row range of a table every rank holds whole (the KV and sparse
    kinds): all of it."""
    return 0, int(total)


def build_device(spec: str) -> torch.device:
    """The device that holds the server tables: ``cuda`` / ``cuda:<i>`` or
    ``cpu``. Asking for CUDA where there is none is fatal — the runtime
    never carries on quietly on the host."""
    device = torch.device(spec)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            log.fatal("device %r asked for, but torch finds no CUDA device; "
                      "pass device='cpu' (or -device=cpu) to run on the host",
                      spec)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        log.fatal("unsupported table device %r (want cuda[:i] or cpu)", spec)
    return device


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n (shard-divisibility padding)."""
    return ((n + k - 1) // k) * k


def padded_cols(num_col: int, dtype) -> int:
    """Columns of a row padded to whole 16-byte vectors (50 fp32 -> 52).
    The JAX package pads to the TPU's 128 lanes instead; the padding is
    never visible through the table API."""
    itemsize = np.dtype(dtype).itemsize
    if VECTOR_BYTES % itemsize:
        log.fatal("dtype %s does not tile a %d-byte vector", np.dtype(dtype),
                  VECTOR_BYTES)
    return pad_to_multiple(num_col, VECTOR_BYTES // itemsize)


def shard_ranges(total: int, num_shards: int) -> List[Tuple[int, int]]:
    """Equal-chunk ranges with remainder to the last shard — mirrors the
    reference's server offset computation."""
    chunk = total // num_shards
    ranges = []
    for i in range(num_shards):
        begin = chunk * i
        end = total if i == num_shards - 1 else chunk * (i + 1)
        ranges.append((begin, end))
    return ranges


def table_shards() -> int:
    """Server shards a device-resident table spreads over: the size of the
    JAX package's ``server`` mesh axis. One torch device is one shard."""
    return 1
