"""Device placement and layout helpers (port of ``multiverso_tpu/parallel/mesh.py``).

The JAX package places every table on a ``jax.sharding.Mesh`` whose
``server`` axis is the reference's server ranks. Here one torch device is
one server shard, so placement reduces to picking that device. The layout
helpers keep the JAX package's semantics.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import log

#: Row vectors are a whole number of these bytes: the row kernels move one
#: 16-byte vector per thread (``csrc/rows.cu``).
VECTOR_BYTES = 16


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
