"""Device-resident static-capacity hash table: open addressing over int32
keys (port of ``multiverso_tpu/ops/device_hash.py``).

Reference capability (not copied): ``KVTable``, a distributed
``unordered_map<Key,Val>`` hash-sharded ``key % num_servers``
(``include/multiverso/table/kv_table.h:19-118``), its storage host RAM.

The table is a pair of fixed-capacity tensors on the device (keys int32,
values), probed by double hashing. The JAX package writes both operations
as jitted XLA programs, not Pallas kernels; here they are the same steps
as torch ops on the tensors' device:

* :func:`hash_add`: ``MAX_PROBE`` claim rounds. Each round scatters the
  unresolved keys onto their probe slot, only where that slot is EMPTY
  (when several lanes claim one slot, the scatter lands one of them and
  a confirming gather tells the winner from the losers, which retry at
  their next probe); then ONE scatter-add puts the winners' values on
  their slots. Batch keys must be unique (the caller combines
  duplicates): the claim protocol relies on it.
* :func:`hash_get`: ``MAX_PROBE`` rounds of gather and compare; missing
  keys read 0.
* Slot ``capacity`` is scratch: masked-out lanes scatter there, and both
  operations leave it EMPTY/0, so no branch and no shape depends on the
  data.

Keys left unresolved after the last round are flagged per lane; their
values were NOT applied, so the caller (``DeviceKVServer``) rebuilds at a
larger capacity and re-inserts exactly the flagged lanes. Keys are int32
>= 0; -1 is EMPTY and batch padding.

Port notes:

* The probe hash is unsigned 32-bit arithmetic. Torch's ``uint32`` has
  few kernels, so :func:`probe_slots` computes in int64 and keeps every
  intermediate below 2^63 (the multiply by the 32-bit golden-ratio
  constant goes in two 16-bit halves), masking to 32 bits after each
  multiply and add. Masked values are non-negative, so ``>>`` is the
  logical shift ``uint32`` has. The slot sequence equals the JAX
  package's for every int32 key and probe.
* When two lanes claim one slot, ``index_put_`` lands an arbitrary one of
  them on CUDA (XLA's scatter picks its own), so slot layouts may differ
  from the JAX package's while the key -> value map does not.
* The value scatter touches each live slot at most once (the batch keys
  are unique), so it is deterministic; only the scratch slot takes
  several lanes, and it is reset to 0 after the call.
"""

from __future__ import annotations

from typing import Tuple

import torch

EMPTY = -1
MAX_PROBE = 16

_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761   # Knuth's multiplicative constant, as the JAX package
_STEP = 40503


def _mul32(k: torch.Tensor, c: int) -> torch.Tensor:
    """``(k * c) mod 2^32`` for int64 ``0 <= k < 2^32``, ``0 <= c < 2^32``,
    without an int64 product above 2^48."""
    lo = k & 0xFFFF
    hi = k >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def hashes(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h1, h2)`` of the double hash, int64 in ``[0, 2^32)``: ``h1`` the
    mixed key, ``h2`` the odd step (odd steps are coprime to a
    power-of-two capacity, so the sequence covers every slot)."""
    k = keys.to(torch.int64) & _MASK32       # the uint32 view of the key
    h1 = _mul32(k, _GOLDEN)
    h1 = h1 ^ (h1 >> 15)
    h2 = ((k * _STEP) & _MASK32) | 1
    return h1, h2


def probe_slots(h1: torch.Tensor, h2: torch.Tensor, probe: int,
                capacity: int) -> torch.Tensor:
    """Probe ``probe``'s slot, ``(h1 + probe*h2) mod 2^32 & (capacity-1)``,
    int64."""
    return ((h1 + probe * h2) & _MASK32) & (capacity - 1)


def probe_slot(key: torch.Tensor, probe: int, capacity: int) -> torch.Tensor:
    """The JAX package's ``_probe_slot``: one probe's slot for each key."""
    h1, h2 = hashes(key)
    return probe_slots(h1, h2, probe, capacity)


def hash_add(keys: torch.Tensor, values: torch.Tensor,
             batch_keys: torch.Tensor, batch_values: torch.Tensor,
             capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert-or-accumulate a batch of UNIQUE keys (pad with -1), in place.

    ``keys``/``values`` have length ``capacity + 1`` (the last slot is
    scratch) and lie on one device with the batch. Returns
    ``(overflow_flags, inserted_count)`` as device tensors:

    * ``overflow_flags`` (bool, per lane) mark live lanes that could not
      be placed; their values were NOT accumulated, so re-inserting
      exactly the flagged lanes after a rebuild is lossless;
    * ``inserted_count`` (int64 scalar) is the number of lanes that
      claimed a NEW slot (against accumulating into an existing key):
      the caller's exact live counter."""
    bk = batch_keys.to(torch.int32)
    live = bk >= 0
    resolved = ~live
    slot_found = torch.zeros(bk.shape, dtype=torch.int64, device=bk.device)
    inserted = torch.zeros(bk.shape, dtype=torch.bool, device=bk.device)
    scratch = torch.full(bk.shape, capacity, dtype=torch.int64,
                         device=bk.device)
    empty = torch.full_like(bk, EMPTY)
    h1, h2 = hashes(bk)
    for p in range(MAX_PROBE):
        cand = probe_slots(h1, h2, p, capacity)
        cur = keys[cand]
        open_ = ~resolved
        match = (cur == bk) & open_
        claimable = (cur == EMPTY) & open_
        # claim empties; of several lanes on one slot the scatter lands
        # one, and the confirming gather tells the winner from the losers
        keys.index_put_((torch.where(claimable, cand, scratch),),
                        torch.where(claimable, bk, empty))
        won = (match | claimable) & (keys[cand] == bk) & open_
        # a lane that won through a claim (its slot was EMPTY) took a
        # fresh slot
        inserted |= claimable & won
        slot_found = torch.where(won, cand, slot_found)
        resolved |= won
    vidx = torch.where(resolved & live, slot_found, scratch)
    values.index_add_(0, vidx, batch_values.to(values.dtype))
    # the scratch slot took the masked lanes' values; reset it
    keys[capacity] = EMPTY
    values[capacity] = 0
    return live & ~resolved, inserted.sum()


def hash_get(keys: torch.Tensor, values: torch.Tensor,
             batch_keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """Look up a batch of keys (pad with -1); missing and padded keys
    read 0."""
    bk = batch_keys.to(torch.int32)
    out = torch.zeros(bk.shape, dtype=values.dtype, device=bk.device)
    found = bk < 0
    h1, h2 = hashes(bk)
    for p in range(MAX_PROBE):
        cand = probe_slots(h1, h2, p, capacity)
        hit = (keys[cand] == bk) & ~found
        out = torch.where(hit, values[cand], out)
        found |= hit
    return out
