"""multiverso_tpu_torch — the Multiverso parameter server on PyTorch and CUDA.

The port of :mod:`multiverso_tpu` (the JAX package, which stays as the
reference) to torch tensors on an NVIDIA GPU. Module paths mirror the JAX
package's, so each module's counterpart is found by name. Table state lives
in torch tensors on one device; row Adds and row Gets run hand-written
CUDA kernels (``csrc/rows.cu``) on the card and their plain PyTorch
versions on the CPU.

Public surface (MV_* parity, the part ported so far):

    init / shutdown / barrier / process_barrier
    rank / size / num_workers / num_servers / worker_id / server_id
    worker_id_to_rank / server_id_to_rank / is_master_worker
    set_flag / get_flag / parse_cmd_flags
    create_table("array" | "matrix" | "kv" | "sparse" | "tiered_sparse"
                 | "tiered_kv") / register_table_type
    worker(slot)                   (bind a logical worker context to a thread)
    aggregate                      (MV_Aggregate: a sum across worker contexts)
    query                          (server-side top-k retrieval pushdown)

``create_table("kv", dtype, capacity=N)`` puts the KV table's keys and
values on the device (``DeviceKVServer``); the tiered kinds keep a hot set
of rows in host memory and spill the rest to disk (``store/``).

Checkpoints live in :mod:`multiverso_tpu_torch.checkpoint` (``store_table``,
``load_table``, ``restore_tables``, ``CheckpointDriver``), as in the JAX
package, over the stream layer of :mod:`multiverso_tpu_torch.io`; their
files load in either package.

``init`` puts the tables on ``cuda`` unless the caller asks for the CPU
(``init(device="cpu")`` or ``-device=cpu``); it raises when CUDA is absent
and the CPU was not asked for.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Sequence

from multiverso_tpu_torch import log  # noqa: F401  (re-export)
from multiverso_tpu_torch.config import get_flag, parse_cmd_flags, set_flag  # noqa: F401
from multiverso_tpu_torch.dashboard import Dashboard, monitor  # noqa: F401
from multiverso_tpu_torch.runtime.node import Role  # noqa: F401
from multiverso_tpu_torch.runtime.programs import clear_programs
from multiverso_tpu_torch.runtime.zoo import Zoo

__version__ = "0.1.0"


# -- lifecycle (MV_Init / MV_ShutDown / MV_Barrier) -------------------------

def init(argv: Optional[Sequence[str]] = None, sync: Optional[bool] = None,
         **flag_overrides: Any) -> list:
    """Bring up the runtime. ``argv`` accepts ``-key=value`` tokens (CLI
    parity); keyword overrides hit the same flag registry
    (e.g. ``init(local_workers=4)``, ``init(device="cpu")``). Flags stay
    set after ``shutdown``, as in the reference."""
    if sync is not None:
        set_flag("sync", sync)
    for key, value in flag_overrides.items():
        set_flag(key, value)
    return Zoo.instance().start(argv)


def shutdown(finalize_net: bool = True) -> None:
    """Stop the runtime and forget its named programs: a registered program
    closes over the tables it was built for."""
    Zoo.instance().stop(finalize_net)
    clear_programs()


def barrier() -> None:
    Zoo.instance().barrier()


def process_barrier() -> None:
    """Cross-process rendezvous: a no-op in a single process."""
    Zoo.instance().process_barrier()


# -- identity ---------------------------------------------------------------

def rank() -> int:
    return Zoo.instance().rank


def size() -> int:
    return Zoo.instance().size


def num_workers() -> int:
    return Zoo.instance().num_workers


def workers_num() -> int:  # python-binding spelling
    return num_workers()


def num_servers() -> int:
    return Zoo.instance().num_servers


def server_num() -> int:  # python-binding spelling
    return num_servers()


def worker_id() -> int:
    return Zoo.instance().current_worker_id()


def server_id() -> int:
    return Zoo.instance().node.server_id


def worker_id_to_rank(wid: int) -> int:
    return Zoo.instance().worker_id_to_rank(wid)


def server_id_to_rank(sid: int) -> int:
    return Zoo.instance().server_id_to_rank(sid)


def is_master_worker() -> bool:
    """Worker 0 seeds shared state (python-binding contract)."""
    return worker_id() == 0


@contextlib.contextmanager
def worker(local_slot: int) -> Iterator[int]:
    """Bind the calling thread to logical worker context ``local_slot``."""
    zoo = Zoo.instance()
    zoo.bind_worker(local_slot)
    try:
        yield zoo.rank * zoo.local_workers + local_slot
    finally:
        zoo.bind_worker(0)


# -- collectives (MV_Aggregate) ---------------------------------------------

def aggregate(data: Any) -> Any:
    """Elementwise sum of ``data`` across every local worker context; every
    caller gets its own copy of the sum (in-place-sum semantics of
    ``MV_Aggregate``).

    Host inputs (numpy arrays, or lists of them: a model's leaves) sum on
    the host. Device inputs (a tensor or a list of them) sum on their
    device, in slot order, and each worker gets its own buffers. Mixing
    host and device values across workers in one round is fatal."""
    return Zoo.instance().aggregate(data)


# Bind the retrieval subpackage NOW so the front door below wins the
# `query` name on this module: once multiverso_tpu_torch.query sits in
# sys.modules, later imports of it (or its engine) never re-assign the
# parent attribute over the function.
from multiverso_tpu_torch import query as _query_plane  # noqa: E402,F401


def query(table: Any, vecs: Any, k: int, metric: str = "dot"):
    """Server-side top-k retrieval pushdown over ``table`` (``query/``):
    score every row against the query matrix ``vecs`` ((n_q, dim)
    float32) under ``metric`` (``dot`` | ``cosine``) and return
    ``(ids, scores)``, each (n_q, k') with k' = min(k, rows), ranked
    score-descending, ties toward the lower id."""
    return table.query(vecs, k, metric=metric)


# -- tables -----------------------------------------------------------------

from multiverso_tpu_torch.tables.array_table import ArrayServer, ArrayWorker  # noqa: E402,F401
from multiverso_tpu_torch.tables.kv_table import (  # noqa: E402,F401
    DeviceKVServer, KVServer, KVWorker, TieredKVServer, make_tiered_kv)
from multiverso_tpu_torch.tables.matrix_table import MatrixServer, MatrixWorker  # noqa: E402,F401
from multiverso_tpu_torch.tables.sparse_table import (  # noqa: E402,F401
    SparseWorker, TieredSparseServer, make_tiered_sparse)
from multiverso_tpu_torch.updaters import AddOption, GetOption  # noqa: E402,F401

ArrayTableHandler = ArrayWorker  # python-binding names
MatrixTableHandler = MatrixWorker

_TABLE_TYPES = {
    "array": ArrayWorker,
    "matrix": MatrixWorker,
    "kv": KVWorker,
    "sparse": SparseWorker,
    # beyond-RAM variants (store/)
    "tiered_sparse": make_tiered_sparse,
    "tiered_kv": make_tiered_kv,
}


def create_table(kind: str, *args: Any, **kwargs: Any):
    """``MV_CreateTable`` parity: construct a worker/server table pair (the
    server side registers with the dispatcher automatically)."""
    try:
        cls = _TABLE_TYPES[kind]
    except KeyError:
        log.fatal("unknown table kind %r (have: %s)", kind, sorted(_TABLE_TYPES))
    return cls(*args, **kwargs)


def register_table_type(kind: str, factory: Any) -> None:
    """Table-extension API: apps register custom tables."""
    _TABLE_TYPES[kind] = factory
