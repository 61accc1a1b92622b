"""Retrieval query plane: server-side top-k scoring pushdown (port of
``multiverso_tpu/query/``, for tables in the same process).

Score a block of query vectors against an embedding table where the table
lives and hand back only ``(ids, scores)``: the
:func:`~multiverso_tpu_torch.query.engine.query_table` engine runs on the
dispatcher (``Request_Query``), a fused score and top-k on the table's
device for matrix and sparse tables, host scans of the hot block and the
cold segments for tiered ones. :func:`merge_topk` merges partial answers
under the same ordering contract.

A remote client's queries ride the read tier (``runtime/read.py``): a
read replica answers them under the same staleness budget as a Get.

Not yet ported: the shard router's fan-out and merge over shards (it
waits for ``shard/``, ``ROADMAP.md``).
"""

__all__ = ["merge_topk", "query_table"]


def __getattr__(name):
    # Lazy re-exports (PEP 562): the package root binds THIS package
    # eagerly so its `mvt.query(...)` front door can shadow the submodule
    # name; deferring the engine import keeps that bind free of the table
    # imports at `import multiverso_tpu_torch` time.
    if name in __all__:
        from multiverso_tpu_torch.query import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
