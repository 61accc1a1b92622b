"""Worker API: the mean time an acknowledged Add spends in the worker's
call (``WORKER_TABLE_SYNC_ADD``) beyond what the dispatcher spent applying
it (``SERVER_PROCESS_ADD_MSG`` over the acknowledged Adds): its wait in the
queue and its hand-off, ms. Dashboard deltas over the window."""


def read(ctx):
    dash, adds = ctx.get("dashboard"), ctx.get("acked_adds", 0)
    if not dash or not adds or not dash["WORKER_TABLE_SYNC_ADD"][0]:
        return None
    count, call_ms = dash["WORKER_TABLE_SYNC_ADD"]
    return call_ms / count - dash["SERVER_PROCESS_ADD_MSG"][1] / adds
