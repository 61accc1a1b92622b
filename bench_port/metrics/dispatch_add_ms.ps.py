"""Dispatcher and server table: the dispatcher's host time applying an Add
of 10-100% of the rows (``SERVER_PROCESS_ADD_MSG``: the duplicate check,
bucket, pinned upload, scatter launch), over the acknowledged Adds, ms.
Adds are stream-ordered, so this is the time to issue an Add, not its
device time. Dashboard deltas over the window."""


def read(ctx):
    dash, adds = ctx.get("dashboard"), ctx.get("acked_adds", 0)
    if not dash or not adds:
        return None
    return dash["SERVER_PROCESS_ADD_MSG"][1] / adds
