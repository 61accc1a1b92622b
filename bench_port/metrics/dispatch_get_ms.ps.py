"""Dispatcher and server table: the dispatcher's host time serving a Get
of the whole table (``SERVER_PROCESS_GET_MSG``: the device copy and the
host read), ms a Get. Dashboard deltas over the window."""


def read(ctx):
    dash = ctx.get("dashboard")
    if not dash or not dash["SERVER_PROCESS_GET_MSG"][0]:
        return None
    count, ms = dash["SERVER_PROCESS_GET_MSG"]
    return ms / count
