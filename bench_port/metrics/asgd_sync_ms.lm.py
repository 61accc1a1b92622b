"""Parameter sync: the device time of a sync through the table
(``ASGD_SYNC_DEVICE``: CUDA events on the worker's stream, which the
dispatcher shares, around the snapshot of the parameters, the delta, the
update, the merged value and the baseline), ms a sync (a sync every
step), from the window's snapshot of the port's registry. None where the
port has no such section."""


def read(ctx):
    mon = ctx.get("snapshot", {}).get("monitors", {}).get("ASGD_SYNC_DEVICE")
    if not mon or not mon["count"]:
        return None
    return mon["elapse_ms"] / mon["count"]
