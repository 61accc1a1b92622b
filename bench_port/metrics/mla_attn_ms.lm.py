"""Attention: the device time of the MLA sections (``MLA_ATTENTION_DEVICE``:
CUDA events around each layer's projections, rope, attention and output
projection, forward and backward), ms a step, from the window's snapshot
of the port's registry. None where the port has no such section."""


def read(ctx):
    mon = ctx.get("snapshot", {}).get("monitors", {}).get("MLA_ATTENTION_DEVICE")
    if not mon or not ctx.get("steps"):
        return None
    return mon["elapse_ms"] / ctx["steps"]
