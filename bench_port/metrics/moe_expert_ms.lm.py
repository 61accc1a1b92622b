"""Experts: the device time of the held experts' sections
(``MOE_EXPERTS_DEVICE``: CUDA events around each MoE layer's gather, the
experts' GEMMs and the weighted scatter-back, forward and backward), ms a
step, from the window's snapshot of the port's registry. None where the
port has no such section."""


def read(ctx):
    mon = ctx.get("snapshot", {}).get("monitors", {}).get("MOE_EXPERTS_DEVICE")
    if not mon or not ctx.get("steps"):
        return None
    return mon["elapse_ms"] / ctx["steps"]
