"""Kernels: the least time the card needs for the HBM bytes of the Adds
and Gets of the profiled sub-window (``counts.add_bytes``,
``counts.whole_get_bytes``) at 3.35 TB/s, over the summed device time of
every kernel in that sub-window, % (``peaks.roofline_share``)."""

import peaks


def read(ctx):
    return peaks.roofline_share(ctx.get("trace"))
