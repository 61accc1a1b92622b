"""Kernels: the least time the card needs for the work of the tokens fed in
the profiled sub-window (the larger of their operations at 67 TFLOP/s and
their bytes at 3.35 TB/s), over the summed device time of every kernel in
that sub-window, % (``peaks.roofline_share``)."""

import peaks


def read(ctx):
    return peaks.roofline_share(ctx.get("trace"))
