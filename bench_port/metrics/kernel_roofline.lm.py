"""Kernels: the least time the card needs for the steps of the profiled
sub-window (the larger of their operations at 989.4 TFLOP/s, the dense
bfloat16 rate, and their bytes at 3.35 TB/s; ``counts_lm``), over the
summed device time of every kernel in that sub-window, %."""

import counts_lm
import peaks


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["kernel_s"] <= 0 or not trace.get("work_flops"):
        return None
    least = max(trace["work_flops"] / counts_lm.BF16_FLOPS,
                trace.get("work_bytes", 0) / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / trace["kernel_s"]
