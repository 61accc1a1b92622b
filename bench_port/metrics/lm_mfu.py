"""Whole step: the operations of the steps completed in the window
(``counts_lm.step_flops``: forward and backward at the configuration's
shapes) over the window's seconds times 989.4 TFLOP/s, the H100 SXM data
sheet's dense bfloat16 rate at 700 W (the matmuls run in bfloat16); the
card's power limit is printed beside it."""

import counts_lm


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * counts_lm.BF16_FLOPS)
