"""The whole step's share of the card's float32 peak, %: the operations
that the corpus tokens fed in the window need (``counts.sgns_flops`` of
their expected kept tokens) over the window's seconds times 67 TFLOP/s,
the H100 SXM data sheet's float32 rate at 700 W; the card's power limit
is printed beside it."""

import peaks


def read(ctx):
    if not ctx.get("window_s") or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * peaks.FP32_FLOPS)
