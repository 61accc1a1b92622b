"""Device: the share of the profiled sub-window in which no operation ran
on the card, %; the language-model cell's (``peaks.idle_share``)."""

import peaks


def read(ctx):
    return peaks.idle_share(ctx.get("trace"))
