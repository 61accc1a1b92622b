"""Device: the share of the profiled sub-window in which no operation ran
on the card, %; the word2vec cells' (``peaks.idle_share``)."""

import peaks


def read(ctx):
    return peaks.idle_share(ctx.get("trace"))
