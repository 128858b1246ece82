"""Reads answered in the window, over the window's seconds, across all
clients (host clock)."""

from portbench.stats import rate


def read(ctx):
    return rate(ctx.answered_in_window(), ctx.seconds)
