"""The 95th percentile of every read's latency in the window, timed at
the client from send to answer (host clock). A failed read counts as
slower than any answered one: as the window's length and the 600 s the
harness waits for the last answers."""

import math

from portbench.stats import percentile


def read(ctx):
    slowest = (ctx.seconds + 600.0) * 1e3
    return percentile([slowest if math.isinf(x) else x for x in ctx.latencies_ms()], 95)
