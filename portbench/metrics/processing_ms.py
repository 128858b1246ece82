"""Mean `extensions.server_latency.processing_ns` over the window's answered reads,
in ms: the program's own wall time on the host for this stage, which
under concurrency includes waiting for the interpreter lock."""

from portbench.stats import mean


def read(ctx):
    xs = ctx.server_latency_ms("processing_ns")
    return mean(xs) if xs else None
