"""From the process's start to the window's start (host clock): making
the data, loading it, building the device state and kernels, warming
up. The first run in a checkout also compiles."""


def read(ctx):
    return ctx.setup_s
