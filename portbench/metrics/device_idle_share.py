"""1 minus the union of the device's kernel, copy and fill intervals over
the traced window's length (torch.profiler, CUPTI)."""


def read(ctx):
    t = ctx.devtrace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s() / t.window_s
