"""The process's CPU time over the window (`resource.getrusage`, every
thread, user and system), in ms a read sent."""


def read(ctx):
    return ctx.cpu_s * 1e3 / len(ctx.records) if ctx.records else None
