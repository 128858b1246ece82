"""Launch shapes of a port kernel in the window, recorded by a wrapper
put on the wrapper function the program calls, for a roofline share."""

import threading


class Recorder:
    """Replaces `module.attr` with a function that records `note(*args)`
    for each call and then calls the original; `undo` puts it back."""

    def __init__(self, module, attr, note):
        self.module, self.attr, self.real = module, attr, getattr(module, attr)
        self.calls = []
        lock = threading.Lock()
        real, calls = self.real, self.calls

        def wrapped(*args, **kw):
            rec = note(*args, **kw)
            with lock:
                calls.append(rec)
            return real(*args, **kw)

        setattr(module, attr, wrapped)

    def undo(self):
        setattr(self.module, self.attr, self.real)


def share(ctx, bound_s_total, names):
    """Least time over the traced device time of the kernels, in %, or
    None where the trace holds none of them."""
    t, n = ctx.devtrace.kernel_s(*names) if ctx.devtrace is not None else (0.0, 0)
    if n == 0 or t <= 0:
        return None
    return 100.0 * bound_s_total / t
