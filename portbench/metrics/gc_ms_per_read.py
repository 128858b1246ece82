"""The program's garbage-collection pause counters
(`gc_gen{0,1,2}_pause_seconds_total`, `utils/hosttrace.py`, published
at the end of every read) over the window, in ms a read sent.

The counters are read first when the window's first read starts, so that
the harness's own collection before the window stays out; a read's
pauses are published when it ends. None where the program counts no
collections (no collector hook)."""

import threading


def _paused_s() -> float:
    from dgraph_tpu_torch.utils.observe import METRICS

    return sum(METRICS.value(f"gc_gen{g}_pause_seconds_total") for g in (0, 1, 2))


def start(ctx):
    try:
        from dgraph_tpu_torch.utils import hosttrace
    except ImportError:
        return
    if not hosttrace.gc_hook_installed():
        return
    server = ctx.server
    real = server.query
    lock = threading.Lock()

    def first(*args, **kw):
        with lock:
            if "gc_paused_s" not in ctx.store:
                hosttrace.publish_gc()
                ctx.store["gc_paused_s"] = _paused_s()
                server.query = real
        return real(*args, **kw)

    server.query = first


def read(ctx):
    base = ctx.store.get("gc_paused_s")
    if base is None or not ctx.records:
        return None
    return (_paused_s() - base) * 1e3 / len(ctx.records)
