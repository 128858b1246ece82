"""The program's `setop_host` spans (`query/dispatch.py`: a set op the
dispatcher kept on the host, from its route choice to its answer) over
the window: the sum of `span_setop_host_seconds`, in ms a read sent.
None where no such span ended in the window."""


def _stats():
    from dgraph_tpu_torch.utils.observe import METRICS

    return METRICS.hist_stats("span_setop_host_seconds")


def start(ctx):
    ctx.store["setop_host"] = _stats()


def read(ctx):
    s0, n0 = ctx.store["setop_host"]
    s1, n1 = _stats()
    if n1 == n0 or not ctx.records:
        return None
    return (s1 - s0) * 1e3 / len(ctx.records)
