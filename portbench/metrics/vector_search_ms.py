"""The program's `vector_search` spans (`models/vector.py`: one search
of the vector index, from its route choice to its answer on the host)
over the window: the mean span, in ms. None where no such span ended in
the window."""


def _stats():
    from dgraph_tpu_torch.utils.observe import METRICS

    return METRICS.hist_stats("span_vector_search_seconds")


def start(ctx):
    ctx.store["vector_search"] = _stats()


def read(ctx):
    s0, n0 = ctx.store["vector_search"]
    s1, n1 = _stats()
    if n1 == n0:
        return None
    return (s1 - s0) * 1e3 / (n1 - n0)
