"""The program's `ivf_train` spans (`models/vector.py`: the IVF tier's
k-means, cell assignment, slab layout and upload) in the run's set-up,
in s: the sum of `span_ivf_train_seconds` when the window opens. None
where no such span ended."""


def start(ctx):
    from dgraph_tpu_torch.utils.observe import METRICS

    ctx.store["ivf_train"] = METRICS.hist_stats("span_ivf_train_seconds")


def read(ctx):
    total, count = ctx.store["ivf_train"]
    return total if count else None
