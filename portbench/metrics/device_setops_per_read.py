"""The set-op kernels' launch counters (`ops/setop_rows.py`,
`ops/setop_merge.py`, `ops/member_sweep.py` LAUNCHES) over the window,
a read sent: how often the dispatcher sent a read's set ops to the
card."""


def _launches():
    from dgraph_tpu_torch.ops import member_sweep, setop_merge, setop_rows

    return setop_rows.LAUNCHES + sum(setop_merge.LAUNCHES.values()) + member_sweep.LAUNCHES


def start(ctx):
    ctx.store["setop_launches"] = _launches()


def read(ctx):
    if not ctx.records:
        return None
    return (_launches() - ctx.store["setop_launches"]) / len(ctx.records)
