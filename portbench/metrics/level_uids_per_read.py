"""The program's `level_task_uids` counter (uids the executor expanded
level by level, `query/subgraph.py`) over the window, a read sent."""


def start(ctx):
    from dgraph_tpu_torch.utils.observe import METRICS

    ctx.store["level_task_uids"] = METRICS.value("level_task_uids")


def read(ctx):
    from dgraph_tpu_torch.utils.observe import METRICS

    if not ctx.records:
        return None
    return (METRICS.value("level_task_uids") - ctx.store["level_task_uids"]) / len(ctx.records)
