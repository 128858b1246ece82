"""setop_rows' share of its roofline (`ops/setop_rows.py`, CUDA C++
`csrc/setop_rows.cu`, kernel `setop_rows_single_pass`), in %: the least
time of every call in the window (portbench.roofline.setop_rows_bound_s,
at the published H100 peak) over the kernel's traced device time. Each
call's operands are held by reference (the dispatcher stages fresh
ones for every call) and counted after the window, so no work of the
benchmark's own runs on the card inside it."""

from portbench import roofline
from portbench.metrics._launches import Recorder, share

NAMES = ("intersect_ragged", "difference_ragged", "intersect_batch", "difference_batch",
         "compact_batch")


def start(ctx):
    from dgraph_tpu_torch.ops import setop_rows

    ctx.store["setop_rows"] = [
        Recorder(setop_rows, name, lambda *args, _n=name: (_n, args)) for name in NAMES]


def read(ctx):
    total = 0.0
    for rec in ctx.store["setop_rows"]:
        rec.undo()
        for name, args in rec.calls:
            total += roofline.setop_rows_bound_s(name, args)
        rec.calls.clear()
    return share(ctx, total, ("setop_rows_single_pass",))
