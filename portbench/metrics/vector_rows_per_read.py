"""The program's `vector_rows_scanned_total` counter (`models/vector.py`:
rows a search scored, the probed slabs' 128 rows each on the IVF tier,
the live rows on a full scan) over the window, a read sent. None where
nothing was counted."""


def _rows():
    from dgraph_tpu_torch.utils.observe import METRICS

    return METRICS.value("vector_rows_scanned_total")


def start(ctx):
    ctx.store["vector_rows"] = _rows()


def read(ctx):
    rows = _rows() - ctx.store["vector_rows"]
    if rows <= 0 or not ctx.records:
        return None
    return rows / len(ctx.records)
