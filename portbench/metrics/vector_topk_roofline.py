"""KV1's share of its roofline (`ops/vector_topk.py`, CUDA C++
`csrc/vector_topk.cu`, kernels `topk_*_kernel`), in %: the least time of
every call in the window over the kernels' traced device time.

A call's least time is its bytes at the H100's 3.35 TB/s: its rows x
columns float32 scores read once (the columns the call ranks: all of
x's, or the `col_index` it gathers), and each row's k distances and
indices written (8 bytes each). The shapes of each call are noted by a
wrapper on the function the program calls and counted after the
window."""

from portbench.metrics._launches import Recorder, share

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
KERNELS = ("topk_onepass_kernel", "topk_radix_kernel", "topk_collect_kernel",
           "topk_tile_kernel", "topk_merge_kernel")


def call_bytes(rows: int, cols: int, k: int) -> int:
    """Bytes one top-k call must move."""
    return rows * cols * 4 + rows * k * 8


def _shape(x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
    cols = int(x.shape[1] if col_index is None else col_index.shape[0])
    return int(x.shape[0]), cols, int(k)


def start(ctx):
    from dgraph_tpu_torch.ops import vector_topk

    ctx.store["vector_topk"] = Recorder(vector_topk, "topk", _shape)


def read(ctx):
    rec = ctx.store["vector_topk"]
    rec.undo()
    total = sum(call_bytes(*c) for c in rec.calls) / HBM_BYTES_PER_S
    rec.calls.clear()
    return share(ctx, total, KERNELS)
