"""KV2's share of its roofline (`ops/ivf_scan.py`, CUDA C++
`csrc/ivf_slab_scan.cu`, kernel `slab_scan_kernel`), in %: the least
time of every call in the window over the kernel's traced device time.

A call's least time is its bytes at the H100's 3.35 TB/s: for each
query, its probed slabs' 128 rows each of d float32 values, their
squared norm and their row id (4 bytes each), read once, and its
distances written (4 bytes a row). The shapes of each call are noted
by a wrapper on the function the program calls and counted after the
window."""

from portbench.metrics._launches import Recorder, share

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SLAB = 128
KERNELS = ("slab_scan_kernel",)


def call_bytes(nq: int, m_slabs: int, d: int) -> int:
    """Bytes one slab-scan call must move: nq queries of m_slabs slabs."""
    rows = nq * m_slabs * SLAB
    return rows * (4 * d + 4 + 4) + rows * 4


def _shape(flat_vecs, flat_sq, flat_rows, sidx, *rest, **kw):
    return int(sidx.shape[0]), int(sidx.shape[1]), int(flat_vecs.shape[-1])


def start(ctx):
    from dgraph_tpu_torch.ops import ivf_scan

    ctx.store["ivf_scan"] = Recorder(ivf_scan, "slab_distances", _shape)


def read(ctx):
    rec = ctx.store["ivf_scan"]
    rec.undo()
    total = sum(call_bytes(*c) for c in rec.calls) / HBM_BYTES_PER_S
    rec.calls.clear()
    return share(ctx, total, KERNELS)
