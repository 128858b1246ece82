"""Frozen peaks of one NVIDIA H100 and the least time of each kernel.

The least time of a launch is the bytes it must move at the card's
memory rate: the one kernel a cell measures, setop_rows, is bound by its
bytes (see below). Each input byte is counted once and each output byte
once, whatever a kernel reads again. These functions are copies of the
bound arithmetic the port's kernels were checked with on the card since
they were written, and are not edited: a later change to a kernel is
measured against the same yardstick.

The peak is NVIDIA's data sheet for the SXM part at its 700 W limit;
a run prints the card's power limit beside its shares.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


# -- setop_rows (`ops/setop_rows.py`, CUDA C++ `csrc/setop_rows.cu`) ---------
#
# Bytes bound it: the compares, about log2 of the range an element, take
# less time at the float32 rate than an element's 4 bytes at the memory
# rate. Read once: A's valid words, the lengths or offsets, the range ids
# and range table, and the 32-byte sectors of B a membership needs (for
# each word of A, its equal element in its row's range or, where there is
# none, its neighbours there), or for a compaction the keep mask and the
# kept words; written once: the padded form's n * pa words and n counts,
# the ragged form's kept words and offsets.

U32 = 0xFFFFFFFF


def _u64(x):
    import torch

    return x.to(torch.int64) & U32


def _ragged_keys(A, offs, rid, B, ranges):
    """Keys (range id << 32) | uid of A's words (each keyed by its row's
    range) and of B's ranges in table order, and the index in B of each
    key of B."""
    import torch

    dev = A.device
    lens = (offs[1:] - offs[:-1]).to(torch.int64)
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens,
                                  output_size=A.numel())
    start, length = ranges[:, 0].to(torch.int64), ranges[:, 1].to(torch.int64)
    rr = torch.repeat_interleave(torch.arange(ranges.shape[0], device=dev), length)
    at = torch.arange(rr.numel(), device=dev) - (torch.cumsum(length, 0) - length)[rr] + start[rr]
    return (rid.to(torch.int64)[row] << 32) | _u64(A), (rr << 32) | _u64(B)[at], at


def _ragged_b_sectors(A, offs, rid, B, ranges):
    """(bytes of B's sectors a membership needs, words of A held in B)."""
    import torch

    a, b, at = _ragged_keys(A, offs, rid, B, ranges)
    n = b.numel()
    if not (n and a.numel()):
        return 0, 0
    p = torch.searchsorted(b, a)
    pc, pm = p.clamp(max=n - 1), (p - 1).clamp(min=0)
    eq = (p < n) & (b[pc] == a)
    nxt = (p < n) & ((b[pc] >> 32) == (a >> 32))
    prv = ~eq & (p > 0) & ((b[pm] >> 32) == (a >> 32))
    elems = torch.cat([at[pc[nxt]], at[pm[prv]]])
    return 32 * int(torch.unique(elems // 8).numel()), int(eq.sum())


def _padded_b_sectors(A, LA, B, LB):
    import torch

    n, pa = A.shape
    pb = B.shape[-1]
    if not (pb and n):
        return 0
    lb = LB.to(torch.int64).unsqueeze(1)
    cols = torch.arange(pb, device=B.device)
    key = torch.where(cols < LB.unsqueeze(1), _u64(B), 1 << 32)
    q = _u64(A)
    if key.shape[0] == 1:
        p = torch.searchsorted(key[0], q)
        at_p = key[0][p.clamp(max=pb - 1)]
    else:
        p = torch.searchsorted(key, q)
        at_p = torch.gather(key, 1, p.clamp(max=pb - 1))
    eq = (p < lb) & (at_p == q)
    valid = torch.arange(pa, device=A.device) < LA.to(torch.int64).unsqueeze(1)
    row0 = 0 if B.dim() == 1 else torch.arange(n, device=A.device).unsqueeze(1) * pb
    at = torch.where(valid & (eq | (p < lb)), row0 + p, -1)
    before = torch.where(valid & ~eq & (p > 0), row0 + p - 1, -1)
    elems = torch.cat([at[at >= 0], before[before >= 0]])
    return 32 * int(torch.unique(elems // 8).numel())


def setop_rows_bound_s(name: str, args) -> float:
    """Least time of one setop_rows call `name` (intersect_ragged,
    difference_ragged, intersect_batch, difference_batch, compact_batch)
    on its arguments."""
    A = args[0]
    if name.endswith("_ragged"):
        _, offs, rid, _, ranges = args
        sectors, held = _ragged_b_sectors(*args)
        kept = held if name.startswith("intersect") else A.numel() - held
        nbytes = (4 * A.numel() + 4 * offs.numel() + 4 * rid.numel() + 4 * ranges.numel()
                  + sectors + 4 * kept + 4 * offs.numel())
        return nbytes / HBM_BYTES_PER_S
    n, pa = A.shape
    nbytes = 4 * n * pa + 4 * n
    if name == "compact_batch":
        nbytes += n * pa + 4 * int(args[1].sum())
    else:
        A, LA, B, LB = args
        nbytes += (4 * int(LA.clamp(0, pa).sum()) + 4 * n + 4 * LB.numel()
                   + _padded_b_sectors(A, LA, B, LB))
    return nbytes / HBM_BYTES_PER_S
