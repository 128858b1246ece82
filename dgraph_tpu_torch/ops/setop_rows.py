"""Intersect and difference of sorted rows (K2 + K3), membership and
stable compaction fused.

Port of the XLA set-op programs of `dgraph_tpu/ops/setops.py` that the
dispatcher runs on every filtered read: `_searchsorted` and `membership`
(K2), `compact` and its fusions `intersect` and `difference` (K3),
vmapped over buckets of row pairs or against one shared b. The kernel is
`csrc/setop_rows.cu`, written by hand for Hopper: one single-pass launch
for every row length; its head says what bounds it and how it is laid
out. Uids travel as their u32 bits in int32, compared unsigned. Rows are
sorted ascending as uint32 within their lengths (the reference's
precondition). Validity is judged by index against the lengths, never by
value, so UINT32_MAX stays a legal uid.

Two forms over the same kernel:

- Ragged (`intersect_ragged`, `difference_ragged`): A (N,) holds m rows
  back to back, row i at A[offs[i]:offs[i + 1]] (offs (m + 1,), offs[0] =
  0, offs[m] = N); row i is searched in range rid[i] of the table ranges
  (r, 2) of (start, length) pairs over one B (nB,). In the shared-b shape
  a range is one hi-32 segment of b, in the paired shape one pair's b.
  A call returns (out, head): head (m + 2,) int32 holds out_off (m + 1)
  and, last, the tiles that searched B in global memory; row i's kept
  words are out[out_off[i]:out_off[i + 1]] (out has N words; those past
  out_off[m] are not written).
- Padded (`intersect_batch`, `difference_batch`, `compact_batch`): A (n,
  pa) with LA (n,) against B (n, pb) with LB (n,), or against one B (pb,)
  that every row shares, with LB (1,). A call returns (out, cnt): out (n,
  pa) int32 holds each row's kept elements first, in order, and
  UINT32_MAX after them; cnt (n,) int32 counts them. `compact_batch`
  runs the compaction alone, after the member sweep (K1).

The plain versions beside them (`setop_ragged_plain`, the port's
`setops.intersect`, `difference` and `compact`) are what CPU tensors
take; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops import setops

OPS = {"intersect": 0, "difference": 1}
_COMPACT = 2
KERNEL = "setop_rows_single_pass"  # the one kernel a call launches
TILE = 2048  # positions a tile of the kernel takes (checked against the build)
MAX_P = (1 << 31) - 1  # positions are int32 in the kernel

# launches of the kernel (any entry point), for showing that a path went
# through it; the plain versions' calls on CPU tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0
# tiles that searched B in global memory, as read back by the callers of
# the ragged form (query/dispatch.py): a diagnostic of the kernel's path
GLOBAL_TILES = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built setop_rows library."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.setop_rows_launch.restype = i32
    lib.setop_rows_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i64, ptr, i32, ptr, i64, ptr, i32, i32,
        i32, i32, i32, i32, ptr, i32, ptr,
    ]
    lib.setop_rows_tile.restype = i32
    lib.setop_rows_tile.argtypes = []
    if lib.setop_rows_tile() != TILE:
        raise RuntimeError(f"setop_rows tile {lib.setop_rows_tile()} != {TILE}")
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("setop_rows"))
    return _lib


def kernel_names() -> dict:
    """The kernels one call launches, by name."""
    return {KERNEL: 1}


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> the same uids as int32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 uid bits -> int64 u32 values (setops' representation)."""
    return x.to(torch.int64) & setops.UINT32_MAX


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def setop_ragged_plain(op: str, A, offs, rid, B, ranges):
    """Plain PyTorch version of the ragged form: one torch.searchsorted of
    keys (range id << 32) | uid of A among those of B's ranges, then
    masked_select and a count a row. Returns (out, head) as the kernel,
    with out holding the kept words alone and head[m + 1] = 0."""
    m = offs.numel() - 1
    dev = A.device
    lens = offs[1:].to(torch.int64) - offs[:-1].to(torch.int64)
    row = torch.repeat_interleave(torch.arange(m, device=dev), lens, output_size=A.numel())
    nb = B.numel()
    start = ranges[:, 0].to(torch.int64).clamp(0, nb)
    length = torch.minimum(ranges[:, 1].to(torch.int64).clamp(min=0), nb - start)
    rr = torch.repeat_interleave(torch.arange(ranges.shape[0], device=dev), length)
    at = torch.arange(rr.numel(), device=dev) - (torch.cumsum(length, 0) - length)[rr] + start[rr]
    keys_b = (rr << 32) | to_u32(B)[at]
    keys_a = (rid.to(torch.int64)[row] << 32) | to_u32(A)
    if keys_b.numel():
        p = torch.searchsorted(keys_b, keys_a).clamp(max=keys_b.numel() - 1)
        hit = keys_b[p] == keys_a
    else:
        hit = torch.zeros(keys_a.shape, dtype=torch.bool, device=dev)
    keep = hit if op == "intersect" else ~hit
    counts = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(0, row, keep.to(torch.int64))
    head = torch.zeros(m + 2, dtype=torch.int32, device=dev)
    head[1 : m + 1] = torch.cumsum(counts, 0).to(torch.int32)
    return torch.masked_select(A, keep), head


def setop_batch_plain(op: str, A, LA, B, LB):
    """Plain PyTorch version of the padded form: setops.intersect /
    setops.difference over the same rows (a shared 1-D B broadcasts, as
    in the reference's vmap), in setops' int64 representation."""
    n, pa = A.shape
    pb = B.shape[-1]
    la = LA.to(torch.int64).clamp(0, pa)
    lb = LB.to(torch.int64).clamp(0, pb)
    if B.dim() == 1:
        lb = lb[0]
    b = to_u32(B)
    # setops search b over its whole width: past lb it must stay sorted
    past = torch.arange(pb, device=B.device) >= (lb.unsqueeze(-1) if lb.dim() else lb)
    b = torch.where(past, setops.UINT32_MAX, b)
    if pb == 0:
        b = torch.full(B.shape[:-1] + (1,), setops.UINT32_MAX, dtype=torch.int64,
                       device=B.device)
    fn = setops.intersect if op == "intersect" else setops.difference
    out, cnt = fn(to_u32(A), la, b, lb)
    return to_bits(out), cnt.to(torch.int32)


def compact_batch_plain(A, keep):
    """Plain PyTorch version of the compaction: setops.compact."""
    out, cnt = setops.compact(to_u32(A), keep)
    return to_bits(out), cnt.to(torch.int32)


# ---------------------------------------------------------------------------
# Checks and the launch
# ---------------------------------------------------------------------------


def _same_device(A, named):
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")


def _check(A, LA, B, LB):
    shared = B.dim() == 1
    if A.dim() != 2 or not (shared or (B.dim() == 2 and A.shape[0] == B.shape[0])):
        raise ValueError(
            f"want A (n, pa) and B (n, pb) or (pb,), got {A.shape}, {B.shape}"
        )
    n = A.shape[0]
    if max(A.numel(), B.shape[-1]) > MAX_P:
        raise ValueError(f"more than {MAX_P} positions")
    for name, t, shape in (("LA", LA, (n,)), ("LB", LB, (1,) if shared else (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    _same_device(A, (("A", A), ("LA", LA), ("B", B), ("LB", LB)))


def _check_ragged(A, offs, rid, B, ranges):
    if A.dim() != 1 or offs.dim() != 1 or B.dim() != 1 or offs.numel() < 1:
        raise ValueError(f"want A (N,), offs (m + 1,) and B (nB,), got {A.shape}, "
                         f"{offs.shape}, {B.shape}")
    m = offs.numel() - 1
    if tuple(rid.shape) != (m,):
        raise ValueError(f"rid must have shape ({m},), got {tuple(rid.shape)}")
    if ranges.dim() != 2 or ranges.shape[1] != 2 or (m and not ranges.shape[0]):
        raise ValueError(f"ranges must be (r >= 1, 2), got {tuple(ranges.shape)}")
    if max(A.numel(), B.numel(), m) > MAX_P:
        raise ValueError(f"more than {MAX_P} positions")
    _same_device(A, (("A", A), ("offs", offs), ("rid", rid), ("B", B), ("ranges", ranges)))


def _on_card(*named):
    if named[0][1].device.type != "cuda":
        raise ValueError(f"setop_rows runs on cuda or cpu, not {named[0][1].device}")
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(A, P, m, op, *, offs=None, LA=None, keep=None, B=None, rid=None, rid_step=0,
            ranges=None, b_stride=0, LB=None, bcap=MAX_P):
    """One launch over P positions of m rows; returns the call's buffer
    split as (head, cnt, out): head = out_off (m + 1) and the two
    counters, cnt (m, padded only) and out (P). Everything a call needs
    is in the one buffer, allocated here and zeroed by the launch on
    A's stream, so concurrent calls share nothing."""
    global LAUNCHES
    tiles = -(-P // TILE)
    padded = offs is None
    words = 2 * tiles + m + 3 + (m if padded else 0) + P
    buf = torch.empty((words,), dtype=torch.int32, device=A.device)
    if ranges is not None:
        rstart, rlen, rstep = ranges.data_ptr(), ranges.data_ptr() + 4, 2
    else:
        rstart, rlen, rstep = None, _ptr(LB), 1
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _kernel().setop_rows_launch(
        A.data_ptr(), _ptr(offs), _ptr(LA), _ptr(keep), _ptr(B), 0 if B is None else B.numel(),
        _ptr(rid), rid_step, rstart, b_stride, rlen, rstep, bcap, m,
        0 if not padded else P // m, P, op, buf.data_ptr(), A.device.index, stream,
    )
    if err:
        raise RuntimeError(f"setop_rows launch failed: cudaError {err}")
    LAUNCHES += 1
    at = 2 * tiles
    head = buf[at : at + m + 2]
    at += m + 3
    cnt = buf[at : at + m] if padded else None
    return head, cnt, buf[at + (m if padded else 0) :]


def _ragged(op: str, A, offs, rid, B, ranges):
    global PLAIN_CALLS
    _check_ragged(A, offs, rid, B, ranges)
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return setop_ragged_plain(op, A, offs, rid, B, ranges)
    _on_card(("A", A), ("offs", offs), ("rid", rid), ("B", B), ("ranges", ranges))
    m = offs.numel() - 1
    if not A.numel() or not m:  # no position: every row keeps nothing
        return A.new_empty((0,)), torch.zeros((m + 2,), dtype=torch.int32, device=A.device)
    head, _, out = _launch(A, A.numel(), m, OPS[op], offs=offs, B=B, rid=rid, ranges=ranges)
    return out, head


def intersect_ragged(A, offs, rid, B, ranges):
    """Row i of the result: the words of A[offs[i]:offs[i + 1]] that range
    rid[i] of B holds; (out, head) as in the module doc."""
    return _ragged("intersect", A, offs, rid, B, ranges)


def difference_ragged(A, offs, rid, B, ranges):
    """Row i of the result: the words of A[offs[i]:offs[i + 1]] that range
    rid[i] of B lacks; (out, head) as in the module doc."""
    return _ragged("difference", A, offs, rid, B, ranges)


def _padded_empty(A):
    n, pa = A.shape
    return (torch.full((n, pa), -1, dtype=torch.int32, device=A.device),
            torch.zeros((n,), dtype=torch.int32, device=A.device))


def _setop(op: str, A, LA, B, LB):
    global PLAIN_CALLS
    _check(A, LA, B, LB)
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return setop_batch_plain(op, A, LA, B, LB)
    _on_card(("A", A), ("LA", LA), ("B", B), ("LB", LB))
    n, pa = A.shape
    if not A.numel():
        return _padded_empty(A)
    pb = B.shape[-1]
    shared = B.dim() == 1
    _, cnt, out = _launch(A, n * pa, n, OPS[op], LA=LA, B=B, rid_step=0 if shared else 1,
                          b_stride=0 if shared else pb, LB=LB, bcap=pb)
    return out.view(n, pa), cnt


def intersect_batch(A, LA, B, LB):
    """Row i of the result: the elements of A[i, :LA[i]] that B[i, :LB[i]]
    (or the shared B[:LB[0]]) holds, compacted; see the module doc."""
    return _setop("intersect", A, LA, B, LB)


def difference_batch(A, LA, B, LB):
    """Row i of the result: the elements of A[i, :LA[i]] that B[i, :LB[i]]
    (or the shared B[:LB[0]]) lacks, compacted; see the module doc."""
    return _setop("difference", A, LA, B, LB)


def compact_batch(A, keep):
    """The stable compaction of each row of A (n, pa) int32 bits where
    keep (n, pa) bool is set: (out, cnt) as above."""
    global PLAIN_CALLS
    if A.dim() != 2 or tuple(keep.shape) != tuple(A.shape):
        raise ValueError(f"want A and keep of one shape (n, pa), got {A.shape}, {keep.shape}")
    if A.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError(f"want int32 A and bool keep, got {A.dtype}, {keep.dtype}")
    if keep.device != A.device:
        raise ValueError(f"keep is on {keep.device}, A on {A.device}")
    if A.numel() > MAX_P:
        raise ValueError(f"more than {MAX_P} positions")
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return compact_batch_plain(A, keep)
    _on_card(("A", A), ("keep", keep))
    n, pa = A.shape
    if not A.numel():
        return _padded_empty(A)
    _, cnt, out = _launch(A, n * pa, n, _COMPACT, keep=keep.view(torch.uint8))
    return out.view(n, pa), cnt
