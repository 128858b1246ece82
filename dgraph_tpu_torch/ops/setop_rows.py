"""Intersect and difference of sorted rows (K2 + K3), membership and
stable compaction fused.

Port of the XLA set-op programs of `dgraph_tpu/ops/setops.py` that the
dispatcher runs on every filtered read: `_searchsorted` and `membership`
(K2), `compact` and its fusions `intersect` and `difference` (K3),
vmapped over buckets of row pairs or against one shared b. The kernel is
`csrc/setop_rows.cu`, written by hand for Hopper; its head says what
bounds it and how it is laid out. `compact_batch` runs its compaction
alone, after the member sweep (K1). The plain versions are the port's
`setops.intersect`, `setops.difference` and `setops.compact`, which CPU
tensors take.

Uids travel as their u32 bits in int32, as in the member sweep: A (n, pa)
against B (n, pb) with LB (n,), or against one B (pb,) that every row
shares, with LB (1,); LA (n,) int32. Rows are sorted ascending as uint32
within their lengths (the reference's precondition). A call returns
(out, cnt): out (n, pa) int32 holds each row's kept elements first, in
order, and UINT32_MAX after them; cnt (n,) int32 counts them. Validity is
judged by index against the lengths, never by value, so UINT32_MAX stays
a legal uid.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops import setops

OPS = {"intersect": 0, "difference": 1}
CHUNK = 128  # elements a warp of the kernel takes; longer rows take 3 passes
MAX_P = (1 << 31) - 1  # positions in a row are int32 in the kernel

# launches of the kernel (either entry point), for showing that a path
# went through it; the plain versions' calls on CPU tensors are counted
# apart
LAUNCHES = 0
PLAIN_CALLS = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built setop_rows library."""
    lib.setop_rows_launch.restype = ctypes.c_int
    lib.setop_rows_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.compact_rows_launch.restype = ctypes.c_int
    lib.compact_rows_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.setop_rows_scratch.restype = ctypes.c_int64
    lib.setop_rows_scratch.argtypes = [ctypes.c_int] * 2
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("setop_rows"))
    return _lib


def kernel_names(pa: int) -> dict:
    """The kernels one call over rows of width `pa` launches, by name."""
    if pa <= CHUNK:
        return {"setop_rows_fused": 1}
    return {"setop_rows_flags": 1, "setop_rows_scan": 1, "setop_rows_scatter": 1}


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> the same uids as int32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 uid bits -> int64 u32 values (setops' representation)."""
    return x.to(torch.int64) & setops.UINT32_MAX


def _check(A, LA, B, LB):
    shared = B.dim() == 1
    if A.dim() != 2 or not (shared or (B.dim() == 2 and A.shape[0] == B.shape[0])):
        raise ValueError(
            f"want A (n, pa) and B (n, pb) or (pb,), got {A.shape}, {B.shape}"
        )
    n = A.shape[0]
    if max(A.shape[1], B.shape[-1]) > MAX_P:
        raise ValueError(f"rows longer than {MAX_P}")
    for name, t, shape in (("LA", LA, (n,)), ("LB", LB, (1,) if shared else (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("A", A), ("LA", LA), ("B", B), ("LB", LB)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")


def setop_batch_plain(op: str, A, LA, B, LB):
    """Plain PyTorch version: setops.intersect / setops.difference over
    the same rows (a shared 1-D B broadcasts, as in the reference's
    vmap), in setops' int64 representation."""
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


def _outputs(A):
    n, pa = A.shape
    out = torch.empty((n, pa), dtype=torch.int32, device=A.device)
    cnt = torch.empty((n,), dtype=torch.int32, device=A.device)
    return out, cnt


def _on_card(*named):
    if named[0][1].device.type != "cuda":
        raise ValueError(f"setop_rows runs on cuda or cpu, not {named[0][1].device}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _setop(op: str, A, LA, B, LB):
    global LAUNCHES, PLAIN_CALLS
    _check(A, LA, B, LB)
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return setop_batch_plain(op, A, LA, B, LB)
    _on_card(("A", A), ("LA", LA), ("B", B), ("LB", LB))
    n, pa = A.shape
    pb = B.shape[-1]
    shared = B.dim() == 1
    out, cnt = _outputs(A)
    if n == 0 or pa == 0:
        return out, cnt.zero_()
    lib = _kernel()
    scratch = torch.empty((lib.setop_rows_scratch(n, pa),), dtype=torch.int32,
                          device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.setop_rows_launch(
            A.data_ptr(), LA.data_ptr(), B.data_ptr(), LB.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), scratch.data_ptr(), n, pa, pb, 0 if shared else pb,
            0 if shared else 1, OPS[op], stream,
        )
    if err:
        raise RuntimeError(f"setop_rows launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, cnt


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
    global LAUNCHES, PLAIN_CALLS
    if A.dim() != 2 or tuple(keep.shape) != tuple(A.shape):
        raise ValueError(f"want A and keep of one shape (n, pa), got {A.shape}, {keep.shape}")
    if A.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError(f"want int32 A and bool keep, got {A.dtype}, {keep.dtype}")
    if keep.device != A.device:
        raise ValueError(f"keep is on {keep.device}, A on {A.device}")
    if A.shape[1] > MAX_P:
        raise ValueError(f"rows longer than {MAX_P}")
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return compact_batch_plain(A, keep)
    _on_card(("A", A), ("keep", keep))
    n, pa = A.shape
    out, cnt = _outputs(A)
    if n == 0 or pa == 0:
        return out, cnt.zero_()
    lib = _kernel()
    scratch = torch.empty((lib.setop_rows_scratch(n, pa),), dtype=torch.int32,
                          device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compact_rows_launch(
            A.data_ptr(), keep.view(torch.uint8).data_ptr(), out.data_ptr(),
            cnt.data_ptr(), scratch.data_ptr(), n, pa, stream,
        )
    if err:
        raise RuntimeError(f"compact_rows launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, cnt
