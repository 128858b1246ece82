"""Member sweep (K1): batched membership of <=128 queries per sorted row.

Port of `dgraph_tpu/ops/pallas_setops.py`, whose Pallas kernel
(`_member_kernel`) compared every query with every element of B. The
kernel here is `csrc/member_sweep.cu`, written by hand for Hopper: one
warp per row, which either binary-searches each query in B (few queries
against a long row, where the chain of dependent loads bounds it) or
stages B's short valid window in shared memory once and searches the
queries there (where B's bytes bound it). A row is searched from
LB >= max(64 LA, 768) on, where the H100 measured the crossover (the
reference's search-against-merge rule is LA * 32 <= LB); the rule lives
in the kernel's source alone, and `search_from` asks it. The source
head says what bounds each regime and how.
`membership_batch_plain` beside it is the same function in plain
PyTorch, by compare-all, taken for tensors on the CPU.

B is one row per row of A, or one row shared by all of them (the
reference's `vmap(in_axes=(0, 0, None, None))` form): the kernel reads
row i of B at `i * b_stride`, with stride 0 for a shared b, which is
uploaded once however many rows search it.

The rows must be sorted ascending as uint32 within LA / LB (the
reference's precondition). The kernel takes the uid bits as int32: a
uint32 numpy row viewed as int32 (`np.ndarray.view(np.int32)`), and
compares them unsigned. Validity is judged by index against the lengths,
never by value, so 0xFFFFFFFF stays a legal uid and padding never makes
a hit.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops import setop_rows

LANE = 128  # queries per row: four per lane of the row's warp
MAX_PB = (1 << 31) - 1  # positions in a row are int32 in the kernel
# plain version: elements of B compared per chunk, bounding the
# (n, pa, chunk) broadcast to about 2^26 booleans
_PLAIN_ELEMS = 1 << 26

# kernel launches, for showing that a path went through the kernel; the
# plain version's calls on CPU tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built member_sweep library."""
    lib.member_sweep_launch.restype = ctypes.c_int
    lib.member_sweep_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int
    ] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.member_sweep_search_from.restype = ctypes.c_int64
    lib.member_sweep_search_from.argtypes = [ctypes.c_int]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("member_sweep"))
    return _lib


def search_from(la: int) -> int:
    """The least LB at which the kernel searches a row of `la` valid
    queries; shorter rows are streamed. Builds the kernel if needed."""
    return int(_kernel().member_sweep_search_from(int(la)))


def _check(A, LA, B, LB):
    """A (n, pa) against B (n, pb) with LB (n,), or against one shared
    B (pb,) with LB (1,)."""
    shared = B.dim() == 1
    if A.dim() != 2 or not (shared or (B.dim() == 2 and A.shape[0] == B.shape[0])):
        raise ValueError(
            f"want A (n, pa) and B (n, pb) or (pb,), got {A.shape}, {B.shape}"
        )
    n, pa = A.shape
    if pa > LANE:
        raise ValueError(f"member sweep is for <=128 queries per row, got {pa}")
    if B.shape[-1] > MAX_PB:
        raise ValueError(f"rows of B longer than {MAX_PB}")
    for name, t, shape in (("LA", LA, (n,)), ("LB", LB, (1,) if shared else (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("A", A), ("LA", LA), ("B", B), ("LB", LB)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")


def membership_batch_plain(A, LA, B, LB) -> torch.Tensor:
    """Plain PyTorch version: a chunked compare-all broadcast over B.
    A (n, pa), B (n, pb) int32; LA, LB (n,); or one shared B (pb,) with
    LB (1,). Returns (n, pa) bool."""
    n, pa = A.shape
    if B.dim() == 1:
        B, LB = B.expand(n, B.shape[0]), LB.expand(n)
    pb = B.shape[1]
    hit = torch.zeros((n, pa), dtype=torch.bool, device=A.device)
    lb = LB.to(torch.int64).unsqueeze(1)
    chunk = max(1, _PLAIN_ELEMS // max(1, n * pa))
    for s in range(0, pb, chunk):
        bc = B[:, s : s + chunk]
        valid = torch.arange(s, s + bc.shape[1], device=A.device) < lb
        eq = (A.unsqueeze(2) == bc.unsqueeze(1)) & valid.unsqueeze(1)
        hit |= eq.any(2)
    la = LA.to(torch.int64).unsqueeze(1)
    return hit & (torch.arange(pa, device=A.device) < la)


def membership_batch(A, LA, B, LB) -> torch.Tensor:
    """hit[i, j] = j < LA[i] and A[i, j] in B[i, :LB[i]].

    A (n, pa <= 128) and B (n, pb) int32 uid bits, rows sorted as uint32
    within LA / LB, which are (n,) int32; or one B (pb,) that every row
    searches, with LB (1,). On a CUDA tensor this launches the kernel; on
    a CPU tensor it runs the plain version. Returns (n, pa) bool."""
    global LAUNCHES, PLAIN_CALLS
    _check(A, LA, B, LB)
    if A.device.type == "cpu":
        PLAIN_CALLS += 1
        return membership_batch_plain(A, LA, B, LB)
    if A.device.type != "cuda":
        raise ValueError(f"member sweep runs on cuda or cpu, not {A.device}")
    for name, t in (("A", A), ("LA", LA), ("B", B), ("LB", LB)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _kernel()
    n, pa = A.shape
    pb = B.shape[-1]
    shared = B.dim() == 1
    # every byte is written by the row's warp
    hits = torch.empty((n, pa), dtype=torch.uint8, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.member_sweep_launch(
            A.data_ptr(), LA.data_ptr(), B.data_ptr(), LB.data_ptr(),
            hits.data_ptr(), n, pa, pb, 0 if shared else pb, 0 if shared else 1,
            stream,
        )
    if err:
        raise RuntimeError(f"member_sweep launch failed: cudaError {err}")
    LAUNCHES += 1
    return hits.view(torch.bool)


def intersect_batch(A, LA, B, LB):
    """Batched intersect with the (out, cnt) contract of the batched
    setops.intersect, in uid bits: out (n, pa) int32 holds the kept uids
    of A, UINT32_MAX padded, cnt (n,) int32 their count per row. The
    compaction after the sweep is setop_rows' (its kernel on a card)."""
    return setop_rows.compact_batch(A, membership_batch(A, LA, B, LB))


def membership(a, la, b, lb) -> torch.Tensor:
    """Single-row membership (<=128 queries): a shim over the batch."""
    L = lambda x: torch.tensor([int(x)], dtype=torch.int32, device=a.device)
    return membership_batch(a[None, :], L(la), b[None, :], L(lb))[0]


def intersect(a, la, b, lb):
    """Single-row intersect for small a: membership, then compaction."""
    out, cnt = setop_rows.compact_batch(a[None, :], membership(a, la, b, lb)[None, :])
    return out[0], cnt[0]
