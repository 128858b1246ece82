"""KV3: the squared euclidean distance of every row of a shard to a query.

Port of the per-shard distance of `dgraph_tpu/parallel/mesh.py`'s
`sharded_topk` (`d2 = ((V_tile - q) ** 2).sum(axis=1)`): for V (rows, d)
float32 and q (d,), d2[r] = sum_j (V[r, j] - q[j])^2, difference first,
then the square. The kernel is `csrc/sq_distance.cu`, written by hand
for Hopper: one pass over V, a warp a row, the query in shared memory;
its head says what bounds it. `sq_distance_plain` beside it is the same
function in plain PyTorch, taken for tensors on the CPU.

The kernel sums each row in its own order, not torch's, so the two
versions agree to a tolerance (`TOL`, relative), not bit for bit; NaN
and infinite inputs give NaN and +inf in both.
"""

from __future__ import annotations

import ctypes

import torch

# How far the kernel's distances may stand from the plain version's,
# relative: each is a sum of d non-negative float32 terms, so neither
# cancels, and each lies within n * 2^-24 of the exact sum, n its chain
# of roundings: the kernel's d / 32 + 5 (a lane's terms, then a
# butterfly), torch's at most d / 8 + log2(d) (its vector lanes, then a
# cascade). 1e-5 is ~170 of those, above both together for d up to 1,000
TOL = 1e-5

# kernel launches, for showing that a path went through the kernel; the
# plain version's calls on CPU tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built sq_distance library."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sq_distance_launch.restype = ctypes.c_int
    lib.sq_distance_launch.argtypes = [p, i64, p, i64, ctypes.c_int, p, p]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("sq_distance"))
    return _lib


def sq_distance_plain(V, q) -> torch.Tensor:
    """Plain PyTorch version: the reference's expression."""
    return ((V - q[None, :]) ** 2).sum(dim=1)


def _check(V, q):
    if V.dim() != 2 or V.dtype != torch.float32:
        raise ValueError(f"want V (rows, d) float32, got {V.dtype} {tuple(V.shape)}")
    if q.dim() != 1 or q.dtype != torch.float32 or q.shape[0] != V.shape[1]:
        raise ValueError(f"want q ({V.shape[1]},) float32, got {q.dtype} {tuple(q.shape)}")
    if q.device != V.device:
        raise ValueError(f"q is on {q.device}, V on {V.device}")


def sq_distance(V, q) -> torch.Tensor:
    """d2 (rows,) float32: sum_j (V[r, j] - q[j])^2 for V (rows, d) and q
    (d,) float32. V's rows may be strided (a view of a wider matrix) but
    each row's floats contiguous. On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version."""
    global LAUNCHES, PLAIN_CALLS
    _check(V, q)
    if V.device.type == "cpu":
        PLAIN_CALLS += 1
        return sq_distance_plain(V, q)
    if V.device.type != "cuda":
        raise ValueError(f"the squared distance runs on cuda or cpu, not {V.device}")
    rows, d = V.shape
    if d > 1 and V.stride(1) != 1:
        raise ValueError("each row of V must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    lib = _kernel()
    out = torch.empty((rows,), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sq_distance_launch(
            V.data_ptr(), V.stride(0), q.data_ptr(), rows, d, out.data_ptr(), stream
        )
    if err:
        raise RuntimeError(f"sq_distance launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
