"""KV4: one shard's Lloyd step after its GEMM — assignment, sums, counts.

Port of the per-shard step of `dgraph_tpu/parallel/mesh.py`'s
`sharded_kmeans_step` (`:203-210`): from the dots X @ C^T of a shard's
rows X (n, d) with the centroids C (c, d), each row's nearest centroid
(`argmin` of `(xsq - 2 dot) + csq`), and for each centroid the sum of
its rows weighted by w (the reference's `valid.astype(float32)`) and the
sum of their weights. The GEMM stays `vector_topk.f32_matmul` (full
float32, as the reference left it to XLA); the psum over shards and the
update stay in `parallel/mesh.py`. The kernel is `csrc/kmeans_step.cu`,
written by hand for Hopper; its head says what bounds it and how it
sums without float atomics. `kmeans_step_plain` beside it is the same
function in plain PyTorch, the reference's expressions (`index_add_` for
`segment_sum`), taken for tensors on the CPU.

The kernel adds each centroid's rows in row order, so two launches give
equal bits, and equal the host's sums wherever the assignments agree.
The plain version on a card adds with atomics in no fixed order, and its
row norms are torch's sums, not the kernel's: assignments agree outside
near-ties, and sums to `sums_tolerance`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dgraph_tpu_torch.ops import vector_topk

# kernel launches (one a call, whatever the kernels inside), for showing
# that a path went through the kernel; the plain version's calls on CPU
# tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0

# the kernels one launch runs, in order; the assignment and the scatter
# only when the shard has rows
KERNELS = ("kmeans_prep_kernel", "kmeans_assign_kernel", "kmeans_scan_blocks_kernel",
           "kmeans_scan_clusters_kernel", "kmeans_scatter_kernel", "kmeans_sums_kernel")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kmeans_step library."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kmeans_step_launch.restype = i
    lib.kmeans_step_launch.argtypes = [p, i64, p, p, i64, p, i64, i64, i, i, p, p, p, p, p]
    lib.kmeans_step_scratch_words.restype = i64
    lib.kmeans_step_scratch_words.argtypes = [i64, i64]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("kmeans_step"))
    return _lib


def launch_counts(n: int) -> dict:
    """{kernel name: launches} of one call on a shard of n rows."""
    skip = () if n else ("kmeans_assign_kernel", "kmeans_scatter_kernel")
    return {k: 1 for k in KERNELS if k not in skip}


def kmeans_step_plain(X, w, C, dot=None):
    """Plain PyTorch version: the reference's per-shard expressions.
    Returns (sums (c, d), cnts (c,), assign (n,) int32)."""
    dot = vector_topk.f32_matmul(X, C.T) if dot is None else dot
    xsq = (X * X).sum(dim=1)
    csq = (C * C).sum(dim=1)
    d2 = xsq[:, None] - 2.0 * dot + csq[None, :]
    assign = torch.argmin(d2, dim=1)
    sums = X.new_zeros((C.shape[0], X.shape[1])).index_add_(0, assign, X * w[:, None])
    cnts = X.new_zeros((C.shape[0],)).index_add_(0, assign, w)
    return sums, cnts, assign.to(torch.int32)


def sums_tolerance(X, w, assign, c: int) -> torch.Tensor:
    """(c, d) bound on |kernel sums - plain sums|. Both add the same
    products x w of a cluster's m rows, in two orders; each order's sum
    lies within (m - 1) 2^-24 sum|x w| of the exact one, so the two lie
    within 2 m 2^-24 sum|x w| of each other (m + 1 for the rounding of
    the bound's own sum)."""
    a = assign.long()
    absum = X.new_zeros((c, X.shape[1])).index_add_(0, a, (X * w[:, None]).abs())
    m = torch.bincount(a, minlength=c).to(X.dtype)
    return 2.0 * (m + 1.0)[:, None] * 2.0 ** -24 * absum


def _check(X, w, C, dot):
    if X.dim() != 2 or X.dtype != torch.float32:
        raise ValueError(f"want X (n, d) float32, got {X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    if C.dim() != 2 or C.dtype != torch.float32 or C.shape[1] != d or C.shape[0] < 1:
        raise ValueError(f"want C (c >= 1, {d}) float32, got {C.dtype} {tuple(C.shape)}")
    if w.dim() != 1 or w.dtype != torch.float32 or w.shape[0] != n:
        raise ValueError(f"want w ({n},) float32, got {w.dtype} {tuple(w.shape)}")
    if dot is not None and (dot.dtype != torch.float32 or tuple(dot.shape) != (n, C.shape[0])):
        raise ValueError(f"want dot ({n}, {C.shape[0]}) float32, got {dot.dtype} "
                         f"{tuple(dot.shape)}")
    for name, t in (("w", w), ("C", C), ("dot", dot)):
        if t is not None and t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")


@functools.lru_cache(maxsize=1024)
def _scratch_words(n: int, c: int) -> int:
    return int(_kernel().kmeans_step_scratch_words(n, c))


def kmeans_step(X, w, C, dot=None):
    """(sums (c, d) f32, cnts (c,) f32, assign (n,) int32) of one shard:
    X (n, d) f32, w (n,) f32 row weights, C (c, d) f32 centroids, dot
    (n, c) f32 the GEMM X @ C^T (computed here, in full float32, when not
    given). Each row of X and of dot contiguous, C contiguous. On a CUDA
    tensor this launches the kernel; on a CPU tensor it runs the plain
    version."""
    global LAUNCHES, PLAIN_CALLS
    _check(X, w, C, dot)
    if X.device.type == "cpu":
        PLAIN_CALLS += 1
        return kmeans_step_plain(X, w, C, dot)
    if X.device.type != "cuda":
        raise ValueError(f"the k-means step runs on cuda or cpu, not {X.device}")
    n, d = X.shape
    c = C.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 rows a shard, got {n}")
    dot = vector_topk.f32_matmul(X, C.T) if dot is None else dot
    if (n and ((d > 1 and X.stride(1) != 1) or (c > 1 and dot.stride(1) != 1))) \
            or not (w.is_contiguous() and C.is_contiguous()):
        raise ValueError("the k-means step wants rows of X and dot contiguous, w and C "
                         "contiguous")
    lib = _kernel()
    sums = torch.empty((c, d), dtype=torch.float32, device=X.device)
    cnts = torch.empty((c,), dtype=torch.float32, device=X.device)
    assign = torch.empty((n,), dtype=torch.int32, device=X.device)
    scratch = torch.empty((max(_scratch_words(n, c), 1),), dtype=torch.int32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmeans_step_launch(
            X.data_ptr(), X.stride(0), w.data_ptr(), C.data_ptr(), C.stride(0),
            dot.data_ptr(), dot.stride(0), n, c, d, sums.data_ptr(), cnts.data_ptr(),
            assign.data_ptr(), scratch.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"kmeans_step launch failed: cudaError {err}")
    LAUNCHES += 1
    return sums, cnts, assign
