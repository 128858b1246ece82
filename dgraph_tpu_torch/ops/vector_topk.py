"""KV1: the vector distance epilogue, the mask and a per-row top-k.

Port of the device program the reference builds in
`dgraph_tpu/models/vector.py` (`_jit_brute`, `_jit_brute_batch`, the
`lax.top_k` steps of `_ivf_probe`): from the rows of a dot product (or
of ready distances) to the k smallest distances of each row, ascending,
with their columns. The kernel is `csrc/vector_topk.cu`, written by hand
for Hopper; its head says what bounds it and how its two regimes (one
pass over the row with a running threshold for small k, a radix select
spread over the row's CTAs then a sort of the k keys for the others;
`onepass(rows, n, k)` says which a call takes) deal with that. `topk_plain` beside it is the same function in
plain PyTorch, taken for tensors on the CPU.

Order is `lax.top_k(-d, k)`'s: the IEEE total order on d (-0.0 before
0.0, NaN after +inf), ties to the lower column. `torch.topk` leaves the
order of ties unspecified, so both versions select on the unique 64-bit
key (orderable(d) << 32) | column.

Metrics (`METRIC_ID`): "euclidean" d = (sqnorm - 2 dot) + |q|^2,
"cosine" d = 1 - dot / max(sqrt(sqnorm) |q|, 1e-12), "dotproduct"
d = -dot, and "distance" (d = x, for rows that are distances already).
`query_stat` gives the per-row |q|^2 or |q| the epilogue takes.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

METRIC_ID = {"euclidean": 0, "cosine": 1, "dotproduct": 2, "distance": 3}
# columns per row the kernel takes (a column index fits 30 bits of its
# keys); the .cu refuses more as well
MAX_N = 1 << 30
# the fewest query rows the GEMM in front of the kernel runs at
# (`pad_rows`): every batch the micro-batcher coalesces (at most 4
# queries) and its members' solo searches score each row alike
MIN_ROWS = 8

# kernel launches, for showing that a path went through the kernel; the
# plain version's calls on CPU tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0

_lib = None
# the kernel's persistent state per (device, stream): tickets, histograms
# and counters that every launch leaves at zero, so they are zeroed once,
# when allocated (and dropped after a failed launch)
_STATE = {}
_STATE_LOCK = threading.Lock()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built vector_topk library."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.vector_topk_launch.restype = i
    lib.vector_topk_launch.argtypes = [p, i64] + [p] * 4 + [i] * 4 + [p] * 5
    lib.vector_topk_onepass_max_k.restype = i
    lib.vector_topk_onepass_max_k.argtypes = []
    lib.vector_topk_scratch_keys.restype = i64
    lib.vector_topk_scratch_keys.argtypes = [i, i, i]
    lib.vector_topk_state_words.restype = i64
    lib.vector_topk_state_words.argtypes = [i, i, i]
    lib.vector_topk_onepass.restype = i
    lib.vector_topk_onepass.argtypes = [i, i, i]
    lib.vector_topk_max_n.restype = i
    lib.vector_topk_max_n.argtypes = []
    lib.vector_topk_launch_counts.restype = i
    lib.vector_topk_launch_counts.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.vector_topk_kernel_name.restype = ctypes.c_char_p
    lib.vector_topk_kernel_name.argtypes = [i]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("vector_topk"))
    return _lib


@functools.lru_cache(maxsize=None)
def onepass_max_k() -> int:
    """The largest k the kernel ever takes in one pass over the row; a
    larger k goes by radix select and a sort of the k keys. Builds the
    kernel if needed."""
    return int(_kernel().vector_topk_onepass_max_k())


def onepass(rows: int, n: int, k: int) -> bool:
    """Whether a call on rows x n with this k takes the one-pass regime:
    the switch of the .cu, asked of the library."""
    return bool(_kernel().vector_topk_onepass(rows, n, k))


@functools.lru_cache(maxsize=4096)
def _sizes(rows: int, n: int, k: int):
    """(scratch keys, state words) of a launch, asked of the library once
    per shape."""
    lib = _kernel()
    return (int(lib.vector_topk_scratch_keys(rows, n, k)),
            int(lib.vector_topk_state_words(rows, n, k)))


def _state(device: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (device.index, stream)
    with _STATE_LOCK:
        t = _STATE.get(key)
        if t is None or t.numel() < words:
            t = _STATE[key] = torch.zeros(max(words, 1), dtype=torch.int32, device=device)
        return t


def launch_counts(rows: int, n: int, k: int) -> dict:
    """{kernel name: launches} of one `topk` call on rows x n: the plan
    the kernel's own launcher runs, read from the library. Builds the
    kernel if needed."""
    lib = _kernel()
    counts = (ctypes.c_int * 16)()
    m = lib.vector_topk_launch_counts(rows, n, k, counts)
    if m < 0 or m > len(counts):
        raise ValueError(f"no launch plan for rows={rows}, n={n}, k={k}")
    return {
        lib.vector_topk_kernel_name(i).decode(): counts[i]
        for i in range(m)
        if counts[i]
    }


# the TF32 flag is process-wide: one GEMM at a time switches it off, and
# each restores what it found
_TF32_LOCK = threading.Lock()


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32: the GEMM in front of this kernel must keep
    every mantissa bit, as on jax-CPU. TF32 is off for this call only;
    the caller's `torch.backends.cuda.matmul.allow_tf32` is put back."""
    flags = torch.backends.cuda.matmul
    with _TF32_LOCK:
        before = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return torch.matmul(a, b)
        finally:
            flags.allow_tf32 = before


def pad_rows(Q: torch.Tensor) -> torch.Tensor:
    """Q (m, d) with zero rows appended up to MIN_ROWS. The GEMM and
    `query_stat` in front of this kernel run on the padded rows and keep
    the first m: BLAS and cuBLAS pick their kernel, and with it the order
    of each dot's sums, by the row count (a GEMV for one row), so a query
    searched alone would otherwise score other dots than the same query
    coalesced with up to MIN_ROWS - 1 others."""
    m = Q.shape[0]
    if m >= MIN_ROWS:
        return Q
    return torch.cat([Q, Q.new_zeros((MIN_ROWS - m, Q.shape[1]))])


def query_stat(Q: torch.Tensor, metric: str) -> torch.Tensor:
    """The per-query statistic of the epilogue: |q|^2 for euclidean, |q|
    for cosine, zeros otherwise. Q (rows, d) f32 -> (rows,) f32."""
    if metric == "euclidean":
        return (Q * Q).sum(dim=1)
    if metric == "cosine":
        return torch.sqrt((Q * Q).sum(dim=1))
    return torch.zeros(Q.shape[0], dtype=torch.float32, device=Q.device)


def epilogue_plain(x, sqnorm, qstat, metric: str) -> torch.Tensor:
    """Distances from dot rows x (rows, n), the reference's expressions in
    its order of operations."""
    if metric == "distance":
        return x
    if metric == "dotproduct":
        return -x
    if metric == "cosine":
        den = torch.sqrt(sqnorm)[None, :] * qstat[:, None]
        return 1.0 - x / torch.clamp_min(den, 1e-12)
    return sqnorm[None, :] - 2.0 * x + qstat[:, None]


def order_keys(d: torch.Tensor) -> torch.Tensor:
    """(rows, n) f32 -> int64 keys that sort as (total order of d, column):
    the float's bits mapped to an orderable uint32, shifted into the high
    half (offset by 2^31 so the key stays a signed int64), the column in
    the low half."""
    b = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    o = torch.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b | (1 << 31))
    cols = torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
    return ((o - (1 << 31)) << 32) | cols


def topk_plain(x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
    """Plain PyTorch version of `topk`: the epilogue, the mask, then a
    top-k on the unique order keys."""
    if col_index is not None:
        cols = col_index.long()
        x = x[:, cols]
        sqnorm = None if sqnorm is None else sqnorm[cols]
        valid = None if valid is None else valid[cols]
    d = epilogue_plain(x, sqnorm, qstat, metric)
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.inf)
    top = torch.topk(order_keys(d), k, dim=1, largest=False, sorted=True).values
    idx = top & 0xFFFFFFFF
    return torch.gather(d, 1, idx), idx.to(torch.int32)


def _check(x, k, metric, sqnorm, valid, qstat, col_index):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"want x (rows, n) float32, got {x.dtype} {tuple(x.shape)}")
    if metric not in METRIC_ID:
        raise ValueError(f"unknown metric {metric!r}")
    rows = x.shape[0]
    n = x.shape[1] if col_index is None else col_index.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if n > MAX_N or rows > 65535:
        raise ValueError(f"at most 65535 rows of 2^30 columns, got {rows} x {n}")
    if metric in ("euclidean", "cosine") and (sqnorm is None or qstat is None):
        raise ValueError(f"{metric} needs sqnorm and qstat")
    width = x.shape[1]
    for name, t, dtype, shape in (
        ("sqnorm", sqnorm, torch.float32, (width,)),
        ("valid", valid, torch.bool, (width,)),
        ("qstat", qstat, torch.float32, (rows,)),
        ("col_index", col_index, torch.int32, None),
    ):
        if t is None:
            continue
        if t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if col_index is not None and col_index.dim() != 1:
        raise ValueError("col_index must be 1-d")


def topk(x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
    """The k smallest distances of each row, ascending, and their columns.

    x (rows, w) f32: dot products (or distances, metric "distance");
    sqnorm (w,) f32 and valid (w,) bool per column of x; qstat (rows,) f32
    from `query_stat`; col_index (n,) int32 picks the row's n columns of
    x (default: all w). Returns (d (rows, k) f32, idx (rows, k) int32),
    idx indexing the n columns. On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version."""
    global LAUNCHES, PLAIN_CALLS
    _check(x, k, metric, sqnorm, valid, qstat, col_index)
    if x.device.type == "cpu":
        PLAIN_CALLS += 1
        return topk_plain(x, k, metric, sqnorm, valid, qstat, col_index)
    if x.device.type != "cuda":
        raise ValueError(f"vector top-k runs on cuda or cpu, not {x.device}")
    ts = [x, sqnorm, valid, qstat, col_index]
    if any(t is not None and not t.is_contiguous() for t in ts):
        raise ValueError("vector top-k wants contiguous tensors")
    lib = _kernel()
    rows = x.shape[0]
    n = x.shape[1] if col_index is None else col_index.shape[0]
    out_d = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    keys, words = _sizes(rows, n, k)
    scratch = torch.empty(max(keys, 1), dtype=torch.int64, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        state = _state(x.device, stream, words)
        err = lib.vector_topk_launch(
            x.data_ptr(), x.shape[1], ptr(sqnorm), ptr(valid), ptr(col_index),
            ptr(qstat), METRIC_ID[metric], rows, n, k,
            out_d.data_ptr(), out_i.data_ptr(), scratch.data_ptr(),
            state.data_ptr(), stream,
        )
    if err:
        with _STATE_LOCK:  # a launch cut short may leave it dirty
            _STATE.pop((x.device.index, stream), None)
        raise RuntimeError(f"vector_topk launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_d, out_i
