"""KV2: the IVF slab scan, each probed slab read in place.

Port of the gather and the distances of `dgraph_tpu/models/vector.py`'s
`_ivf_probe`: for every query and every slab it probes, the metric
distances of the slab's 128 rows, +inf where a row is past its cell's
end (flat_rows < 0). The reference materialised the (M, 128, d) gather
per query; the kernel, `csrc/ivf_slab_scan.cu`, written by hand for
Hopper, reads each probed slab once with the query in shared memory and
writes only the distances. `slab_distances_plain` beside it is the same
function in plain PyTorch (a gather and a matmul per query), taken for
tensors on the CPU.

The kernel sums each dot in its own order, not torch.matmul's, so the
two versions agree to a tolerance (stated in the tests and in
`chip_smoke.py`), not bit for bit; the epilogue's arithmetic is the same.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops import vector_topk

SLAB = 128  # rows per slab (models/vector.py _SLAB)
METRIC_ID = {"euclidean": 0, "cosine": 1, "dotproduct": 2}

# kernel launches, for showing that a path went through the kernel; the
# plain version's calls on CPU tensors are counted apart
LAUNCHES = 0
PLAIN_CALLS = 0

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ivf_slab_scan library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ivf_slab_scan_launch.restype = i
    lib.ivf_slab_scan_launch.argtypes = [p] * 6 + [i] * 4 + [p, p]
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("ivf_slab_scan"))
    return _lib


# How far the kernel's distances may stand from the plain version's: each
# dot is a sum of d products taken in another order, so its error is
# bounded by a few ulps of sum |v_i q_i| <= |v||q| (Cauchy-Schwarz); 1e-5
# of |v||q| is ~150 f32 ulps, far above the ~30 roundings of either order.
TOL = 1e-5


def tolerance(sq, Q, metric):
    """Per-element bound on |kernel - plain| for distances whose rows have
    squared norms sq (nq, r), against queries Q (nq, d)."""
    qn = torch.sqrt((Q * Q).sum(dim=1))[:, None]
    vq = torch.sqrt(sq) * qn
    if metric == "euclidean":  # sq - 2 dot + |q|^2
        return TOL * (2.0 * vq + sq + qn * qn)
    if metric == "cosine":  # 1 - dot / (|v||q|)
        return torch.full_like(sq, 2.0 * TOL)
    return TOL * vq


def slab_distances_plain(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric):
    """Plain PyTorch version of `slab_distances`: per query, the gather of
    its slabs, one matmul and the epilogue."""
    nq, M = sidx.shape
    out = torch.empty((nq, M * SLAB), dtype=torch.float32, device=Q.device)
    for i in range(nq):
        s = sidx[i].long()
        V = flat_vecs[s].reshape(M * SLAB, -1)
        dot = (V @ Q[i])[None, :]
        d = vector_topk.epilogue_plain(
            dot, flat_sq[s].reshape(-1), qstat[i : i + 1], metric
        )[0]
        out[i] = torch.where(flat_rows[s].reshape(-1) >= 0, d, torch.inf)
    return out


def _check(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric):
    if metric not in METRIC_ID:
        raise ValueError(f"unknown metric {metric!r} for the slab scan")
    if flat_vecs.dim() != 3 or flat_vecs.shape[1] != SLAB:
        raise ValueError(f"want flat_vecs (n_slabs, {SLAB}, d), got {tuple(flat_vecs.shape)}")
    n_slabs, _, d = flat_vecs.shape
    if sidx.dim() != 2 or Q.dim() != 2 or Q.shape != (sidx.shape[0], d):
        raise ValueError(f"want sidx (nq, M) and Q (nq, {d}), got {tuple(sidx.shape)}, {tuple(Q.shape)}")
    if sidx.shape[0] > 65535:
        raise ValueError("at most 65535 queries a call")
    for name, t, dtype, shape in (
        ("flat_vecs", flat_vecs, torch.float32, None),
        ("flat_sq", flat_sq, torch.float32, (n_slabs, SLAB)),
        ("flat_rows", flat_rows, torch.int32, (n_slabs, SLAB)),
        ("sidx", sidx, torch.int32, None),
        ("Q", Q, torch.float32, None),
        ("qstat", qstat, torch.float32, (sidx.shape[0],)),
    ):
        if t.dtype != dtype or t.device != Q.device:
            raise ValueError(f"{name} must be {dtype} on {Q.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def slab_distances(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric):
    """dd[i, m * 128 + s]: the distance of query i to row s of slab
    sidx[i, m], +inf where flat_rows says the row is padding.

    flat_vecs (n_slabs, 128, d) f32, flat_sq and flat_rows (n_slabs, 128)
    f32 / int32, sidx (nq, M) int32, Q (nq, d) f32, qstat (nq,) f32 from
    `vector_topk.query_stat`. Returns (nq, M * 128) f32. On a CUDA tensor
    this launches the kernel; on a CPU tensor it runs the plain
    version."""
    global LAUNCHES, PLAIN_CALLS
    _check(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric)
    if Q.device.type == "cpu":
        PLAIN_CALLS += 1
        return slab_distances_plain(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric)
    if Q.device.type != "cuda":
        raise ValueError(f"the slab scan runs on cuda or cpu, not {Q.device}")
    ts = (flat_vecs, flat_sq, flat_rows, sidx, Q, qstat)
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("the slab scan wants contiguous tensors")
    lib = _kernel()
    nq, M = sidx.shape
    dd = torch.empty((nq, M * SLAB), dtype=torch.float32, device=Q.device)
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ivf_slab_scan_launch(
            *(t.data_ptr() for t in ts), METRIC_ID[metric], nq, M,
            flat_vecs.shape[2], dd.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"ivf_slab_scan launch failed: cudaError {err}")
    LAUNCHES += 1
    return dd
