"""Vector similarity index: quantized scan engine + brute/IVF tiers.

Replaces the reference's HNSW (dgraph/tok/hnsw/persistent_hnsw.go)
behind the same index-boundary semantics (tok/index/index.go:93 VectorIndex:
Search/SearchWithUid/Insert, per-call ef / distance_threshold options,
filtered search). HNSW's pointer-chasing beam search is hostile to the TPU
(SURVEY.md §2.7(7)); the sanctioned replacements are:

  - QUANTIZED engine (default on CPU-backend hosts, `DGRAPH_TPU_VEC_QUANT`):
    the corpus is stored as per-row asymmetric int8 (v ≈ scale*code+offset,
    scale/offset/code-sum/exact-sqnorm sidecars — a 4x memory-bandwidth cut
    on the scan-dominated host path), scored by the native qint8 kernels
    (codec.cpp vec_qi8_topk / vec_qi8_topk_idx: SIMD int8 dot, fused
    partial top-k, deterministic low-index tie-break), and the surviving
    pool is reranked EXACTLY in float32 so quantization error cannot
    reorder the final top-k (`DGRAPH_TPU_VEC_RERANK` * k candidates).
    Its IVF tier is INCREMENTAL: centroids train once via sampled
    mini-batch k-means, rows are assigned lazily to their 2 nearest cells
    (per-cell row-id lists over the row-aligned code matrix — inserts
    append to cells, removes tombstone in place, and NO mutation ever
    retrains or re-lays-out the index inline; a deferred repartition
    runs when tombstone garbage passes live/4 (cells reassigned,
    centroids kept) or when the max/avg cell ratio GROWS past
    `DGRAPH_TPU_VEC_REBUILD_IMBALANCE` x its post-build baseline —
    imbalance the data had at build time is the baseline, not a
    trigger, since reassigning under the same centroids reproduces it;
    mutation-driven hot cells retrain the centroids on a sample).

  - jitted float32 paths (the A/B escape hatch `DGRAPH_TPU_VEC_QUANT=0`,
    and the device path on real accelerators — unchanged in shape):
    brute-force scores = Q @ V.T on the MXU + lax.top_k in ONE dispatch
    with an optimization barrier (without it XLA recomputes the matmul
    per sort pass — 82ms -> 2.3ms per query on a v5e for 100k x 256);
    IVF probes top-M fixed-size slabs so the whole search is one
    static-shape dispatch (no host loop over cells).

Every search picks brute vs IVF per CALL from the probed-pool-vs-corpus
cost model (`_ivf_pick`): the batched jit probe gathers (m_slabs*SLAB, d)
floats PER QUERY while the brute matmul reads the corpus once per batch,
so a probe pool that undercuts the corpus 15x can still lose at batch 64
(the VECTOR_1M_CPU.json r5 inversion: IVF 5.8 qps vs brute 12.2). The
quantized engine's probe runs the same scan kernel as its brute tier, so
there the crossover is simply probed-rows ~ corpus-rows.

Metrics match tok/hnsw/helper.go:98-114: euclidean, cosine, dotproduct.
Supported distance ordering: smaller = closer (dot negated).

Mutability: rows are append-only with tombstones (no swap-compaction, so
quantized sidecars and IVF cell ids stay valid across removes); the
jitted device matrix compacts lazily on rebuild (the MVCC analog of pack
re-upload on rollup), while the quantized engine folds mutations in
incrementally.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import Dict, Optional

import numpy as np

from dgraph_tpu_torch.x import config

_PAD_ROWS = 256
_SLAB = 128  # IVF slab rows; one slab belongs to exactly one cell

# below this many live rows the jitted float brute scan is already sub-ms
# and exact — quantization is a bandwidth optimization, not a small-corpus
# one (tests monkeypatch this to force the quantized engine on tiny data)
_QUANT_MIN = 4096

_METRIC_ID = {"euclidean": 0, "cosine": 1, "dotproduct": 2}

_EMPTY_U64 = np.zeros((0,), np.uint64)

# native int8 top-2 cell assignment engages above this many multiply-
# accumulates (rows * nlist * dim) — below it the exact numpy path is
# already fast and keeps small-corpus layouts float-exact (tests force
# the native path by zeroing this)
_ASSIGN_NATIVE_MIN_MACS = 2e10


def _nthreads() -> int:
    """Worker threads for the native quantized kernels: the VEC_THREADS
    knob, 0 = one per core."""
    t = int(config.get("VEC_THREADS"))
    if t > 0:
        return t
    import os

    return os.cpu_count() or 1


# ---------------------------------------------------------------------------
# Attribution counters (mirrors ops/packed_setops.COUNTERS: per-thread,
# snapshot() consumed by observe.profile_scope into extensions.profile)
# ---------------------------------------------------------------------------


class _VecCounters(threading.local):
    """Per-thread vector-kernel accounting (threads serve independent
    queries; the coalesced batch leader accounts for its whole batch)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.searches = 0       # queries served (any tier)
        self.probe_cells = 0    # IVF cells probed
        self.rerank_pool = 0    # candidates reranked in float32
        self.scan_rows = 0      # rows scored by the quantized kernels
        self.scan_ns = 0        # quantized scan time
        self.rerank_ns = 0      # float32 rerank time
        self.path_quant_ivf = 0
        self.path_quant_brute = 0
        self.path_jit_ivf = 0
        self.path_jit_brute = 0

    def snapshot(self) -> dict:
        return {
            "searches": self.searches,
            "probe_cells": self.probe_cells,
            "rerank_pool": self.rerank_pool,
            "scan_rows": self.scan_rows,
            "scan_ns": self.scan_ns,
            "rerank_ns": self.rerank_ns,
            "path_quant_ivf": self.path_quant_ivf,
            "path_quant_brute": self.path_quant_brute,
            "path_jit_ivf": self.path_jit_ivf,
            "path_jit_brute": self.path_jit_brute,
        }


COUNTERS = _VecCounters()


def reset_counters():
    COUNTERS.reset()


def counters() -> dict:
    return COUNTERS.snapshot()


def _metrics():
    from dgraph_tpu_torch.utils.observe import METRICS

    return METRICS


_BACKEND_CPU: Optional[bool] = None


def _cpu_backend(device) -> bool:
    """True when the index serves from the host CPU — the regime where
    the quantized scan engine beats the float paths. The reference asks
    jax's default backend; here each index names its torch device."""
    return device.type == "cpu"


def _pow2_rows(n: int) -> int:
    return max(_PAD_ROWS, 1 << (max(1, n) - 1).bit_length())


def _jit_brute(metric: str, npool: int):
    """The brute scorer for one query q (d,): row 0 of the batch form.
    Returns (distances (npool,), row indices (npool,))."""
    batch = _jit_brute_batch(metric, npool)

    def run(V, sqnorm, valid, q):
        d, idx = batch(V, sqnorm, valid, q[None, :])
        return d[0], idx[0]

    return run


def _jit_brute_batch(metric: str, npool: int):
    """The brute scorer for Q (m, d): dot = Q @ V^T (torch.matmul), then
    KV1 (ops/vector_topk.py) fuses the distance epilogue, the invalid-row
    mask and the top-npool per row. Returns ((m, npool) distances
    ascending, (m, npool) int32 row indices), in lax.top_k's order. The
    GEMM runs on at least vector_topk.MIN_ROWS rows, so a row scores the
    same alone as in a batch of up to that many."""
    from dgraph_tpu_torch.ops import vector_topk

    def run(V, sqnorm, valid, Q):
        m, Qp = len(Q), vector_topk.pad_rows(Q)
        return vector_topk.topk(
            vector_topk.f32_matmul(Qp, V.T)[:m], npool, metric,
            sqnorm=sqnorm, valid=valid,
            qstat=vector_topk.query_stat(Qp, metric)[:m],
        )

    return run


def _dedup_first(rows: np.ndarray) -> np.ndarray:
    """Indices of the first occurrence of each row id, in original order.
    Probe results ascend by distance, so the first occurrence of a
    multi-assigned row is its best distance. Input must be filtered to
    valid (>=0) rows."""
    _, first = np.unique(rows, return_index=True)
    return np.sort(first)


def _probe_plan(ivf: dict, pool: int):
    """Widen the static slab probe in pow2 factors until it covers the
    requested candidate pool (bounded jit signatures); npool carries 2x
    slack for multi-assignment duplicates."""
    base_pool = 64
    factor = 1
    while factor * base_pool < pool and ivf["m_slabs"] * factor < ivf[
        "n_slabs"
    ]:
        factor *= 2
    m = int(min(ivf["n_slabs"], ivf["m_slabs"] * factor))
    npool = int(min(max(pool, 1) * 2, m * _SLAB))
    return m, npool


def _ivf_probe(metric: str, m_slabs: int, npool: int):
    """The IVF probe for a batch of queries Q (m, d), every row scored
    independently: centroid scores -> top-M slabs -> slab distances ->
    top-npool. All shapes static. The centroid GEMM is torch.matmul; KV1
    (ops/vector_topk.py) fuses the centroid epilogue, the slab_cell
    gather and the top-M, KV2 (ops/ivf_scan.py) reads the probed slabs in
    place (no (M, S, d) gather) into distances, and KV1 again takes the
    top-npool. Returns ((m, npool) distances, (m, npool) row ids). The
    centroid GEMM and the query statistics run on at least
    vector_topk.MIN_ROWS rows, so a row scores the same alone as in a
    batch of up to that many."""
    import torch

    from dgraph_tpu_torch.ops import ivf_scan, vector_topk

    def run(cents, csq, slab_cell, flat_vecs, flat_sq, flat_rows, Q):
        m, Qp = len(Q), vector_topk.pad_rows(Q)
        # nearest cells by centroid distance (always euclidean on the
        # centroid geometry — probe selection only, not result ranking)
        _, sidx = vector_topk.topk(
            vector_topk.f32_matmul(Qp, cents.T)[:m], m_slabs, "euclidean",
            sqnorm=csq, qstat=vector_topk.query_stat(Qp, "euclidean")[:m],
            col_index=slab_cell,
        )
        dd = ivf_scan.slab_distances(
            flat_vecs, flat_sq, flat_rows, sidx, Q,
            vector_topk.query_stat(Qp, metric)[:m], metric,
        )
        d, idx = vector_topk.topk(dd, npool, "distance")
        rows = flat_rows[sidx.long()].reshape(len(Q), -1)
        return d, torch.gather(rows, 1, idx.long())

    return run


def _jit_ivf(metric: str, m_slabs: int, npool: int):
    """The IVF probe for one query q (d,): row 0 of the batch form."""
    batch = _ivf_probe(metric, m_slabs, npool)

    def run(cents, csq, slab_cell, flat_vecs, flat_sq, flat_rows, q):
        d, rows = batch(
            cents, csq, slab_cell, flat_vecs, flat_sq, flat_rows, q[None, :]
        )
        return d[0], rows[0]

    return run


def _jit_ivf_batch(metric: str, m_slabs: int, npool: int):
    """Batched IVF probe: a whole query batch is one pass of each kernel
    and one host fetch (the reference vmapped the single-query jit)."""
    return _ivf_probe(metric, m_slabs, npool)


# ---------------------------------------------------------------------------
# Scalar quantization (per-row asymmetric int8)
# ---------------------------------------------------------------------------


def _quantize(V: np.ndarray):
    """Per-row asymmetric int8: v_ij ≈ scale_i*code_ij + offset_i with
    codes in [-127, 127]. Returns (codes i8, scales f32, offsets f32,
    csums i32). Constant rows quantize to all-zero codes with the exact
    value in the offset."""
    V = np.ascontiguousarray(V, np.float32)
    mn = V.min(axis=1)
    mx = V.max(axis=1)
    offsets = ((mx + mn) * np.float32(0.5)).astype(np.float32)
    scales = np.maximum(
        (mx - mn) / np.float32(254.0), np.float32(1e-20)
    ).astype(np.float32)
    codes = np.clip(
        np.rint((V - offsets[:, None]) / scales[:, None]), -127, 127
    ).astype(np.int8)
    # int64 accumulate then narrow: d*127 fits i32 for any real dim, the
    # wide accumulate just keeps the reduction overflow-free
    csums = codes.sum(axis=1, dtype=np.int64).astype(np.int32)
    return codes, scales, offsets, csums


def _quantize_queries(Q: np.ndarray, metric: str):
    """Quantized query batch + the exact per-query stat the distance
    reconstruction needs (q·q for euclidean, |q| for cosine)."""
    Q = np.ascontiguousarray(Q, np.float32)
    qc, qscales, qoffsets, qcsums = _quantize(Q)
    qsq = (Q * Q).sum(axis=1, dtype=np.float32)
    if metric == "cosine":
        qstats = np.sqrt(qsq).astype(np.float32)
    elif metric == "euclidean":
        qstats = qsq.astype(np.float32)
    else:
        qstats = np.zeros((len(Q),), np.float32)
    return qc, qscales, qoffsets, qcsums, qstats


def _qi8_scan_py(
    codes, scales, offsets, csums, sqnorms, valid,
    qc, qscale, qoffset, qcsum, qstat, metric: str, k: int,
    rows: Optional[np.ndarray] = None,
):
    """Pure-numpy mirror of the native qint8 kernels (used when the
    native lib is unavailable): the integer dot is computed exactly (f64
    matmul holds any int8 dot exactly), the float32 reconstruction uses
    the same formula, and ties break toward the lower row index."""
    if rows is None:
        rows = np.flatnonzero(valid).astype(np.int64)
    else:
        rows = np.asarray(rows, np.int64)
        rows = rows[valid[rows] != 0]
    if rows.size == 0:
        return np.full((k,), -1, np.int64), np.full((k,), np.inf, np.float32)
    d = codes.shape[1]
    d8 = codes[rows].astype(np.float64) @ qc.astype(np.float64)
    s = scales[rows]
    o = offsets[rows]
    dot = (
        np.float32(qscale)
        * (s * d8.astype(np.float32) + o * np.float32(qcsum))
        + np.float32(qoffset)
        * (s * csums[rows].astype(np.float32) + np.float32(d) * o)
    )
    sq = sqnorms[rows]
    if metric == "euclidean":
        dist = (sq - np.float32(2.0) * dot + np.float32(qstat)).astype(
            np.float32
        )
    elif metric == "cosine":
        vn = np.sqrt(sq)
        dist = (
            np.float32(1.0)
            - dot / np.maximum(vn * np.float32(qstat), np.float32(1e-12))
        ).astype(np.float32)
    else:
        dist = (-dot).astype(np.float32)
    order = np.lexsort((rows, dist))[:k]
    out_i = np.full((k,), -1, np.int64)
    out_d = np.full((k,), np.inf, np.float32)
    out_i[: order.size] = rows[order]
    out_d[: order.size] = dist[order]
    return out_i, out_d


# ---------------------------------------------------------------------------
# Centroid training (sampled mini-batch k-means) + top-2 assignment
# ---------------------------------------------------------------------------


def _train_centroids(X: np.ndarray, nlist: int, rng) -> np.ndarray:
    """Mini-batch k-means (Sculley 2010) on a bounded sample: the full
    Lloyd-on-100k-sample train this replaces cost 255s at 1Mx768
    (VECTOR_1M_CPU.json) — the mini-batch pass is bounded by
    steps*B*nlist*d regardless of corpus size."""
    n, d = X.shape
    nlist = max(1, min(nlist, n))
    sample_n = int(min(n, max(32 * nlist, 16384)))
    S = X if sample_n >= n else X[rng.choice(n, sample_n, replace=False)]
    cents = S[rng.choice(len(S), nlist, replace=False)].astype(
        np.float32
    ).copy()
    if nlist <= 1:
        return cents
    counts = np.zeros((nlist,), np.float32)
    B = min(2048, len(S))
    steps = int(min(max(12, 4 * len(S) // max(B, 1)), 48))
    for _ in range(steps):
        batch = S[rng.integers(0, len(S), B)]
        csq = (cents * cents).sum(axis=1)
        a = np.argmin(csq[None, :] - 2.0 * (batch @ cents.T), axis=1)
        order = np.argsort(a, kind="stable")
        ao = a[order]
        starts = np.flatnonzero(np.r_[True, ao[1:] != ao[:-1]])
        sums = np.add.reduceat(batch[order], starts, axis=0)
        uniq = ao[starts]
        cnt = np.diff(np.r_[starts, len(ao)]).astype(np.float32)
        counts[uniq] += cnt
        lr = (cnt / counts[uniq])[:, None]
        cents[uniq] = cents[uniq] * (1.0 - lr) + (
            sums / cnt[:, None]
        ) * lr
    return cents


def _assign_top1(X: np.ndarray, cents: np.ndarray) -> np.ndarray:
    csq = (cents * cents).sum(axis=1)
    out = np.empty((len(X),), np.int32)
    ch = max(256, int(8e6 // max(len(cents), 1)))
    for off in range(0, len(X), ch):
        xc = X[off : off + ch]
        out[off : off + ch] = np.argmin(
            csq[None, :] - 2.0 * (xc @ cents.T), axis=1
        )
    return out


def _assign_top2_exact(X: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """(m, 2) nearest-two centroid ids, chunked so the distance matrix
    stays bounded."""
    nlist = len(cents)
    m = len(X)
    out = np.empty((m, 2), np.int32)
    if nlist == 1:
        out[:] = 0
        return out
    csq = (cents * cents).sum(axis=1)
    ch = max(256, int(8e6 // nlist))
    for off in range(0, m, ch):
        xc = X[off : off + ch]
        d2 = csq[None, :] - 2.0 * (xc @ cents.T)
        p = np.argpartition(d2, 1, axis=1)[:, :2].astype(np.int32)
        dp = np.take_along_axis(d2, p, axis=1)
        swap = dp[:, 0] > dp[:, 1]
        p[swap] = p[swap][:, ::-1]
        out[off : off + ch] = p
    return out


def _assign_top2(X: np.ndarray, cents: np.ndarray, rng) -> np.ndarray:
    """Top-2 centroid assignment (multi-assignment doubles only the CELL
    ID lists, not the row-aligned codes — recall insurance at 8 bytes a
    row). Exact for small problems; above ~2e10 MACs the classic
    coarse-to-fine approximation: cluster the centroids into ~sqrt(nlist)
    groups, rank each row only against the members of its nearest few
    groups. An occasional second-best cell is an acceptable layout
    approximation — correctness lives in the probe + rerank."""
    m, d = X.shape
    nlist = len(cents)
    if nlist < 512 or m * nlist * d <= _ASSIGN_NATIVE_MIN_MACS:
        return _assign_top2_exact(X, cents)
    G = max(8, int(round(math.sqrt(nlist))))
    coarse = _train_centroids(cents, G, rng)
    ga = _assign_top1(cents, coarse)
    members = [
        np.flatnonzero(ga == g).astype(np.int32) for g in range(len(coarse))
    ]
    gd = ((coarse[:, None, :] - coarse[None, :, :]) ** 2).sum(axis=-1)
    nbr = np.argsort(gd, axis=1)[:, :4]  # self + 3 nearest groups
    xg = _assign_top1(X, coarse)
    out = np.empty((m, 2), np.int32)
    for g in range(len(coarse)):
        rows = np.flatnonzero(xg == g)
        if rows.size == 0:
            continue
        cand = np.concatenate(
            [members[j] for j in nbr[g] if members[j].size]
        ) if any(members[j].size for j in nbr[g]) else np.arange(
            nlist, dtype=np.int32
        )
        if cand.size < 2:
            cand = np.arange(nlist, dtype=np.int32)
        sub = _assign_top2_exact(X[rows], cents[cand])
        out[rows] = cand[sub]
    return out


class VectorIndex:
    def __init__(
        self,
        pred: str,
        metric: str = "euclidean",
        ivf_threshold: int = 200_000,
        nlist: Optional[int] = None,
        nprobe: Optional[int] = None,
        device="cuda",
    ):
        from dgraph_tpu_torch.device import resolve_device

        if metric not in ("euclidean", "cosine", "dotproduct"):
            raise ValueError(f"unknown metric {metric!r}")
        # the torch device of the float paths; "cuda" raises without a
        # card (no silent host fallback), the tests pass "cpu"
        self.device = resolve_device(device)
        self.pred = pred
        self.metric = metric
        self.ivf_threshold = ivf_threshold
        self.nlist = nlist
        self.nprobe = nprobe

        # append-only row store with tombstones: a remove (or re-insert)
        # never moves another row, so quantized sidecars and IVF cell ids
        # stay valid across mutations
        self._rows: Dict[int, int] = {}  # uid -> live row
        self._vecs: Optional[np.ndarray] = None  # (cap, d) float32
        self._uid_of: Optional[np.ndarray] = None  # (cap,) uint64, 0=dead
        self._valid: Optional[np.ndarray] = None  # (cap,) uint8
        self._n = 0  # high-water rows (live + tombstoned)
        self._live = 0

        self._dirty = True
        self._device = None  # torch tensors (vecs, norms, valid) + uids
        self._uids_np: Optional[np.ndarray] = None  # compacted uid map
        self._ivf = None  # jit-path slab IVF
        self._mesh = None

        # quantized engine state (row-aligned sidecars + incremental IVF)
        self._q: Optional[dict] = None
        self._qivf: Optional[dict] = None
        self._lock = threading.RLock()
        # index-level build accounting ("no full rebuild on mutation" is
        # equivalence-tested against these)
        self.build_count = 0
        self.repartition_count = 0

    # -- mutation -------------------------------------------------------------

    def _grow(self, need_rows: int):
        cap = self._vecs.shape[0]
        if need_rows <= cap:
            return
        newcap = max(cap, 1)  # cap can be 0 after an empty bulk_load
        while newcap < need_rows:
            newcap *= 2
        grown = np.zeros((newcap, self._vecs.shape[1]), np.float32)
        grown[: self._n] = self._vecs[: self._n]
        self._vecs = grown
        u = np.zeros((newcap,), np.uint64)
        u[: self._n] = self._uid_of[: self._n]
        self._uid_of = u
        v = np.zeros((newcap,), np.uint8)
        v[: self._n] = self._valid[: self._n]
        self._valid = v

    def insert(self, uid: int, vec) -> None:
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        with self._lock:
            if self._vecs is None:
                self._vecs = np.zeros((_PAD_ROWS, vec.shape[0]), np.float32)
                self._uid_of = np.zeros((_PAD_ROWS,), np.uint64)
                self._valid = np.zeros((_PAD_ROWS,), np.uint8)
            if vec.shape[0] != self._vecs.shape[1]:
                raise ValueError(
                    f"dim mismatch: index {self._vecs.shape[1]}, "
                    f"got {vec.shape[0]}"
                )
            uid = int(uid)
            old = self._rows.get(uid)
            if old is not None:
                # update = tombstone + append: the new value may belong
                # to a different IVF cell, and an in-place overwrite
                # would silently stale the quantized sidecars
                self._tombstone(old)
            self._grow(self._n + 1)
            row = self._n
            self._n += 1
            self._vecs[row] = vec
            self._uid_of[row] = uid
            self._valid[row] = 1
            self._rows[uid] = row
            self._live += 1
            self._dirty = True

    def remove(self, uid: int) -> None:
        with self._lock:
            row = self._rows.pop(int(uid), None)
            if row is None:
                return
            self._tombstone(row)
            self._dirty = True

    def _tombstone(self, row: int) -> None:
        # under self._lock
        self._valid[row] = 0
        self._uid_of[row] = 0
        self._live -= 1
        if self._qivf is not None and row < self._qivf["assigned"]:
            self._qivf["dead"] += 1

    def bulk_load(self, uids, V) -> None:
        """Adopt (uids, V) wholesale — the loader/bench fast path (one
        assignment instead of n inserts; V is adopted, not copied)."""
        V = np.ascontiguousarray(V, np.float32)
        uids = np.asarray(uids, np.uint64)
        if V.ndim != 2 or len(uids) != len(V):
            raise ValueError("bulk_load wants aligned (uids, (n, d) vecs)")
        with self._lock:
            n = len(uids)
            self._vecs = V
            self._uid_of = uids.copy()
            self._valid = np.ones((n,), np.uint8)
            self._rows = {int(u): i for i, u in enumerate(uids)}
            self._n = n
            self._live = n
            self._dirty = True
            self._q = None
            self._qivf = None
            self._device = None
            self._ivf = None

    def __len__(self) -> int:
        return self._live

    @property
    def dim(self) -> Optional[int]:
        """Vector dimensionality, None before the first insert."""
        return None if self._vecs is None else int(self._vecs.shape[1])

    # -- engine choice ---------------------------------------------------------

    def _use_quant(self) -> bool:
        if not (
            bool(config.get("VEC_QUANT"))
            and not bool(config.get("SHARD_VECTORS"))
            and self._live >= _QUANT_MIN
            and _cpu_backend(self.device)
        ):
            return False
        from dgraph_tpu_torch import native

        # without the native kernels the quantized path would run on
        # the pure-numpy mirror, which is strictly slower (and far more
        # allocation-hungry) than the jitted float path it displaces —
        # the mirror exists for bit-equality tests, not serving
        return native.NATIVE_AVAILABLE

    @staticmethod
    def _ivf_pick(nq: int, probed_rows: int, n: int, quant: bool) -> bool:
        """Per-call brute-vs-IVF crossover: True = IVF wins.

        Quantized engine: probe and brute run the SAME scan kernel, the
        probe just adds random row access (~30%) — IVF wins whenever the
        probed pool undercuts the corpus.

        Jitted float path: a single-query probe pays a gather plus a
        small matmul against one full-corpus fused matvec (~3x per
        probed row); BATCHED probes gather (m_slabs*SLAB, d) floats per
        query while the brute matmul reads the corpus once per batch —
        the probed pool must undercut the corpus by the batch
        amortization factor too, which is how batched IVF at 3% probe
        still lost to brute 5.8-vs-12.2 qps in the r5 capture."""
        if probed_rows >= n:
            return False
        if quant:
            return probed_rows * 13 < n * 10
        if nq <= 1:
            return probed_rows * 3 < n
        return probed_rows * 3 * min(nq, 16) < n

    def _jit_ivf_wins(self, nq: int) -> bool:
        if self._ivf is None:
            return False
        probed = int(self._ivf["m_slabs"]) * _SLAB
        return self._ivf_pick(nq, probed, max(self._live, 1), quant=False)

    # -- device state (jitted float paths) ------------------------------------

    def _sync_device(self):
        import torch

        if not self._dirty and self._device is not None:
            return
        with self._lock:
            # gather atomically: the quant path's compaction renumbers
            # rows and swaps these buffers under the same lock, so an
            # unlocked multi-step read here could mix old indices with
            # new (shorter) arrays
            live_idx = np.flatnonzero(self._valid[: self._n])
            nlive = int(live_idx.size)
            cap = _pow2_rows(nlive)
            d = self._vecs.shape[1]
            mat = np.zeros((cap, d), np.float32)
            mat[:nlive] = self._vecs[live_idx]
            uids = np.zeros((cap,), np.uint64)
            uids[:nlive] = self._uid_of[live_idx]
        valid = np.zeros((cap,), bool)
        valid[:nlive] = True
        self._uids_np = uids
        self._mesh = None
        mesh = None
        if bool(config.get("SHARD_VECTORS")):
            from dgraph_tpu_torch.parallel import mesh as pmesh

            mesh = pmesh.make_mesh(device=self.device)
        if mesh is not None and mesh.size > 1:
            # row-shard the corpus over the device mesh: per-shard top-k,
            # all_gather, global reduce (parallel/mesh.py sharded_topk —
            # the TP-over-rows data plane for 1M×768-class corpora)
            ndev = mesh.size
            rows = -(-cap // ndev) * ndev
            if rows != cap:
                mat = np.vstack([mat, np.zeros((rows - cap, d), np.float32)])
                uids = np.concatenate(
                    [uids, np.zeros((rows - cap,), np.uint64)]
                )
                valid = np.concatenate(
                    [valid, np.zeros((rows - cap,), bool)]
                )
                self._uids_np = uids
            self._mesh = mesh
            self._device = {
                "vecs": pmesh.shard(mesh, mat),
                "uids": uids,  # host: gathered indices map back to uids
                "valid": pmesh.shard(mesh, valid),
                "sqnorm": None,
            }
            self._dirty = False
            if nlive >= self.ivf_threshold:
                self._train_ivf(mat[:nlive])
            else:
                self._ivf = None
            return
        dev = self.device
        self._device = {
            "vecs": torch.from_numpy(mat).to(dev),
            "uids": uids,
            "valid": torch.from_numpy(valid).to(dev),
            "sqnorm": torch.from_numpy((mat * mat).sum(axis=1)).to(dev),
        }
        self._dirty = False
        if nlive >= self.ivf_threshold:
            self._train_ivf(mat[:nlive])
        else:
            self._ivf = None

    # -- search ----------------------------------------------------------------

    def search(
        self,
        q,
        k: int,
        ef: Optional[int] = None,
        distance_threshold: Optional[float] = None,
        allowed: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Top-k closest uids (sorted closest-first).

        `allowed`: optional sorted uid filter (ref index.go:66 SearchFilter).
        `ef`: candidate-pool override, kept for HNSW API compat — used as
        the IVF candidate width.
        """
        if self._live == 0:
            return _EMPTY_U64
        q = np.asarray(q, dtype=np.float32).reshape(-1)
        kk = min(max(k, 1), self._live)
        pool = max(kk, ef or 0)
        allowed_set = None
        if allowed is not None:
            allowed_set = np.asarray(allowed, np.uint64)
            # filter drops candidates; widen the pool up-front
            pool = max(pool, 4 * kk)
        if self._use_quant():
            return self._quant_search_filtered(
                q, kk, pool, distance_threshold, allowed_set
            )
        self._sync_device()
        import torch

        COUNTERS.searches += 1
        _metrics().inc("vector_search_total")
        # widen the candidate pool until k survivors or the whole set seen
        # (the HNSW analog is raising ef; ref index.go VectorIndexOptions)
        while True:
            if self._mesh is not None:
                from dgraph_tpu_torch.parallel import mesh as pmesh

                npool = min(max(pool, kk), self._live)
                dd, idx = pmesh.sharded_topk(
                    self._mesh,
                    self._device["vecs"],
                    self._device["valid"],
                    torch.tensor(q),
                    npool,
                )
                cand_dists = dd.cpu().numpy()
                cand_uids = self._device["uids"][idx.cpu().numpy()]
            elif self._jit_ivf_wins(1):
                COUNTERS.path_jit_ivf += 1
                cand_uids, cand_dists = self._ivf_search(q, max(pool, 4 * kk))
            else:
                COUNTERS.path_jit_brute += 1
                npool = min(max(pool, kk), self._live)
                fn = _jit_brute(self.metric, int(npool))
                dd, idx = fn(
                    self._device["vecs"],
                    self._device["sqnorm"],
                    self._device["valid"],
                    torch.tensor(q, device=self.device),
                )
                cand_dists = dd.cpu().numpy()
                cand_uids = self._uids_np[idx.cpu().numpy()]

            out = self._filter_candidates(
                cand_uids, cand_dists, kk, distance_threshold, allowed_set
            )
            exhausted = len(cand_uids) >= self._live or pool >= self._live
            if len(out) == kk or exhausted or allowed_set is None:
                return np.asarray(out, np.uint64)
            pool = min(pool * 4, self._live)

    @staticmethod
    def _filter_candidates(cand_uids, cand_dists, kk, threshold, allowed_set):
        out = []
        for u, dist in zip(cand_uids, cand_dists):
            if not math.isfinite(dist):
                continue
            if threshold is not None and dist > threshold:
                break  # dists ascend: nothing closer follows
            if allowed_set is not None and not _in_sorted(allowed_set, u):
                continue
            out.append(int(u))
            if len(out) == kk:
                break
        return out

    def search_batch(self, Q, k: int) -> np.ndarray:
        """Top-k for a batch of queries. Returns (len(Q), min(k, live))
        uids, closest-first; a row with fewer than k survivors pads
        trailing slots with uid 0 — callers must treat 0 as absent, as
        with any uid list.

        Quantized engine: one corpus pass scores the whole batch (brute)
        or per-query cell probes share the row-aligned codes (IVF), with
        exact float32 rerank either way. Jitted paths: ONE device
        dispatch for the batch; the brute tier is exact, the IVF tier
        approximate (same probe as the single-query path, pool 4x k)."""
        if self._live == 0:
            return np.zeros((len(Q), 0), np.uint64)
        Q = np.ascontiguousarray(np.asarray(Q, np.float32))
        if self._use_quant():
            return self._quant_search_batch(Q, k)
        self._sync_device()
        if self._mesh is not None:
            # sharded corpus has no replicated sqnorm; reuse the per-query
            # mesh path (still one dispatch per query)
            return np.stack([self.search(q, k) for q in Q])
        import torch

        kk = min(max(k, 1), self._live)
        COUNTERS.searches += len(Q)
        _metrics().inc("vector_search_total", len(Q))
        if self._jit_ivf_wins(len(Q)):
            COUNTERS.path_jit_ivf += len(Q)
            return self._ivf_search_batch(Q, kk)
        COUNTERS.path_jit_brute += len(Q)
        fn = _jit_brute_batch(self.metric, int(kk))
        # pad the batch to a pow2 width, as the reference does for its jit
        # signatures (padded rows are scored and discarded — per-row
        # top-k, so real rows are unaffected)
        m = len(Q)
        mp = max(1, 1 << (m - 1).bit_length())
        Qp = Q if mp == m else np.vstack(
            [Q, np.zeros((mp - m, Q.shape[1]), np.float32)]
        )
        dd, idx = fn(
            self._device["vecs"],
            self._device["sqnorm"],
            self._device["valid"],
            torch.tensor(Qp, device=self.device),
        )
        return self._uids_np[idx.cpu().numpy()[:m]]

    def search_one(self, q, k: int) -> np.ndarray:
        """Plain (unfiltered) top-k for ONE query — exactly row 0 of
        `search_batch([q], k)`. The solo form of the coalesced
        similar_to dispatch: solo and coalesced answers are
        byte-identical by construction because every batch row is
        scored independently by the same kernels."""
        return self.search_batch(
            np.asarray(q, np.float32).reshape(1, -1), k
        )[0]

    def search_with_uid(self, uid: int, k: int, **kw) -> np.ndarray:
        with self._lock:
            # row lookup + vector read must be one atomic step: compaction
            # renumbers rows and swaps the array between the two
            row = self._rows.get(int(uid))
            q = None if row is None else self._vecs[row].copy()
        if q is None:
            return _EMPTY_U64
        res = self.search(q, k + 1, **kw)
        return np.asarray(
            [u for u in res if int(u) != int(uid)][:k], np.uint64
        )

    # -- quantized engine ------------------------------------------------------

    def _quant_view(self) -> dict:
        """Sync the quantized sidecars + incremental IVF to the current
        rows and return a scan snapshot. Taken under the index lock;
        the native kernel calls run lock-free on the snapshot (arrays
        are append-only and replaced — never shrunk — so a snapshot
        stays valid across concurrent mutations)."""
        with self._lock:
            self._compact_locked()
            self._quant_sync_locked()
            self._qivf_sync_locked()
            q = self._q
            n = self._n
            ivf = dict(self._qivf) if self._qivf is not None else None
            if ivf is not None:
                # slot-level copy: _assign_rows_locked mutates the live
                # list's slots in place (cells[c] = concatenate(...))
                # with row ids past this snapshot's n; the arrays
                # themselves are replaced, never mutated, so copying
                # the outer list is enough to freeze the snapshot
                ivf["cells"] = list(ivf["cells"])
            return {
                "vecs": self._vecs[:n],
                "codes": q["codes"][:n],
                "scales": q["scales"][:n],
                "offsets": q["offsets"][:n],
                "csums": q["csums"][:n],
                "sqnorms": q["sqnorms"][:n],
                "valid": self._valid[:n],
                "uid_of": self._uid_of[:n],
                "n": n,
                "live": self._live,
                "ivf": ivf,
            }

    def _compact_locked(self):
        """Reclaim tombstoned rows: rebuild the host store on the live
        set once dead rows pass a quarter of it (the same garbage bound
        the IVF repartition uses). Update-heavy workloads tombstone +
        append on every write, so without this the float corpus, int8
        sidecars, and brute-scan cost all grow with total writes, not
        live size. New arrays are built and swapped — concurrent
        searchers keep scanning the old buffers their snapshot
        captured (the bulk_load replacement argument)."""
        dead = self._n - self._live
        if dead <= max(64, self._live // 4):
            return
        live_idx = np.flatnonzero(self._valid[: self._n])
        n = int(live_idx.size)
        self._vecs = np.ascontiguousarray(self._vecs[live_idx])
        self._uid_of = self._uid_of[live_idx].copy()
        self._valid = np.ones((n,), np.uint8)
        self._rows = {int(u): i for i, u in enumerate(self._uid_of)}
        self._n = n
        self._dirty = True
        q = self._q
        if q is not None:
            # live_idx ascends, so already-quantized rows stay a
            # prefix. Gather ONLY that prefix: the sidecar arrays' cap
            # can lag _vecs between syncs, and rows past nq hold no
            # codes yet anyway — the next _quant_sync_locked grows the
            # arrays back to cap and quantizes the tail
            nq = int(np.searchsorted(live_idx, q["nq"]))
            keep = live_idx[:nq]
            for name in ("codes", "scales", "offsets", "csums",
                         "sqnorms"):
                q[name] = np.ascontiguousarray(q[name][keep])
            q["nq"] = nq
        ivf = self._qivf
        if ivf is not None:
            # rows renumbered: cells rebuild on the compacted store
            ivf["cells"] = [
                np.zeros((0,), np.int32) for _ in range(ivf["nlist"])
            ]
            ivf["assigned"] = 0
            ivf["dead"] = 0
            ivf["total_ids"] = 0
            ivf["stamp"] = (-1, -1)
            self.repartition_count += 1

    def _quant_sync_locked(self):
        if self._q is None:
            cap = self._vecs.shape[0]
            d = self._vecs.shape[1]
            self._q = {
                "codes": np.zeros((cap, d), np.int8),
                "scales": np.zeros((cap,), np.float32),
                "offsets": np.zeros((cap,), np.float32),
                "csums": np.zeros((cap,), np.int32),
                "sqnorms": np.zeros((cap,), np.float32),
                "nq": 0,
            }
        q = self._q
        cap = self._vecs.shape[0]
        if q["codes"].shape[0] < cap:
            for name, dt in (
                ("codes", np.int8), ("scales", np.float32),
                ("offsets", np.float32), ("csums", np.int32),
                ("sqnorms", np.float32),
            ):
                old = q[name]
                shape = (cap,) + old.shape[1:]
                grown = np.zeros(shape, dt)
                grown[: old.shape[0]] = old
                q[name] = grown
        # quantize the appended rows: one threaded native pass when
        # available (codes/sidecars bit-identical to the numpy mirror —
        # the 1Mx768 corpus quantizes in seconds instead of the 26s
        # chunked-numpy pass), chunked numpy otherwise
        start = q["nq"]
        if start < self._n:
            from dgraph_tpu_torch import native

            got = (
                native.vec_qi8_quantize(
                    self._vecs[start : self._n], _nthreads()
                )
                if native.NATIVE_AVAILABLE
                else None
            )
            if got is not None:
                codes, scales, offsets, csums, sqnorms = got
                q["codes"][start : self._n] = codes
                q["scales"][start : self._n] = scales
                q["offsets"][start : self._n] = offsets
                q["csums"][start : self._n] = csums
                q["sqnorms"][start : self._n] = sqnorms
                start = self._n
        while start < self._n:
            end = min(self._n, start + 65536)
            V = self._vecs[start:end]
            codes, scales, offsets, csums = _quantize(V)
            q["codes"][start:end] = codes
            q["scales"][start:end] = scales
            q["offsets"][start:end] = offsets
            q["csums"][start:end] = csums
            q["sqnorms"][start:end] = (V * V).sum(
                axis=1, dtype=np.float32
            )
            start = end
        q["nq"] = self._n

    def _qivf_sync_locked(self):
        """Incremental IVF maintenance: build centroids once past the
        threshold, lazily assign appended rows to their 2 nearest cells,
        and repartition only when tombstone garbage passes live/4
        (centroids kept) or the cell imbalance ratio grows past
        VEC_REBUILD_IMBALANCE x its post-build baseline (centroids
        retrained on a sample — kept centroids would reproduce the same
        hot cells)."""
        if self._qivf is None and self._live < self.ivf_threshold:
            # threshold gates BUILDING only: an already-built index must
            # keep assigning appended rows even when live dips below the
            # threshold, or probes would serve while fresh inserts sit
            # in no cell (categorically unreachable, not a recall miss)
            return
        rng = np.random.default_rng(0)
        if self._qivf is None:
            t0 = time.perf_counter()
            knob = int(config.get("VEC_NLIST"))
            nlist = self.nlist or knob or int(
                max(16, math.sqrt(self._live) * 2)
            )
            nlist = max(1, min(nlist, self._live))
            live_idx = np.flatnonzero(self._valid[: self._n])
            cents = _train_centroids(self._vecs[live_idx], nlist, rng)
            # default probe width: ~1% of cells. Top-2 multi-assignment
            # already doubles coverage, and the nprobe sweep on the
            # 1Mx768 bench corpus holds recall@10 >= 0.99 down to
            # nprobe=8 while qps scales ~linearly with the probed pool —
            # the old nlist/16 left an 8x serve speedup on the table
            pknob = int(config.get("VEC_NPROBE"))
            nprobe = self.nprobe or pknob or max(8, nlist // 128)
            self._qivf = {
                "cents": cents,
                "csq": (cents * cents).sum(axis=1),
                "cells": [
                    np.zeros((0,), np.int32) for _ in range(len(cents))
                ],
                "nlist": len(cents),
                "nprobe": int(min(nprobe, len(cents))),
                "assigned": 0,
                "dead": 0,
                "total_ids": 0,
                "stamp": (-1, -1),
            }
            self.build_count += 1
            self._assign_rows_locked(0, self._n, rng)
            dt = time.perf_counter() - t0
            _metrics().set_gauge("vector_index_build_seconds", dt)
            self._qivf["stamp"] = (self._n, self._live)
            self._qivf["base_ratio"] = self._cell_ratio_locked()
            return
        ivf = self._qivf
        if ivf["assigned"] < self._n:
            self._assign_rows_locked(ivf["assigned"], self._n, rng)
        if ivf["stamp"] == (self._n, self._live):
            return
        ivf["stamp"] = (self._n, self._live)
        # deferred repartition triggers (checked only after mutations).
        # Imbalance is relative to the post-build baseline: clustered
        # corpora are imbalanced at build time by nature, and reassigning
        # under unchanged centroids would reproduce that exactly — only
        # GROWTH (mutation skew piling inserts into hot cells) warrants
        # work, and fixing it needs fresh centroids.
        thr = max(1.5, float(config.get("VEC_REBUILD_IMBALANCE")))
        garbage = ivf["dead"] > max(64, self._live // 4)
        imbalanced = self._cell_ratio_locked() > thr * max(
            1.0, ivf.get("base_ratio", 1.0)
        )
        if garbage or imbalanced:
            if imbalanced:
                live_idx = np.flatnonzero(self._valid[: self._n])
                ivf["cents"] = _train_centroids(
                    self._vecs[live_idx], ivf["nlist"], rng
                )
                ivf["csq"] = (ivf["cents"] * ivf["cents"]).sum(axis=1)
                ivf["nlist"] = len(ivf["cents"])
            ivf["cells"] = [
                np.zeros((0,), np.int32) for _ in range(ivf["nlist"])
            ]
            ivf["assigned"] = 0
            ivf["dead"] = 0
            ivf["total_ids"] = 0
            self.repartition_count += 1
            self._assign_rows_locked(0, self._n, rng)
            ivf["base_ratio"] = self._cell_ratio_locked()

    def _cell_ratio_locked(self) -> float:
        """Max/avg live cell length — the probe-cost skew measure."""
        ivf = self._qivf
        lens = np.fromiter(
            (len(c) for c in ivf["cells"]), np.int64, ivf["nlist"]
        )
        avg = max(1.0, float(lens.sum()) / max(ivf["nlist"], 1))
        return float(lens.max(initial=0)) / avg

    def _assign_rows_locked(self, start: int, end: int, rng):
        ivf = self._qivf
        rows = start + np.flatnonzero(self._valid[start:end]).astype(
            np.int64
        )
        if rows.size == 0:
            ivf["assigned"] = end
            return
        d = self._vecs.shape[1]
        a2 = None
        if rows.size * ivf["nlist"] * d > _ASSIGN_NATIVE_MIN_MACS:
            a2 = self._assign_top2_qi8_locked(rows, rng)
        if a2 is None:
            a2 = _assign_top2(self._vecs[rows], ivf["cents"], rng)
        cells = ivf["cells"]
        pc = a2.reshape(-1)
        pr = np.repeat(rows, 2).astype(np.int32)
        order = np.argsort(pc, kind="stable")
        pc = pc[order]
        pr = pr[order]
        starts = np.flatnonzero(np.r_[True, pc[1:] != pc[:-1]])
        bounds = np.r_[starts, len(pc)]
        for si in range(len(starts)):
            c = int(pc[starts[si]])
            seg = pr[bounds[si] : bounds[si + 1]]
            cells[c] = (
                np.concatenate([cells[c], seg]) if cells[c].size
                else seg.copy()
            )
        # only mark the range assigned once the cell appends landed: an
        # exception above (e.g. MemoryError in the big fancy-index
        # gathers) must leave these rows retryable on the next sync,
        # not silently absent from every future IVF probe
        ivf["assigned"] = end
        ivf["total_ids"] += int(pr.size)

    def _assign_top2_qi8_locked(self, rows: np.ndarray, rng):
        """Top-2 centroid assignment on the int8 sidecars: the same
        coarse-to-fine shape as _assign_top2 (cluster the centroids into
        ~sqrt(nlist) groups, rank each row only against its nearest
        groups' members) but with both ranking passes in the threaded
        native kernel over the ALREADY-quantized row codes — at 1Mx768/
        2000 cells this was the 44s that dominated the IVF build. Cell
        choice is approximate in the same sense the coarse pass already
        was (correctness lives in the probe + rerank); determinism is
        preserved (fixed rng, deterministic kernel), so incremental
        assignment of a row equals its fresh-build assignment whenever
        both take this path. Returns (m, 2) int32, or None when the
        native lib is missing (caller falls back to numpy)."""
        from dgraph_tpu_torch import native

        if not native.NATIVE_AVAILABLE:
            return None
        ivf = self._qivf
        cents = ivf["cents"]
        nlist = ivf["nlist"]
        if nlist < 2:
            return None
        q = self._q
        d = cents.shape[1]
        ccodes, cscales, coffsets, ccsums = _quantize(cents)
        csq = np.ascontiguousarray(ivf["csq"], np.float32)
        cvalid = np.ones((nlist,), np.uint8)
        # coarse groups over the centroids (same construction + rng
        # stream as _assign_top2, so both paths see the same geometry)
        G = max(8, int(round(math.sqrt(nlist))))
        coarse = _train_centroids(cents, G, rng)
        gcodes, gscales, goffsets, gcsums = _quantize(coarse)
        gsq = (coarse * coarse).sum(axis=1, dtype=np.float32)
        gvalid = np.ones((len(coarse),), np.uint8)
        # per-group candidate list: the cap nearest centroids to the
        # group's coarse center (a distance ball, NOT the group-member
        # union — member unions on clustered corpora are wildly
        # imbalanced, and truncating them drops exactly the boundary
        # cells that edge rows need, piling those rows into hot central
        # cells: max/avg cell hit 36x on the 1Mx768 bench). cap trades
        # assignment MACs against layout quality; ~1/6 of all cells
        # keeps the layout within a few percent of the exact one.
        cap = int(min(nlist, max(64, math.ceil(nlist / 4))))
        gd2 = (
            (coarse * coarse).sum(axis=1)[:, None]
            - 2.0 * (coarse @ cents.T)
            + csq[None, :]
        )
        near = np.argsort(gd2, axis=1, kind="stable")[:, :cap]
        cat = np.ascontiguousarray(near, np.int32).reshape(-1)
        offs = (np.arange(len(coarse) + 1, dtype=np.int64)) * cap
        # row-side "queries" are the corpus rows' own sidecars (euclidean
        # geometry regardless of the search metric — cell layout is a
        # spatial partition, exactly as in the numpy path)
        m = int(rows.size)
        lo, hi = int(rows[0]), int(rows[-1]) + 1
        if m == hi - lo:  # contiguous (the build / append case): views
            rc = q["codes"][lo:hi]
            rs, ro = q["scales"][lo:hi], q["offsets"][lo:hi]
            rcs, rsq = q["csums"][lo:hi], q["sqnorms"][lo:hi]
        else:
            rc = q["codes"][rows]
            rs, ro = q["scales"][rows], q["offsets"][rows]
            rcs, rsq = q["csums"][rows], q["sqnorms"][rows]
        nt = _nthreads()
        # pass 1: nearest coarse group per row (k=1 over all G groups)
        gfull = np.arange(len(coarse), dtype=np.int32)
        zb = np.zeros((m,), np.int64)
        ze = np.full((m,), len(coarse), np.int64)
        got = native.vec_qi8_topk_lists(
            gcodes, gscales, goffsets, gcsums, gsq, gvalid,
            gfull, zb, ze, rc, rs, ro, rcs, rsq, 0, 1, nt,
        )
        if got is None:
            return None
        xg = got[0][:, 0]
        # pass 2: top-2 cells among the row's group candidate list
        # (slices alias the shared per-group lists — no per-row copies).
        # Queries run in group order so one group's candidate slab
        # (cap x d codes) stays cache-resident across its whole run —
        # unsorted, every query faults the slab back in and the kernel
        # drops ~2x throughput at 1Mx768
        order = np.argsort(xg, kind="stable")
        got = native.vec_qi8_topk_lists(
            ccodes, cscales, coffsets, ccsums, csq, cvalid,
            cat, offs[xg[order]], offs[xg[order] + 1],
            np.ascontiguousarray(rc[order]), rs[order], ro[order],
            rcs[order], rsq[order], 0, 2, nt,
        )
        if got is None:
            return None
        a2 = np.empty((m, 2), np.int64)
        a2[order] = got[0]
        return a2.astype(np.int32)

    def _quant_scan(self, view, qc, qs, qo, qcs, qstat, pool, rows=None):
        """One quantized top-pool scan (full corpus or candidate rows),
        native when available, numpy mirror otherwise. Returns (rows,
        approx dists) trimmed of padding."""
        from dgraph_tpu_torch import native

        t0 = time.perf_counter_ns()
        got = None
        if native.NATIVE_AVAILABLE:
            if rows is None:
                idx, dist, _nv = native.vec_qi8_topk(
                    view["codes"], view["scales"], view["offsets"],
                    view["csums"], view["sqnorms"], view["valid"],
                    qc.reshape(1, -1),
                    np.asarray([qs], np.float32),
                    np.asarray([qo], np.float32),
                    np.asarray([qcs], np.int32),
                    np.asarray([qstat], np.float32),
                    _METRIC_ID[self.metric], int(pool),
                )
                got = (idx[0], dist[0])
            else:
                idx, dist, _w = native.vec_qi8_topk_idx(
                    view["codes"], view["scales"], view["offsets"],
                    view["csums"], view["sqnorms"], view["valid"],
                    rows, qc, float(qs), float(qo), int(qcs),
                    float(qstat), _METRIC_ID[self.metric], int(pool),
                )
                got = (idx, dist)
        if got is None:
            got = _qi8_scan_py(
                view["codes"], view["scales"], view["offsets"],
                view["csums"], view["sqnorms"], view["valid"],
                qc, qs, qo, qcs, qstat, self.metric, int(pool),
                rows=rows,
            )
        COUNTERS.scan_ns += time.perf_counter_ns() - t0
        COUNTERS.scan_rows += int(
            view["live"] if rows is None else len(rows)
        )
        idx, dist = got
        ok = idx >= 0
        return idx[ok], dist[ok]

    def _rerank(self, rows: np.ndarray, q: np.ndarray, view: dict):
        """Exact float32 re-score of the candidate pool; ascending
        (dist, row) — quantization error cannot survive into the final
        ordering. Reads the float corpus from the snapshot (not live
        self._vecs): bulk_load REPLACES the arrays, so a concurrent
        search's row ids are only valid against the buffers its own
        snapshot captured."""
        t0 = time.perf_counter_ns()
        V = view["vecs"][rows]
        dot = V @ q
        sq = view["sqnorms"][rows]
        if self.metric == "euclidean":
            d = sq - np.float32(2.0) * dot + np.float32((q * q).sum())
        elif self.metric == "cosine":
            qn = np.float32(math.sqrt(float((q * q).sum())))
            d = np.float32(1.0) - dot / np.maximum(
                np.sqrt(sq) * qn, np.float32(1e-12)
            )
        else:
            d = -dot
        order = np.lexsort((rows, d))
        COUNTERS.rerank_ns += time.perf_counter_ns() - t0
        COUNTERS.rerank_pool += int(rows.size)
        _metrics().inc("vector_rerank_pool_total", int(rows.size))
        return rows[order], d[order].astype(np.float32)

    def _quant_probe_ids(self, ivf: dict, q: np.ndarray, nprobe=None):
        """Top-nprobe cells by centroid distance; returns (cells picked,
        deduped sorted candidate row ids)."""
        nlist = ivf["nlist"]
        cd = ivf["csq"] - 2.0 * (ivf["cents"] @ q)
        np_ = min(nprobe if nprobe is not None else ivf["nprobe"], nlist)
        if np_ < nlist:
            sel = np.argpartition(cd, np_ - 1)[:np_]
        else:
            sel = np.arange(nlist)
        parts = [ivf["cells"][c] for c in sel if ivf["cells"][c].size]
        COUNTERS.probe_cells += int(len(sel))
        _metrics().inc("vector_probe_cells_total", int(len(sel)))
        if not parts:
            return sel, np.zeros((0,), np.int32)
        # unique: dedups multi-assignment AND sorts ascending — the scan
        # then walks the code matrix in row order (locality + the
        # deterministic tie-break order the kernels pin)
        return sel, np.unique(np.concatenate(parts))

    def _quant_ivf_wins(self, nq: int, ivf: dict, live: int) -> bool:
        est = int(
            ivf["nprobe"] * ivf["total_ids"] / max(ivf["nlist"], 1)
        )
        return self._ivf_pick(nq, est, max(live, 1), quant=True)

    def _quant_topk_one(self, view, q, pool, probe_boost=1):
        """(rows, exact dists, full) for one query: quantized scan (IVF
        probe or full) -> float32 rerank. `probe_boost` scales the
        probed cell count — the widening loop raises it in lockstep
        with the candidate pool, the quant analog of the jitted path's
        pool-scaled _probe_plan (a fixed probe would rescan the same
        candidate set every retry and could never reach allowed uids
        outside the top-nprobe cells). `full` reports whether the scan
        covered every live row (brute / all-cells probe), which is what
        lets the caller's exhaustion test terminate correctly."""
        qc, qs, qo, qcs, qstat = _quantize_queries(
            q.reshape(1, -1), self.metric
        )
        ivf = view["ivf"]
        if ivf is not None:
            nprobe_eff = int(
                min(ivf["nprobe"] * probe_boost, ivf["nlist"])
            )
            est = int(
                nprobe_eff * ivf["total_ids"] / max(ivf["nlist"], 1)
            )
            if nprobe_eff < ivf["nlist"] and self._ivf_pick(
                1, est, max(view["live"], 1), quant=True
            ):
                COUNTERS.path_quant_ivf += 1
                _sel, ids = self._quant_probe_ids(ivf, q, nprobe_eff)
                rows, _ = self._quant_scan(
                    view, qc[0], qs[0], qo[0], qcs[0], qstat[0], pool,
                    rows=ids,
                )
                if rows.size == 0:
                    return (
                        rows.astype(np.int64),
                        np.zeros((0,), np.float32),
                        False,
                    )
                r, dd = self._rerank(rows, q, view)
                return r, dd, False
        COUNTERS.path_quant_brute += 1
        rows, _ = self._quant_scan(
            view, qc[0], qs[0], qo[0], qcs[0], qstat[0], pool
        )
        if rows.size == 0:
            return rows.astype(np.int64), np.zeros((0,), np.float32), True
        r, dd = self._rerank(rows, q, view)
        return r, dd, True

    def _quant_search_filtered(self, q, kk, pool, threshold, allowed_set):
        """The widening single-query search loop on the quantized
        engine (ef / distance_threshold / allowed semantics identical
        to the jitted path — distances here are exact float32)."""
        rer = max(1, int(config.get("VEC_RERANK")))
        view = self._quant_view()
        COUNTERS.searches += 1
        _metrics().inc("vector_search_total")
        boost = 1
        while True:
            p = int(min(max(pool, kk) * rer, view["live"]))
            rows, dists, full = self._quant_topk_one(
                view, q, max(p, kk), probe_boost=boost
            )
            cand_uids = view["uid_of"][rows]
            out = self._filter_candidates(
                cand_uids, dists, kk, threshold, allowed_set
            )
            # exhausted only once a FULL-coverage scan kept a pool as
            # wide as the live set — a partial IVF probe can miss
            # allowed uids that live outside its cells no matter how
            # wide the kept pool is
            exhausted = full and (
                len(rows) >= view["live"] or pool >= view["live"]
            )
            if len(out) == kk or exhausted or allowed_set is None:
                return np.asarray(out, np.uint64)
            pool = min(pool * 4, view["live"])
            boost *= 4

    def _emit_topk_row(self, out, i, rows, q, view, kk):
        """Shared tail of every batch path: drop kernel padding, rerank
        exactly in float32, truncate to k, write uids — one
        implementation so the native and fallback paths cannot diverge
        on the emit contract (the coalescing byte-identity depends on
        it)."""
        rows = rows[rows >= 0]
        if rows.size == 0:
            return
        rows, _d = self._rerank(rows, q, view)
        rows = rows[:kk]
        out[i, : rows.size] = view["uid_of"][rows]

    def _quant_search_batch(self, Q: np.ndarray, k: int) -> np.ndarray:
        view = self._quant_view()
        kk = min(max(k, 1), view["live"])
        rer = max(1, int(config.get("VEC_RERANK")))
        pool = int(min(max(kk * rer, kk), view["live"]))
        qc, qs, qo, qcs, qstat = _quantize_queries(Q, self.metric)
        out = np.zeros((len(Q), kk), np.uint64)
        COUNTERS.searches += len(Q)
        _metrics().inc("vector_search_total", len(Q))
        ivf = view["ivf"]
        if ivf is not None and self._quant_ivf_wins(
            len(Q), ivf, view["live"]
        ):
            from dgraph_tpu_torch import native

            COUNTERS.path_quant_ivf += len(Q)
            # probes stay per-query (same matvec + argpartition + unique
            # as the solo path — bit-identical candidate sets); the scans
            # fuse into ONE threaded kernel dispatch over the CSR form
            ids_list = [
                self._quant_probe_ids(ivf, Q[i])[1] for i in range(len(Q))
            ]
            if native.NATIVE_AVAILABLE:
                lens = np.fromiter(
                    (c.size for c in ids_list), np.int64, len(Q)
                )
                ends = np.cumsum(lens)
                begs = ends - lens
                total = int(ends[-1]) if len(Q) else 0
                cat = (
                    np.concatenate(ids_list) if total
                    else np.zeros((0,), np.int32)
                )
                t0 = time.perf_counter_ns()
                idx, _dist, _sc = native.vec_qi8_topk_lists(
                    view["codes"], view["scales"], view["offsets"],
                    view["csums"], view["sqnorms"], view["valid"],
                    cat, begs, ends, qc, qs, qo, qcs, qstat,
                    _METRIC_ID[self.metric], pool, _nthreads(),
                )
                COUNTERS.scan_ns += time.perf_counter_ns() - t0
                COUNTERS.scan_rows += total
                for i in range(len(Q)):
                    self._emit_topk_row(out, i, idx[i], Q[i], view, kk)
                return out
            for i in range(len(Q)):
                rows, _ = self._quant_scan(
                    view, qc[i], qs[i], qo[i], qcs[i], qstat[i], pool,
                    rows=ids_list[i],
                )
                self._emit_topk_row(out, i, rows, Q[i], view, kk)
            return out
        COUNTERS.path_quant_brute += len(Q)
        from dgraph_tpu_torch import native

        t0 = time.perf_counter_ns()
        if native.NATIVE_AVAILABLE:
            idx, _dist, _nv = native.vec_qi8_topk(
                view["codes"], view["scales"], view["offsets"],
                view["csums"], view["sqnorms"], view["valid"],
                qc, qs, qo, qcs, qstat,
                _METRIC_ID[self.metric], pool,
            )
        else:
            idx = np.empty((len(Q), pool), np.int64)
            for i in range(len(Q)):
                idx[i], _d = _qi8_scan_py(
                    view["codes"], view["scales"], view["offsets"],
                    view["csums"], view["sqnorms"], view["valid"],
                    qc[i], qs[i], qo[i], qcs[i], qstat[i],
                    self.metric, pool,
                )
        COUNTERS.scan_ns += time.perf_counter_ns() - t0
        COUNTERS.scan_rows += int(view["live"]) * len(Q)
        for i in range(len(Q)):
            self._emit_topk_row(out, i, idx[i], Q[i], view, kk)
        return out

    # -- IVF (jitted slab path) ------------------------------------------------

    def _train_ivf(self, mat: np.ndarray):
        """Slab-layout IVF for the jitted device path. Centroids come
        from the shared sampled mini-batch k-means (bounded cost at any
        corpus size — the full-sample Lloyd it replaced took 255s at
        1Mx768); assignment is the shared top-2 (coarse-to-fine above
        the exact-assignment budget). Centroids and assignment stay host
        numpy, as in the reference; the slab layout is uploaded to the
        index's device."""
        import torch

        t0 = time.perf_counter()
        n, d = mat.shape
        knob = int(config.get("VEC_NLIST"))
        nlist = self.nlist or knob or int(max(16, math.sqrt(n) * 2))
        nlist = max(1, min(nlist, n))
        rng = np.random.default_rng(0)
        c_np = _train_centroids(mat, nlist, rng)
        nlist = len(c_np)
        self.build_count += 1

        # multi-assignment: each vector lands in its 2 nearest cells —
        # big recall win for weakly-clustered data at 2x cell memory
        # (the reference's HNSW achieves the same via graph redundancy)
        t2 = _assign_top2(mat, c_np, rng)
        rows_rep = np.repeat(np.arange(n), 2)
        cells_rep = t2.reshape(-1)

        order = np.argsort(cells_rep, kind="stable")
        sorted_cells = cells_rep[order]
        flat_rows_cm = rows_rep[order]  # cell-major row ids
        starts = np.searchsorted(sorted_cells, np.arange(nlist))
        ends = np.searchsorted(sorted_cells, np.arange(nlist), side="right")
        lens = (ends - starts).astype(np.int64)

        # slab layout: pad each cell to a multiple of _SLAB so every slab
        # belongs to exactly one cell; top-M slab probing is then a
        # static-shape device op (_jit_ivf)
        S = _SLAB
        slabs_per_cell = np.maximum(1, -(-lens // S))
        n_slabs = int(slabs_per_cell.sum())
        flat_rows = np.full((n_slabs * S,), -1, np.int64)
        slab_cell = np.zeros((n_slabs,), np.int32)
        off = 0
        for ci in range(nlist):
            rws = flat_rows_cm[starts[ci] : ends[ci]]
            nsl = int(slabs_per_cell[ci])
            flat_rows[off * S : off * S + len(rws)] = rws
            slab_cell[off : off + nsl] = ci
            off += nsl
        fr2 = flat_rows.reshape(n_slabs, S)
        fv = np.zeros((n_slabs * S, d), np.float32)
        sel = flat_rows >= 0
        fv[sel] = mat[flat_rows[sel]]

        if self.nprobe is None:
            # embedding corpora cluster (the index contract); a handful of
            # nearest cells holds the true neighbors, and multi-assignment
            # covers boundary queries. ef/pool widening scales the probe
            # (the HNSW ef analog) when callers need more.
            pknob = int(config.get("VEC_NPROBE"))
            self.nprobe = pknob if pknob > 0 else max(8, nlist // 32)
        # static slab budget ~ nprobe cells' worth of average slabs
        avg_slabs = max(1.0, n_slabs / nlist)
        m_slabs = int(min(n_slabs, max(8, round(self.nprobe * avg_slabs))))
        fsq = (fv * fv).sum(axis=1).astype(np.float32)
        dev = self.device
        self._ivf = {
            "centroids": c_np,
            "cell_lens": lens.astype(np.int32),
            "m_slabs": m_slabs,
            "n_slabs": n_slabs,
            "dev": {
                "cents": torch.from_numpy(c_np).to(dev),
                "csq": torch.from_numpy((c_np * c_np).sum(axis=1)).to(dev),
                "slab_cell": torch.from_numpy(slab_cell).to(dev),
                "flat_vecs": torch.from_numpy(fv.reshape(n_slabs, S, d)).to(dev),
                "flat_sq": torch.from_numpy(fsq.reshape(n_slabs, S)).to(dev),
                "flat_rows": torch.from_numpy(fr2.astype(np.int32)).to(dev),
            },
        }
        _metrics().set_gauge(
            "vector_index_build_seconds", time.perf_counter() - t0
        )

    def _ivf_search(self, q: np.ndarray, pool: int):
        """One probe on the device: top-M slabs by centroid distance, slab
        distances, top-pool (see _ivf_probe). Host only dedupes
        multi-assigned rows.

        A wider candidate pool (ef / filtered search retries) also widens
        the slab probe by pow2 factors — the reference's bounded jit
        signatures, and the recall lever callers expect from raising ef."""
        import torch

        ivf = self._ivf
        m, npool = _probe_plan(ivf, pool)
        fn = _jit_ivf(self.metric, int(m), npool)
        dev = ivf["dev"]
        dd, rows = fn(
            dev["cents"],
            dev["csq"],
            dev["slab_cell"],
            dev["flat_vecs"],
            dev["flat_sq"],
            dev["flat_rows"],
            torch.tensor(np.asarray(q, np.float32), device=self.device),
        )
        rows = rows.cpu().numpy()
        dd = dd.cpu().numpy()
        ok = rows >= 0
        rows, dd = rows[ok], dd[ok]
        first = _dedup_first(rows)
        rows, dd = rows[first], dd[first]
        k = min(pool, rows.size)
        uids = self._uids_np[rows[:k]]
        return uids, dd[:k]

    def _ivf_search_batch(self, Q: np.ndarray, k: int) -> np.ndarray:
        """Batched IVF (see _jit_ivf_batch). Candidate pool is 4x k (the
        same slack search() applies for filtered pools); rows that end up
        with fewer than k unique survivors pad with uid 0.

        The slab scan reads the probed slabs in place and holds only the
        (nq, m_slabs * _SLAB) distances, so the batch is not chunked (the
        reference's vmapped gather held (m_slabs * _SLAB, d) floats per
        query, ~190MB at 1Mx768)."""
        import torch

        ivf = self._ivf
        m, npool = _probe_plan(ivf, 4 * k)
        fn = _jit_ivf_batch(self.metric, int(m), npool)
        dev = ivf["dev"]
        _, rows = fn(
            dev["cents"],
            dev["csq"],
            dev["slab_cell"],
            dev["flat_vecs"],
            dev["flat_sq"],
            dev["flat_rows"],
            torch.tensor(np.asarray(Q, np.float32), device=self.device),
        )
        rows = rows.cpu().numpy()
        out = np.zeros((len(Q), k), np.uint64)
        for i in range(len(Q)):
            r = rows[i]
            r = r[r >= 0]
            r = r[_dedup_first(r)][:k]
            out[i, : len(r)] = self._uids_np[r]
        return out


def _distances(V, sqnorm, q, metric):
    """Metric distances of q (d,) to every row of V, plain torch: row 0
    of the batch form. Euclidean is squared (same ordering, cheaper;
    sqrt applied nowhere because the reference compares distances
    relatively too)."""
    return _distances_batch(V, sqnorm, q[None, :], metric)[0]


def _distances_batch(V, sqnorm, Q, metric):
    """(nq, n) metric distances of Q (nq, d) to V (n, d), plain torch:
    the GEMM, then KV1's epilogue in its plain form."""
    from dgraph_tpu_torch.ops import vector_topk

    return vector_topk.epilogue_plain(
        vector_topk.f32_matmul(Q, V.T), sqnorm,
        vector_topk.query_stat(Q, metric), metric,
    )


def _in_sorted(arr: np.ndarray, v) -> bool:
    i = np.searchsorted(arr, v)
    return i < arr.size and arr[i] == v
