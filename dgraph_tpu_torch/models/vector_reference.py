"""The plain reference of a vector index's answers: the exact top-k of
each query over every row, in plain PyTorch.

Independent of the index it judges (`models/vector.py`): it imports no
kernel of this package, and its scoring GEMM runs in float32 with TF32
off, whatever the caller's flags. Distances follow the index's metrics
(tok/hnsw/helper.go): euclidean (squared), cosine (1 - cosine
similarity) and dotproduct (the negated dot), smaller = closer. Ties
keep the lower row first.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 16


def distances(V: torch.Tensor, Q: torch.Tensor, metric: str) -> torch.Tensor:
    """(nq, n) distances of the queries Q (nq, d) to the rows V (n, d)."""
    dot = Q @ V.T
    if metric == "euclidean":
        return (Q * Q).sum(1)[:, None] - 2.0 * dot + (V * V).sum(1)[None, :]
    if metric == "cosine":
        norms = Q.norm(dim=1)[:, None] * V.norm(dim=1)[None, :]
        return 1.0 - dot / torch.clamp(norms, min=1e-12)
    if metric == "dotproduct":
        return -dot
    raise ValueError(f"unknown metric {metric!r}")


def topk(V, Q, k: int, metric: str, device="cpu"):
    """(rows (nq, k) int64, distances (nq, k) float32): the exact top-k of
    each query over every row of V, ascending by distance, then by row.
    V (n, d) and Q (nq, d) are float32 arrays; the rows are scored in
    blocks of BLOCK_ROWS on `device`."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        Qt = torch.as_tensor(np.ascontiguousarray(Q, np.float32), device=device)
        n, nq = len(V), len(Qt)
        k = min(k, n)
        best_d = torch.empty((nq, 0), dtype=torch.float32, device=device)
        best_i = torch.empty((nq, 0), dtype=torch.int64, device=device)
        for s in range(0, n, BLOCK_ROWS):
            e = min(n, s + BLOCK_ROWS)
            Vt = torch.as_tensor(np.ascontiguousarray(V[s:e], np.float32), device=device)
            d = torch.cat([best_d, distances(Vt, Qt, metric)], dim=1)
            i = torch.cat([best_i, torch.arange(s, e, device=device).expand(nq, -1)], dim=1)
            # stable: among equal distances the earlier column (lower row)
            order = torch.sort(d, dim=1, stable=True).indices[:, :k]
            best_d, best_i = torch.gather(d, 1, order), torch.gather(i, 1, order)
        return best_i.cpu().numpy(), best_d.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def recall(got, want) -> float:
    """Mean recall of the answered ids `got` (a list of id lists) against
    the exact ones `want` (nq, k): the share of each exact top-k found."""
    hits = sum(len(set(int(x) for x in g) & set(int(x) for x in w)) for g, w in zip(got, want))
    return hits / max(1, sum(len(w) for w in want))
