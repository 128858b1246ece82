"""Multi-device sharding: the distributed data plane.

Port of `dgraph_tpu/parallel/mesh.py` to PyTorch. The reference
distributes work via predicate sharding + gRPC fan-out (dgraph/
worker/groups.go tablet routing, conn/ transport); the *control* plane
(membership, tablet map, txn oracle) stays host-side, while the *data*
plane — giant posting lists and vector matrices — shards across devices
along one mesh axis:

  "data"  — row sharding: UID-pack tiles of one giant list ("sequence
            parallel" analog of the reference's multi-part list splits,
            posting/list.go:44 maxListSize), vector DB rows, k-means
            training batch.

One controller, as in the reference: the reference's `Mesh` is a list of
devices that one process drives through `shard_map`; here a `Mesh` is an
ordered tuple of torch devices that one process drives shard by shard.

- A device may repeat: shards on one card are then what the reference
  tests' virtual 8-device CPU mesh is to them.
- `shard` puts each shard's slice of the rows on its device; a
  replicated operand is copied once to each distinct device.
- psum is the sum of the per-shard results, brought to the mesh's first
  device in shard order; all_gather is their concatenation in shard
  order there.
- No `torch.distributed`: the dispatcher and the vector index that call
  the mesh live in one process, and NCCL refuses two ranks on one card.

Per-shard work runs on what the single-device path uses for the same
function: `ops/setops.membership` for membership, KV1
(`ops/vector_topk.topk`, on a finished distance) for the local and the
global top-k, and `torch.matmul` (full float32) with `index_add_` for the
k-means step.

`make_mesh(device="cuda")` takes the visible cards and raises without
one; `make_mesh(device="cpu")` takes `HOST_WIDTH` shards of the host (the
counterpart of `--xla_force_host_platform_device_count`; the tests set
8). `DEVICES`, where set, names the mesh's devices instead (the tests and
`chip_smoke.py` put several shards on one card with it). Neither is a
deployment knob.

The reference's `_resolve_shard_map` and `shard_map_compat` are shims
over jax versions' `shard_map` spellings; they have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dgraph_tpu_torch.device import resolve_device
from dgraph_tpu_torch.ops import setops

# shards of the host in a CPU mesh
HOST_WIDTH = 1
# the mesh's devices, in shard order, in place of the visible ones
DEVICES: Optional[Sequence] = None


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of torch devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharded(tuple):
    """Row tiles of one array in shard order, tile i on the mesh's device
    i (the reference's `device_put(x, NamedSharding(mesh, P("data")))`)."""


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "data", device="cuda"
) -> Mesh:
    dev = resolve_device(device)
    if DEVICES is not None:
        devs = [torch.device(d) for d in DEVICES]
        if any(d.type != dev.type for d in devs):
            raise ValueError(f"mesh devices {devs} are not all {dev.type}")
    elif dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev] * HOST_WIDTH
    n = n_devices or len(devs)
    return Mesh(tuple(devs[:n]), (axis,))


def _tensor(x) -> torch.Tensor:
    """A tensor of x; uint32 uid arrays become int64 holding the u32
    value (the representation of ops/setops.py)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x)


def shard(mesh: Mesh, x) -> Sharded:
    """x's rows split into mesh.size equal tiles, tile i on device i."""
    if isinstance(x, Sharded):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} tiles for a mesh of {mesh.size}")
        return x
    x = _tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal tiles")
    t = n // mesh.size
    return Sharded(
        x[i * t : (i + 1) * t].to(d) for i, d in enumerate(mesh.devices)
    )


class _Replicated:
    """x copied once to each distinct device that asks for it."""

    def __init__(self, x):
        self.x = _tensor(x)
        self.on = {}

    def __getitem__(self, dev: torch.device) -> torch.Tensor:
        if dev not in self.on:
            self.on[dev] = self.x.to(dev)
        return self.on[dev]


def _psum(mesh: Mesh, parts):
    out = parts[0].to(mesh.devices[0])
    for p in parts[1:]:
        out = out + p.to(mesh.devices[0])
    return out


def _all_gather(mesh: Mesh, parts):
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _local_len(length: int, i: int, tile_n: int) -> int:
    """Shard i's validity window: index < length - start, clipped."""
    return int(np.clip(length - i * tile_n, 0, tile_n))


# ---------------------------------------------------------------------------
# Distributed membership/intersect: a sharded by rows, b replicated.
# The giant-list analog of multi-part posting lists: each device holds a
# contiguous tile of `a`, checks membership against (replicated) `b`.
# ---------------------------------------------------------------------------


def sharded_membership(mesh: Mesh, a, la, b, lb) -> torch.Tensor:
    """mask over row-sharded `a` (padded multiple of the mesh size),
    gathered on the mesh's first device."""
    tiles = shard(mesh, a)
    b_on = _Replicated(b)
    n = tiles[0].shape[0]
    parts = [
        setops.membership(t, _local_len(int(la), i, n), b_on[t.device], int(lb))
        for i, t in enumerate(tiles)
    ]
    return _all_gather(mesh, parts)


def sharded_rows_membership(mesh: Mesh, A, LA, b, lb) -> torch.Tensor:
    """Membership of a replicated row batch in a ROW-SHARDED big list.

    A: (n, pa) replicated padded sorted u32 rows; LA: (n,) lengths;
    b: row-sharded padded sorted u32 (multiple of mesh size); lb: total
    valid length. Returns (n, pa) bool mask — element of A present in b.

    This is the query-side face of multi-part posting lists: each device
    holds a tile of the giant list (one or more parts), checks the whole
    level's rows against its tile, and the masks OR-reduce (psum > 0).
    Ref worker/task.go fan-out replaced by one collective."""
    tiles = shard(mesh, b)
    A_on, LA_on = _Replicated(A), _Replicated(LA)
    tile_n = tiles[0].shape[0]
    parts = [
        setops.membership(
            A_on[t.device], LA_on[t.device], t, _local_len(int(lb), i, tile_n)
        ).to(torch.int32)
        for i, t in enumerate(tiles)
    ]
    return _psum(mesh, parts) > 0


def sharded_intersect_count(mesh: Mesh, a, la, b, lb) -> torch.Tensor:
    """Total intersection size of a row-sharded list vs replicated list
    (psum over the mesh)."""
    tiles = shard(mesh, a)
    b_on = _Replicated(b)
    n = tiles[0].shape[0]
    parts = [
        setops.membership(
            t, _local_len(int(la), i, n), b_on[t.device], int(lb)
        ).sum(dtype=torch.int32)
        for i, t in enumerate(tiles)
    ]
    return _psum(mesh, parts)


# ---------------------------------------------------------------------------
# Distributed vector search: V row-sharded, query replicated.
# Local top-k per shard -> all_gather -> global top-k. ("TP" over DB rows.)
# ---------------------------------------------------------------------------


def sharded_topk(mesh: Mesh, V, valid, q, k: int):
    """Returns (global top-k squared-euclidean distances, global row ids)
    on the mesh's first device, in `lax.top_k`'s order: ascending, ties
    to the lower flat index, the flat order shard-major. Each shard ranks
    its finished distances with KV1 (metric "distance"), invalid rows at
    +inf; KV1 ranks the gathered candidates again."""
    from dgraph_tpu_torch.ops import vector_topk

    V_tiles, valid_tiles = shard(mesh, V), shard(mesh, valid)
    q_on = _Replicated(q)
    rows = V_tiles[0].shape[0]
    kk = min(k, rows)
    dists, ids = [], []
    for i, (Vt, vt) in enumerate(zip(V_tiles, valid_tiles)):
        d2 = ((Vt - q_on[Vt.device][None, :]) ** 2).sum(dim=1)
        d, idx = vector_topk.topk(d2[None, :], kk, "distance", valid=vt)
        dists.append(d[0])
        ids.append(idx[0] + i * rows)
    flat_d, flat_i = _all_gather(mesh, dists), _all_gather(mesh, ids)
    gd, sel = vector_topk.topk(flat_d[None, :], k, "distance")
    return gd[0], flat_i[sel[0].long()]


# ---------------------------------------------------------------------------
# Distributed IVF k-means training: THE training step.
# Data-parallel Lloyd iteration: local assign (matmul), local
# segment-sum (index_add_), psum of (sums, counts), replicated update.
# ---------------------------------------------------------------------------


def sharded_kmeans_step(mesh: Mesh, X, valid, C) -> torch.Tensor:
    """One Lloyd step. X row-sharded (n, d); C replicated (c, d).
    Returns updated replicated centroids."""
    from dgraph_tpu_torch.ops import vector_topk

    X_tiles, valid_tiles = shard(mesh, X), shard(mesh, valid)
    C_on = _Replicated(C)
    nclusters = C_on.x.shape[0]
    sums, cnts = [], []
    for Xt, vt in zip(X_tiles, valid_tiles):
        Ct = C_on[Xt.device]
        xsq = (Xt * Xt).sum(dim=1)
        csq = (Ct * Ct).sum(dim=1)
        d2 = xsq[:, None] - 2.0 * vector_topk.f32_matmul(Xt, Ct.T) + csq[None, :]
        assign = torch.argmin(d2, dim=1)
        w = vt.to(Xt.dtype)
        sums.append(
            Xt.new_zeros((nclusters, Xt.shape[1])).index_add_(
                0, assign, Xt * w[:, None]
            )
        )
        cnts.append(Xt.new_zeros((nclusters,)).index_add_(0, assign, w))
    s, c = _psum(mesh, sums), _psum(mesh, cnts)
    C0 = C_on[mesh.devices[0]]
    return torch.where(
        c[:, None] > 0, s / torch.clamp_min(c, 1.0)[:, None], C0
    )


def sharded_ivf_train(
    mesh: Mesh, X: np.ndarray, nlist: int, iters: int = 10
) -> np.ndarray:
    """Full distributed k-means: shard rows over the mesh, iterate the
    Lloyd step. Returns trained centroids (host numpy)."""
    n, d = X.shape
    ndev = mesh.size
    pad = (-n) % ndev
    Xp = np.concatenate([X, np.zeros((pad, d), X.dtype)]) if pad else X
    valid = np.concatenate([np.ones((n,), bool), np.zeros((pad,), bool)])

    Xd = shard(mesh, np.ascontiguousarray(Xp))
    Vd = shard(mesh, valid)
    rng = np.random.default_rng(0)
    C = torch.from_numpy(
        np.ascontiguousarray(X[rng.choice(n, min(nlist, n), replace=False)])
    ).to(mesh.devices[0])
    for _ in range(iters):
        C = sharded_kmeans_step(mesh, Xd, Vd, C)
    return C.cpu().numpy()
