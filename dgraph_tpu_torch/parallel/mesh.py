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

Per-shard work runs on hand-written kernels on a card:
- membership on K1 (`ops/member_sweep.membership_batch`), each shard's
  queries cut into rows of at most 128 (`member_chunks`) against the
  shard's operand as K1's one shared B; on the host on
  `ops/setops.membership`, a searchsorted, since K1's plain version
  compares every query with every element of B;
- the top-k's distances on KV3 (`ops/sq_distance`, one pass over the
  shard), ranked by KV1 (`ops/vector_topk.topk`, on the finished
  distance) for the local and the global top-k;
- the k-means step's GEMM on `torch.matmul` (full float32), then KV4
  (`ops/kmeans_step`): the assignment, and each centroid's sum and count
  in row order, with no float atomic.

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
from dgraph_tpu_torch.ops import member_sweep, setops

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


def member_chunks(A, LA, b, lb: int, sweep) -> torch.Tensor:
    """mask[i, j] = j < LA[i] and A[i, j] in b[:lb], through a member
    sweep (`sweep`: K1's `membership_batch`, or its plain version).

    A (n, pa) u32 uids, each row sorted within LA: an (n,) tensor, or an
    int when n is 1; b sorted u32 uids; A and b as int64 values or as
    their u32 bits in int32, which K1 takes. K1 takes at most
    `member_sweep.LANE` queries a row, so row i is cut into chunks of
    that width: chunk c holds A[i, c * LANE:(c + 1) * LANE] with length
    LA[i] - c * LANE (none valid below 0, all above LANE, as K1 reads a
    length), and every chunk searches b's first lb uids as K1's one
    shared B. Validity stays by index, so UINT32_MAX is a uid like any
    other."""
    n, pa = A.shape
    dev = A.device
    if not A.numel():
        return torch.zeros((n, pa), dtype=torch.bool, device=dev)
    w = min(pa, member_sweep.LANE)
    c = -(-pa // w)
    bits = _bits(A)
    if c * w != pa:  # the last chunk's columns past pa are never valid
        bits = torch.cat([bits, bits.new_zeros((n, c * w - pa))], dim=1)
    if not torch.is_tensor(LA):
        la = torch.arange(LA, LA - c * w, -w, dtype=torch.int32, device=dev)
    else:
        la = LA.to(device=dev, dtype=torch.int32)
        if c > 1:
            la = la[:, None] - torch.arange(0, c * w, w, dtype=torch.int32, device=dev)
    LB = torch.full((1,), lb, dtype=torch.int32, device=dev)
    hit = sweep(bits.reshape(n * c, w), la.reshape(-1), _bits(b[:lb]), LB)
    return hit.view(n, c * w)[:, :pa]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """u32 uids as their bits in int32: int64 values converted (the
    conversion keeps the low 32 bits), int32 bits as they are."""
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def _sweep(device: torch.device):
    """The member sweep a shard on `device` takes: K1 on a card; None on
    the host, where `setops.membership` searches (K1's plain version
    compares every query with every element of b)."""
    return member_sweep.membership_batch if device.type == "cuda" else None


def _searched(mesh: Mesh, x, n=None):
    """A replicated operand as the shards search it: on a card (K1) its
    first n uids (all of them by default) as u32 bits, converted once
    and copied to each device as 4-byte words; on the host as given."""
    if _sweep(mesh.devices[0]) is None:
        return x
    return _bits(_tensor(x)[: n if n is not None else len(x)])


def _membership(a, la, b, lb: int) -> torch.Tensor:
    """One shard's membership: a (pa,) with la an int, or a (n, pa) with
    la (n,), against b[:lb]."""
    sweep = _sweep(a.device)
    if sweep is None:
        return setops.membership(a, la, b, lb)
    if a.dim() == 2:
        return member_chunks(a, la, b, lb, sweep)
    return member_chunks(a[None, :], int(la), b, lb, sweep)[0]


def sharded_membership(mesh: Mesh, a, la, b, lb) -> torch.Tensor:
    """mask over row-sharded `a` (padded multiple of the mesh size),
    gathered on the mesh's first device."""
    tiles = shard(mesh, a)
    b_on = _Replicated(_searched(mesh, b, int(lb)))
    n = tiles[0].shape[0]
    parts = [
        _membership(t, _local_len(int(la), i, n), b_on[t.device], int(lb))
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
    A_on, LA_on = _Replicated(_searched(mesh, A)), _Replicated(LA)
    tile_n = tiles[0].shape[0]
    parts = [
        _membership(
            A_on[t.device], LA_on[t.device], t, _local_len(int(lb), i, tile_n)
        ).to(torch.int32)
        for i, t in enumerate(tiles)
    ]
    return _psum(mesh, parts) > 0


def sharded_intersect_count(mesh: Mesh, a, la, b, lb) -> torch.Tensor:
    """Total intersection size of a row-sharded list vs replicated list
    (psum over the mesh)."""
    tiles = shard(mesh, a)
    b_on = _Replicated(_searched(mesh, b, int(lb)))
    n = tiles[0].shape[0]
    parts = [
        _membership(
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
    to the lower flat index, the flat order shard-major. Each shard's
    distances are KV3's (`sq_distance`: one pass over the shard), ranked
    with KV1 (metric "distance"), invalid rows at +inf; KV1 ranks the
    gathered candidates again."""
    from dgraph_tpu_torch.ops import sq_distance, vector_topk

    V_tiles, valid_tiles = shard(mesh, V), shard(mesh, valid)
    q_on = _Replicated(q)
    rows = V_tiles[0].shape[0]
    kk = min(k, rows)
    dists, ids = [], []
    for i, (Vt, vt) in enumerate(zip(V_tiles, valid_tiles)):
        d2 = sq_distance.sq_distance(Vt, q_on[Vt.device])
        d, idx = vector_topk.topk(d2[None, :], kk, "distance", valid=vt)
        dists.append(d[0])
        ids.append(idx[0] + i * rows)
    flat_d, flat_i = _all_gather(mesh, dists), _all_gather(mesh, ids)
    gd, sel = vector_topk.topk(flat_d[None, :], k, "distance")
    return gd[0], flat_i[sel[0].long()]


# ---------------------------------------------------------------------------
# Distributed IVF k-means training: THE training step.
# Data-parallel Lloyd iteration: local GEMM (matmul), local assign and
# segment-sum (KV4), psum of (sums, counts), replicated update.
# ---------------------------------------------------------------------------


def sharded_kmeans_step(mesh: Mesh, X, valid, C) -> torch.Tensor:
    """One Lloyd step. X row-sharded (n, d); C replicated (c, d).
    Returns updated replicated centroids. Each shard's GEMM is
    `vector_topk.f32_matmul` (full float32), its assignment, sums and counts
    KV4 (`kmeans_step.kmeans_step`)."""
    from dgraph_tpu_torch.ops import kmeans_step

    X_tiles, valid_tiles = shard(mesh, X), shard(mesh, valid)
    C_on = _Replicated(C)
    sums, cnts = [], []
    for Xt, vt in zip(X_tiles, valid_tiles):
        s, c, _ = kmeans_step.kmeans_step(Xt, vt.to(Xt.dtype), C_on[Xt.device])
        sums.append(s)
        cnts.append(c)
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
