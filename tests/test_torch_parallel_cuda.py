"""The device mesh on the card: each mesh function on 4 shards of one
card against the same function on one CPU shard (its plain result), and
the mesh branches of the dispatcher and the vector index.

The card cases are marked `cuda` and skip without a card. They import no
jax, so they also run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py

Masks and counts must be equal; KV1 ranks the finished distances on the
card exactly as its plain version on the CPU, so top-k ids must be
equal, with distances within RTOL (the card and the CPU sum each row's
squares in another order); k-means within 1e-4 (the card's shards and the
CPU's add their sums in other orders). KV3 (`ops/sq_distance`) is held
to its plain version on the card within `sq_distance.TOL`, NaN and +inf
where it has them, over widths on both sides of its float4 body and
rows that are not 16-byte aligned; the mesh must launch K1 under its
memberships and KV3 under its top-k. KV4 (`ops/kmeans_step`) is held to
its plain version on the card: assignments and counts equal, sums within
`kmeans_step.sums_tolerance` (the plain version adds with atomics), NaN
where it has NaN, and a second launch equal bit for bit; over d = 1, 3,
8, 768 and 769, c = 1, c > n, exact ties (the lower centroid), a shard
of padding only, no rows, rows of a wider matrix, and 100,000 x 768
against 256 centroids; over a shard of many histogram blocks and a
ragged last block: a centroid with 90% of the rows, exact ties equal to
plain bit for bit, NaN rows near the end, and 8,200 centroids (the
scatter without cursors in shared memory); the mesh's step launches it
once a shard.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.models import vector
from dgraph_tpu_torch.ops import kmeans_step, member_sweep, sq_distance, vector_topk
from dgraph_tpu_torch.parallel import mesh as pmesh
from dgraph_tpu_torch.query import dispatch

RTOL = 1e-5
U32 = 0xFFFFFFFF


@pytest.fixture
def card_mesh(monkeypatch):
    """(4 shards of cuda:0, one CPU shard)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    monkeypatch.setattr(pmesh, "DEVICES", ["cuda:0"] * 4)
    card = pmesh.make_mesh()
    monkeypatch.setattr(pmesh, "DEVICES", None)
    return card, pmesh.make_mesh(device="cpu")


@pytest.mark.cuda
def test_membership_and_count_on_the_card(card_mesh):
    card, cpu = card_mesh
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(0, 1 << 30, 1 << 16, dtype=np.uint64)).astype(np.uint32)
    b = np.unique(np.concatenate([rng.choice(a, 4096, replace=False),
                                  rng.integers(0, 1 << 30, 4096).astype(np.uint32)]))
    A = np.full((1 << 16,), U32, np.uint32)
    A[: len(a)] = a
    B = np.full((1 << 14,), U32, np.uint32)
    B[: len(b)] = b
    got = pmesh.sharded_membership(card, A, len(a), B, len(b))
    assert got.device.type == "cuda"
    want = pmesh.sharded_membership(cpu, A, len(a), B, len(b))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert int(pmesh.sharded_intersect_count(card, A, len(a), B, len(b))) == int(
        np.isin(a, b).sum())
    rows = np.stack([A[:512], A[512:1024]])
    LA = np.array([512, 300], np.int32)
    got = pmesh.sharded_rows_membership(card, rows, LA, B, len(b))
    want = pmesh.sharded_rows_membership(cpu, rows, LA, B, len(b))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_topk_on_the_card_launches_kv1(card_mesh):
    card, cpu = card_mesh
    rng = np.random.default_rng(1)
    V = rng.standard_normal((1 << 16, 64)).astype(np.float32)
    valid = rng.random(1 << 16) > 0.1
    q = rng.standard_normal(64).astype(np.float32)
    before = vector_topk.LAUNCHES
    d, i = pmesh.sharded_topk(card, V, valid, torch.from_numpy(q), 10)
    assert vector_topk.LAUNCHES - before == 5  # 4 local, 1 global
    wd, wi = pmesh.sharded_topk(cpu, V, valid, torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i.cpu().numpy(), wi.numpy())
    np.testing.assert_allclose(d.cpu().numpy(), wd.numpy(), rtol=RTOL)


@pytest.mark.cuda
def test_kmeans_on_the_card(card_mesh):
    card, cpu = card_mesh
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((8000, 16)) + rng.integers(0, 5, (8000, 1)) * 3.0).astype(
        np.float32)
    np.testing.assert_allclose(pmesh.sharded_ivf_train(card, X, 10, 5),
                               pmesh.sharded_ivf_train(cpu, X, 10, 5), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_dispatcher_and_index_on_the_card(card_mesh, monkeypatch):
    """A giant b through `_run_rows_sharded` on 4 shards of the card, and
    a `SHARD_VECTORS=1` index, each equal to the single-device answer."""
    card, _ = card_mesh
    monkeypatch.setattr(pmesh, "DEVICES", card.devices)
    monkeypatch.setattr(dispatch, "_SHARD_MIN_B", 1 << 16)
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    rng = np.random.default_rng(3)
    big = np.unique(rng.integers(1, 1 << 24, 1 << 17, dtype=np.uint64))
    rows = [np.unique(np.concatenate([rng.choice(big, 50, replace=False),
                                      rng.integers(1 << 24, 1 << 25, 50, dtype=np.uint64)]))
            for _ in range(3)]
    got = dispatch.SetOpDispatcher(device="cuda").run_rows_vs_one("intersect", rows, big)
    for g, r in zip(got, rows):
        np.testing.assert_array_equal(g, np.intersect1d(r, big))
    monkeypatch.setenv("DGRAPH_TPU_SHARD_VECTORS", "1")
    V = rng.standard_normal((5000, 32)).astype(np.float32)
    Q = rng.standard_normal((3, 32)).astype(np.float32)
    idx = vector.VectorIndex("emb", device="cuda")
    idx.bulk_load(np.arange(1, 5001, dtype=np.uint64), V)
    got = idx.search_batch(Q, 10)
    assert idx._mesh.size == 4
    monkeypatch.setattr(pmesh, "DEVICES", card.devices[:1])
    one = vector.VectorIndex("emb", device="cuda")
    one.bulk_load(np.arange(1, 5001, dtype=np.uint64), V)
    np.testing.assert_array_equal(got, one.search_batch(Q, 10))
    assert one._mesh is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


def _kv3_matches_plain(V, q):
    got = sq_distance.sq_distance(V, q)
    want = sq_distance.sq_distance_plain(V, q)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isclose(got, want, rtol=sq_distance.TOL, atol=0.0, equal_nan=True).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 4097])
@pytest.mark.parametrize("d", [1, 3, 8, 768, 769])
def test_sq_distance_kernel(card, d, rows):
    """KV3 against its plain version on the card: contiguous rows, rows
    one float past a 16-byte boundary, rows of a wider matrix (a row
    stride of d + 3), with +inf, -inf and NaN inputs, and a row equal to
    the query."""
    rng = np.random.default_rng(d * 10_000 + rows)
    q = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(card)
    flat = torch.from_numpy(rng.standard_normal(rows * (d + 3) + 8).astype(np.float32)).to(card)
    views = [flat[: rows * d].view(rows, d), flat[1 : 1 + rows * d].view(rows, d),
             flat[: rows * (d + 3)].view(rows, d + 3)[:, 1 : 1 + d]]
    before = sq_distance.LAUNCHES
    for V in views:
        _kv3_matches_plain(V, q)
    special = views[0].clone()
    special[0] = q
    if rows > 3:
        special[1, 0], special[2, d - 1], special[3, d // 2] = np.inf, -np.inf, np.nan
    _kv3_matches_plain(special, q)
    assert float(sq_distance.sq_distance(special, q)[0]) == 0.0
    assert sq_distance.LAUNCHES - before == len(views) + 2


@pytest.mark.cuda
def test_mesh_launches_k1_and_kv3(card_mesh):
    """On 4 shards of the card, the memberships launch K1 (one or more a
    shard) and the top-k one KV3 a shard, with the same results as the
    host mesh."""
    card4, cpu = card_mesh
    rng = np.random.default_rng(5)
    a = np.unique(rng.integers(0, U32, 5000, dtype=np.uint64).astype(np.uint32))
    b = np.unique(np.concatenate([rng.choice(a, 1000, replace=False), [U32],
                                  rng.integers(0, U32, 3000, dtype=np.uint64).astype(np.uint32)]))
    A = np.full((8192,), U32, np.uint32)
    A[: len(a)] = a
    B = np.full((4096 + 4,), U32, np.uint32)
    B[: len(b)] = b
    before = member_sweep.LAUNCHES
    got = pmesh.sharded_membership(card4, A, len(a), B, len(b))
    assert member_sweep.LAUNCHES - before == 4
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  pmesh.sharded_membership(cpu, A, len(a), B, len(b)).numpy())
    assert int(pmesh.sharded_intersect_count(card4, A, len(a), B, len(b))) == int(
        np.isin(a, b).sum())
    rows = np.stack([A[:300], A[300:600], A[600:900]])
    LA = np.array([300, 129, 0], np.int32)
    before = member_sweep.LAUNCHES
    got = pmesh.sharded_rows_membership(card4, rows, LA, B[:4096], len(b))
    assert member_sweep.LAUNCHES - before == 4
    np.testing.assert_array_equal(
        got.cpu().numpy(), pmesh.sharded_rows_membership(cpu, rows, LA, B[:4096], len(b)).numpy())
    V = rng.standard_normal((4000, 96)).astype(np.float32)
    valid = rng.random(4000) > 0.2
    q = rng.standard_normal(96).astype(np.float32)
    before = sq_distance.LAUNCHES
    d, i = pmesh.sharded_topk(card4, V, valid, torch.from_numpy(q), 10)
    assert sq_distance.LAUNCHES - before == 4
    wd, wi = pmesh.sharded_topk(cpu, V, valid, torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i.cpu().numpy(), wi.numpy())
    np.testing.assert_allclose(d.cpu().numpy(), wd.numpy(), rtol=RTOL)


def _kv4_case(kind, d, n, c, seed):
    rng = np.random.default_rng(seed)
    w = (rng.random(n) > 0.1).astype(np.float32)
    if kind == "ties":  # small integers: exact dots, norms and sums
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = X[rng.choice(n, c, replace=False)].copy()
        C[-1] = C[0]
        return X, w, C
    centers = rng.standard_normal((max(c, 1), d)).astype(np.float32) * 6.0
    labels = rng.integers(0, len(centers), n)
    if kind == "dominant":  # about 90% of the rows near centroid 0
        labels[rng.random(n) < 0.9] = 0
    X = (centers[labels] + rng.standard_normal((n, d))).astype(np.float32)
    C = centers[:c].copy()
    if kind == "c_gt_n":
        C = np.concatenate([C, rng.standard_normal((n + 7, d)).astype(np.float32) * 50.0])
    elif kind == "padding":
        w[:] = 0.0
    elif kind == "nan" and n > 5:
        X[[1, 5]] = np.nan
    return X, w, C


def _kv4_matches_plain(X, w, C):
    dot = vector_topk.f32_matmul(X, C.T)
    before = kmeans_step.LAUNCHES
    got = kmeans_step.kmeans_step(X, w, C, dot)
    again = kmeans_step.kmeans_step(X, w, C, dot)
    want = kmeans_step.kmeans_step_plain(X, w, C, dot)
    torch.cuda.synchronize()
    assert kmeans_step.LAUNCHES - before == 2
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[1], want[1])
    tol = kmeans_step.sums_tolerance(X, w, want[2], C.shape[0])
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    fin = torch.isfinite(want[0])
    assert ((got[0] - want[0]).abs()[fin] <= tol[fin]).all()
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauss", "ties", "c1", "c_gt_n", "padding", "nan"])
@pytest.mark.parametrize("d", [1, 3, 8, 768, 769])
def test_kmeans_step_kernel(card, d, kind):
    """KV4 against its plain version on the card, on contiguous rows and
    on rows of a wider matrix (a row stride of d + 3, off a 16-byte
    boundary)."""
    n, c = 3000, 1 if kind == "c1" else 6
    X, w, C = _kv4_case(kind, d, n, c, seed=d * 10 + len(kind))
    Xd, wd, Cd = (torch.from_numpy(a).to(card) for a in (X, w, C))
    got = _kv4_matches_plain(Xd, wd, Cd)
    wide = torch.zeros((n, d + 3), device=card)
    wide[:, 1:1 + d] = Xd
    _kv4_matches_plain(wide[:, 1:1 + d], wd, Cd)
    if kind == "ties":
        assert not (got[2] == c - 1).any()  # C[-1] == C[0]: ties go to 0
    if kind == "padding":
        assert not got[1].any()
    if kind == "c_gt_n":
        assert int((got[1] == 0).sum()) >= C.shape[0] - n  # more centroids than rows


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 257, 100_000])
def test_kmeans_step_kernel_sizes(card, n):
    """No rows, fewer rows than a warp, a block and a row past it, and the
    one-device mesh of emb_small (100,000 x 768 against 256)."""
    d, c = (768, 256) if n == 100_000 else (8, 4)
    X, w, C = _kv4_case("gauss", d, n, c, seed=n + 1)
    sums, cnts, assign = _kv4_matches_plain(*(torch.from_numpy(a).to(card) for a in (X, w, C)))
    assert assign.shape == (n,) and sums.shape == (c, d)
    assert float(cnts.sum()) == float(w.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauss", "dominant", "ties", "nan_late"])
@pytest.mark.parametrize("d", [768, 769])
def test_kmeans_step_kernel_blocks(card, d, kind):
    """KV4 on a shard of 53 histogram blocks and a ragged last one, on
    contiguous rows and on rows of a wider matrix: Gaussian clusters; one
    centroid holding about 90% of the rows, in every block; exact ties
    (small integers: every product and sum exact, so the sums equal
    plain's bit for bit); NaN rows in the last two blocks."""
    c, n = 32, 13_658
    X, w, C = _kv4_case("gauss" if kind == "nan_late" else kind, d, n, c, seed=d + len(kind))
    if kind == "nan_late":
        X[[n - 300, n - 7]] = np.nan
    Xd, wd, Cd = (torch.from_numpy(a).to(card) for a in (X, w, C))
    wide = torch.zeros((n, d + 3), device=card)
    wide[:, 1:1 + d] = Xd
    for rows in (Xd, wide[:, 1:1 + d]):
        got = _kv4_matches_plain(rows, wd, Cd)
        if kind == "ties":
            want = kmeans_step.kmeans_step_plain(rows, wd, Cd, vector_topk.f32_matmul(rows, Cd.T))
            assert torch.equal(got[0], want[0])
        if kind == "dominant":
            assert float(got[1][0]) > 0.85 * float(w.sum())
        if kind == "nan_late":
            assert int(got[2][n - 300]) == 0 and bool(torch.isnan(got[0][0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 3000, 12_305])
def test_kmeans_step_kernel_many_centroids(card, n):
    """KV4 against 8,200 centroids (over the 8,192 whose cursors the
    scatter keeps in shared memory), 16 of them near the rows and the
    rest far: an empty shard, a shard of 12 histogram blocks and one of
    49, most centroids with no row."""
    d = 8
    X, w, C = _kv4_case("gauss", d, n, 16, seed=n + 5)
    far = np.random.default_rng(n).standard_normal((8200 - 16, d)).astype(np.float32) * 50.0
    Cd = torch.from_numpy(np.concatenate([C, far])).to(card)
    sums, cnts, assign = _kv4_matches_plain(torch.from_numpy(X).to(card),
                                            torch.from_numpy(w).to(card), Cd)
    assert sums.shape == (8200, d) and float(cnts.sum()) == float(w.sum())
    assert not cnts[16:].any()


@pytest.mark.cuda
def test_kmeans_step_launches_a_shard(card_mesh):
    """The mesh's Lloyd step launches KV4 once a shard and equals the host
    mesh's step within 1e-4; a repeat on the card is equal bit for bit."""
    card4, cpu = card_mesh
    X, _, C = _kv4_case("gauss", 96, 4000, 16, seed=9)
    valid = np.arange(4000) < 3500  # the last shard: padding only
    before = kmeans_step.LAUNCHES
    got = pmesh.sharded_kmeans_step(card4, X, valid, torch.from_numpy(C))
    assert kmeans_step.LAUNCHES - before == 4
    again = pmesh.sharded_kmeans_step(card4, X, valid, torch.from_numpy(C))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = pmesh.sharded_kmeans_step(cpu, X, valid, torch.from_numpy(C))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
