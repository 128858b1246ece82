"""The device mesh on the card: each mesh function on 4 shards of one
card against the same function on one CPU shard (its plain result), and
the mesh branches of the dispatcher and the vector index.

The card cases are marked `cuda` and skip without a card. They import no
jax, so they also run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py

Masks and counts must be equal; KV1 ranks the finished distances on the
card exactly as its plain version on the CPU, so top-k ids must be
equal, with distances within RTOL (the card and the CPU sum each row's
squares in another order); k-means within 1e-4 (`index_add_` adds with
atomics on the card, in no fixed order). KV3 (`ops/sq_distance`) is held
to its plain version on the card within `sq_distance.TOL`, NaN and +inf
where it has them, over widths on both sides of its float4 body and
rows that are not 16-byte aligned; the mesh must launch K1 under its
memberships and KV3 under its top-k.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.models import vector
from dgraph_tpu_torch.ops import member_sweep, sq_distance, vector_topk
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
