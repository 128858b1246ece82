"""The port's device mesh (`dgraph_tpu_torch/parallel/mesh.py`) and the
branches that use it, against the JAX reference, on the CPU.

The reference runs on the virtual 8-device CPU mesh that
tests/conftest.py gives jax; the port on a mesh of 8 shards of the host
(`mesh.HOST_WIDTH = 8`). The same numpy inputs go through both:

- the cases of tests/test_parallel.py and the mesh cases of
  tests/test_multipart.py, plus `sharded_rows_membership` and
  `sharded_kmeans_step` on their own: masks and counts are integer
  results and must be equal; top-k ids must be equal, and distances
  within RTOL (the per-shard squared distances are float32 sums taken
  in another order than XLA's); k-means within 1e-4, the tolerance of
  the reference's own test (float sums over shards, in another order);
- the dispatcher's giant-operand branch (`_SHARD_MIN_B`,
  `_run_rows_sharded`), with both dispatchers on the device path: equal
  answers, the port's mesh taken for one hi-32 segment and left (None,
  then the single-device path) for rows that span two;
- `VectorIndex` with `SHARD_VECTORS=1`, euclidean and cosine: `search`,
  `search_batch` and a filtered search that widens its pool; on one
  device both packages take the single-device path;
- the finding that `sharded_topk` takes no metric: a cosine index on a
  mesh ranks by squared euclidean distance, in both packages;
- the kernels' plain versions under the mesh: KV3's (`sq_distance_plain`)
  against the reference's per-shard distance within RTOL, and K1's
  128-wide chunking (`mesh.member_chunks`) with K1's wrapper on CPU
  tensors (its plain version) as the sweep, against `setops.membership` and, through every membership
  function of the mesh, against the reference bit for bit: rows of 1,
  128, 129 and 1,024 queries, tiles that are not a multiple of 128,
  shards whose window is empty, and UINT32_MAX as a uid.
"""

import numpy as np
import pytest
import torch

import chip_smoke

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dgraph_tpu.models import vector as ref_vector
from dgraph_tpu.parallel import mesh as ref_mesh
from dgraph_tpu.query import dispatch as ref_dispatch
from dgraph_tpu_torch.models import vector
from dgraph_tpu_torch.ops import member_sweep, setops, sq_distance
from dgraph_tpu_torch.parallel import mesh as pmesh
from dgraph_tpu_torch.query import dispatch

RTOL = 1e-5
U32 = 0xFFFFFFFF


@pytest.fixture
def meshes(monkeypatch):
    """(reference mesh, port mesh), 8 devices each."""
    assert len(jax.devices()) >= 8, "conftest must force 8 cpu devices"
    monkeypatch.setattr(pmesh, "HOST_WIDTH", 8)
    return ref_mesh.make_mesh(8), pmesh.make_mesh(8, device="cpu")


def _ref_sharded(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))


# ---------------------------------------------------------------------------
# The mesh functions
# ---------------------------------------------------------------------------


def test_make_mesh():
    assert pmesh.make_mesh(device="cpu").size == pmesh.HOST_WIDTH == 1
    m = pmesh.make_mesh(device="cpu")
    assert m.devices == (torch.device("cpu"),) and m.axis_names == ("data",)


def test_make_mesh_names_its_devices(monkeypatch):
    monkeypatch.setattr(pmesh, "DEVICES", ["cpu"] * 4)
    assert pmesh.make_mesh(device="cpu").size == 4
    assert pmesh.make_mesh(2, device="cpu").size == 2
    with pytest.raises(ValueError):  # 6 rows do not split into 4 tiles
        pmesh.shard(pmesh.make_mesh(device="cpu"), np.zeros(6, np.int64))
    monkeypatch.setattr(pmesh, "DEVICES", ["cuda:0"] * 4)
    with pytest.raises(ValueError):  # a cpu mesh of cuda devices
        pmesh.make_mesh(device="cpu")


def test_cuda_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pmesh.make_mesh()


@pytest.mark.parametrize("overlap", [False, True], ids=["test_parallel", "overlapping"])
def test_sharded_membership_matches(meshes, overlap):
    """test_parallel.py's case (a random 30-bit a and b, nearly disjoint)
    and one where half of b is drawn from a."""
    rm, pm = meshes
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(0, 1 << 30, 4096, dtype=np.uint64)).astype(np.uint32)
    b = np.unique(rng.integers(0, 1 << 30, 2048, dtype=np.uint64)).astype(np.uint32)
    if overlap:
        b = np.unique(np.concatenate([b[:1024], rng.choice(a, 1024, replace=False)]))
    A = np.full((4096,), U32, np.uint32)
    A[: len(a)] = a
    B = np.full((2048,), U32, np.uint32)
    B[: len(b)] = b
    Ad = _ref_sharded(rm, A)
    want_mask = np.asarray(ref_mesh.sharded_membership(rm, Ad, len(a), jnp.asarray(B), len(b)))
    mask = pmesh.sharded_membership(pm, A, len(a), B, len(b)).numpy()
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(mask[: len(a)], np.isin(a, b))
    assert not mask[len(a):].any()
    want = int(ref_mesh.sharded_intersect_count(rm, Ad, len(a), jnp.asarray(B), len(b)))
    got = pmesh.sharded_intersect_count(pm, A, len(a), B, len(b))
    assert int(got) == want == int(np.isin(a, b).sum())
    assert want > 0 or not overlap


def test_sharded_rows_membership_4m(meshes):
    """test_multipart.py's >4M-uid operand, row-sharded over 8 shards,
    against 4 rows of 20 hits and 20 misses each."""
    rm, pm = meshes
    rng = np.random.default_rng(0)
    big = np.unique(rng.integers(1, 1 << 26, 4_500_000, dtype=np.uint32))
    n_big = len(big)
    assert n_big > 1 << 22
    ndev = 8
    tile = -(-n_big // ndev)
    tile = 1 << (tile - 1).bit_length()
    pb = tile * ndev
    B = setops.pad_sorted(big, pb)
    rows = np.full((4, 64), U32, np.uint32)
    LA = np.zeros((4,), np.int32)
    for i in range(4):
        hits = rng.choice(big, 20, replace=False)
        misses = rng.integers(1 << 26, 1 << 27, 20, dtype=np.uint32)
        r = np.unique(np.concatenate([hits, misses]))
        rows[i, : len(r)] = r
        LA[i] = len(r)
    want = np.asarray(ref_mesh.sharded_rows_membership(
        rm, jnp.asarray(rows), LA, _ref_sharded(rm, B), n_big))
    got = pmesh.sharded_rows_membership(pm, rows, LA, B, n_big).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 80
    for i in range(4):
        np.testing.assert_array_equal(got[i, : LA[i]], np.isin(rows[i, : LA[i]], big))


def _topk_data(kind, rng, n=1024, d=16):
    if kind == "ties":  # small integers: exact sums, many equal distances
        V = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, d).astype(np.float32)
    else:
        V = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal(d).astype(np.float32)
    valid = np.ones((n,), bool)
    if kind == "invalid":
        valid[rng.choice(n, n // 3, replace=False)] = False
    return V, valid, q


@pytest.mark.parametrize("kind", ["test_parallel", "ties", "invalid"])
@pytest.mark.parametrize("k", [10, 200])
def test_sharded_topk_matches(meshes, kind, k):
    """Equal ids in lax.top_k's order (ties to the lower flat index,
    shard-major), distances within RTOL; on integer data exactly."""
    rm, pm = meshes
    V, valid, q = _topk_data(kind, np.random.default_rng(1))
    rd, ri = ref_mesh.sharded_topk(rm, _ref_sharded(rm, V), _ref_sharded(rm, valid),
                                   jnp.asarray(q), k)
    rd, ri = np.asarray(rd), np.asarray(ri)
    d, i = pmesh.sharded_topk(pm, V, valid, torch.from_numpy(q), k)
    d, i = d.numpy(), i.numpy()
    np.testing.assert_array_equal(i, ri)
    if kind == "ties":
        np.testing.assert_array_equal(d, rd)
    else:
        np.testing.assert_allclose(d, rd, rtol=RTOL)
    d2 = np.where(valid, ((V - q[None, :]) ** 2).sum(axis=1), np.inf)
    want = np.argsort(d2, kind="stable")[:k]
    np.testing.assert_array_equal(np.sort(i), np.sort(want))


def test_sharded_kmeans_matches_single_device(meshes):
    """test_parallel.py's case: the port's trained centroids equal a
    single-device Lloyd with the same start within 1e-4, and the
    reference's within 1e-4."""
    rm, pm = meshes
    rng = np.random.default_rng(2)
    n, d, c = 800, 8, 10
    X = (rng.standard_normal((n, d)) + rng.integers(0, 5, (n, 1)) * 3.0).astype(np.float32)
    cents = pmesh.sharded_ivf_train(pm, X, nlist=c, iters=5)
    ref = ref_mesh.sharded_ivf_train(rm, X, nlist=c, iters=5)

    rng2 = np.random.default_rng(0)
    C = X[rng2.choice(n, c, replace=False)].copy()
    for _ in range(5):
        d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        a = d2.argmin(axis=1)
        for ci in range(c):
            sel = X[a == ci]
            if len(sel):
                C[ci] = sel.mean(axis=0)
    np.testing.assert_allclose(cents, C, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cents, ref, rtol=1e-4, atol=1e-4)


def test_sharded_kmeans_step_with_padding(meshes):
    """One Lloyd step over rows padded to the mesh (invalid rows weigh
    nothing) with an empty cluster (kept as it was), against the
    reference's step."""
    rm, pm = meshes
    rng = np.random.default_rng(4)
    X = rng.standard_normal((803, 6)).astype(np.float32)
    Xp = np.concatenate([X, np.full((5, 6), 100.0, np.float32)])
    valid = np.arange(808) < 803
    C = np.concatenate([X[:7], np.full((1, 6), 1e3, np.float32)])
    want = np.asarray(ref_mesh.sharded_kmeans_step(
        rm, _ref_sharded(rm, Xp), _ref_sharded(rm, valid), jnp.asarray(C)))
    got = pmesh.sharded_kmeans_step(pm, Xp, valid, torch.from_numpy(C)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[7], C[7])


# ---------------------------------------------------------------------------
# The kernels under the mesh: KV3's plain version, K1's 128-wide chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 3, 8, 768, 769])
def test_sq_distance_plain_matches_reference(d):
    """KV3's wrapper on CPU tensors (its plain version) against the
    reference's per-shard distance (`dgraph_tpu/parallel/mesh.py:167`)
    in jax, within RTOL; +inf and NaN inputs give +inf and NaN in both,
    and a row equal to the query 0."""
    rng = np.random.default_rng(d)
    V = rng.standard_normal((257, d)).astype(np.float32) * 3.0
    q = rng.standard_normal(d).astype(np.float32)
    V[3, 0], V[4, d - 1], V[5] = np.inf, np.nan, q
    want = np.asarray(((jnp.asarray(V) - jnp.asarray(q)[None, :]) ** 2).sum(axis=1))
    before = sq_distance.PLAIN_CALLS
    got = sq_distance.sq_distance(torch.from_numpy(V), torch.from_numpy(q)).numpy()
    assert sq_distance.PLAIN_CALLS == before + 1 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.isposinf(got[3]) and np.isnan(got[4]) and got[5] == 0.0


def _sorted_rows(rng, b, n, pa, lens):
    """(A (n, pa) u32 padded with UINT32_MAX, LA): row i holds lens[i]
    sorted uids, about half of them from b, the last of the full row
    UINT32_MAX as a uid."""
    A = np.full((n, pa), U32, np.uint32)
    LA = np.asarray(lens, np.int32)
    for i, la in enumerate(lens):
        pool = np.unique(np.concatenate([
            rng.choice(b, min(len(b), la), replace=False),
            rng.integers(0, U32, la + 1, dtype=np.uint64).astype(np.uint32)]))
        r = np.sort(rng.choice(pool, la, replace=False))
        if la == pa:
            r[-1] = U32
        A[i, :la] = r
    return A, LA


def _lens(rng, pa, n=6):
    return [0, pa, 1, pa // 2, max(pa - 1, 0), int(rng.integers(0, pa + 1))][:n]


@pytest.mark.parametrize("pa", [1, 128, 129, 1024])
def test_member_chunks_matches_setops(pa):
    """K1's chunking of rows of pa queries into rows of at most 128, with
    K1's wrapper on CPU tensors (its plain version) as the sweep, equals `setops.membership` and
    numpy: b holding UINT32_MAX as its last uid, then without it (lb one
    short: the rows' UINT32_MAX must miss), then empty."""
    rng = np.random.default_rng(pa)
    b = np.unique(np.concatenate([
        rng.integers(0, U32, 3000, dtype=np.uint64).astype(np.uint32), [U32]]))
    A, LA = _sorted_rows(rng, b, 6, pa, _lens(rng, pa))
    Ad, LAd = setops.to_device(A, "cpu"), torch.from_numpy(LA)
    Bd = setops.to_device(setops.pad_sorted(b, len(b) + 37), "cpu")
    before = member_sweep.PLAIN_CALLS
    for lb in (len(b), len(b) - 1, 0):
        got = pmesh.member_chunks(Ad, LAd, Bd, lb, member_sweep.membership_batch)
        assert tuple(got.shape) == (6, pa) and got.dtype == torch.bool
        assert torch.equal(got, setops.membership(Ad, LAd, Bd, lb))
        want = np.isin(A, b[:lb]) & (np.arange(pa)[None, :] < LA[:, None])
        np.testing.assert_array_equal(got.numpy(), want)
        assert bool(got[1, pa - 1]) == (lb == len(b))  # UINT32_MAX, a real uid
    assert member_sweep.PLAIN_CALLS == before + 3
    assert want.sum() == 0


@pytest.fixture(params=["searchsorted", "k1_chunks"])
def shard_path(request, monkeypatch):
    """The mesh's per-shard membership as on the host (`setops.membership`)
    or as on a card (`member_chunks`), with K1's wrapper on CPU tensors
    (its plain version) as the sweep; yields how to tell that the chunks
    ran."""
    if request.param == "k1_chunks":
        monkeypatch.setattr(pmesh, "_sweep", lambda device: member_sweep.membership_batch)
    before = member_sweep.PLAIN_CALLS
    yield lambda: (member_sweep.PLAIN_CALLS > before) == (request.param == "k1_chunks")


@pytest.mark.parametrize("pa", [1, 128, 129, 1024])
def test_sharded_rows_membership_edges(meshes, shard_path, pa):
    """Rows of pa queries against a list row-sharded over 8 tiles of 200
    (not a multiple of 128) whose 1,000 uids end in UINT32_MAX, so that
    tiles 5-7 hold none: bit for bit the reference's mask, and numpy's."""
    rm, pm = meshes
    rng = np.random.default_rng(100 + pa)
    big = np.unique(np.concatenate([
        rng.integers(0, U32, 1200, dtype=np.uint64).astype(np.uint32), [U32]]))[-1000:]
    B = setops.pad_sorted(big, 8 * 200)
    rows, LA = _sorted_rows(rng, big, 6, pa, _lens(rng, pa))
    want = np.asarray(ref_mesh.sharded_rows_membership(
        rm, jnp.asarray(rows), LA, _ref_sharded(rm, B), len(big)))
    got = pmesh.sharded_rows_membership(pm, rows, LA, B, len(big)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.isin(rows, big) & (np.arange(pa)[None, :] < LA[:, None]))
    assert got[1, pa - 1] and shard_path()


@pytest.mark.parametrize("tile", [1, 128, 129, 200, 1024])
def test_sharded_membership_edges(meshes, shard_path, tile):
    """a row-sharded over 8 tiles of `tile` with a window that fills
    tiles 0-3, cuts tile 4 and leaves 5-7 empty, its last uid UINT32_MAX,
    against a replicated b that holds UINT32_MAX: the reference's mask
    and count, bit for bit, and numpy's."""
    rm, pm = meshes
    rng = np.random.default_rng(200 + tile)
    la = 4 * tile + (tile + 1) // 2
    a = np.unique(np.concatenate([
        rng.integers(0, U32, 2 * la, dtype=np.uint64).astype(np.uint32), [U32]]))[-la:]
    b = np.unique(np.concatenate([rng.choice(a, max(1, la // 2), replace=False), [U32],
                                  rng.integers(0, U32, 300, dtype=np.uint64).astype(np.uint32)]))
    A = setops.pad_sorted(a, 8 * tile)
    B = setops.pad_sorted(b, len(b) + 5)
    Ad = _ref_sharded(rm, A)
    want = np.asarray(ref_mesh.sharded_membership(rm, Ad, la, jnp.asarray(B), len(b)))
    got = pmesh.sharded_membership(pm, A, la, B, len(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:la], np.isin(a, b))
    assert got[la - 1] and not got[la:].any()
    cnt = int(pmesh.sharded_intersect_count(pm, A, la, B, len(b)))
    assert cnt == int(ref_mesh.sharded_intersect_count(rm, Ad, la, jnp.asarray(B), len(b)))
    assert cnt == int(np.isin(a, b).sum()) and shard_path()


# ---------------------------------------------------------------------------
# The dispatcher's giant shared operand
# ---------------------------------------------------------------------------


@pytest.fixture
def giant_b(monkeypatch, meshes):
    """Both dispatchers on the device path, `_SHARD_MIN_B` at 1 << 16 (as
    test_multipart.py sets it); counts what the port's `_run_rows_sharded`
    returned."""
    for mod in (ref_dispatch, dispatch):
        monkeypatch.setattr(mod, "_SHARD_MIN_B", 1 << 16)
        monkeypatch.setattr(mod, "_FORCE_DEVICE", True)
    routed = []
    real = dispatch.SetOpDispatcher._run_rows_sharded

    def run(self, *a):
        got = real(self, *a)
        routed.append(got is not None)
        return got

    monkeypatch.setattr(dispatch.SetOpDispatcher, "_run_rows_sharded", run)
    return routed


def _giant_rows(rng, big, hi=0):
    return [np.unique(np.concatenate([
        rng.choice(big, 50, replace=False),
        rng.integers(1 << 24, 1 << 25, 50, dtype=np.uint64) + np.uint64(hi),
    ])) for _ in range(3)]


@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_dispatcher_routes_giant_b_through_mesh(giant_b, op):
    """test_multipart.py's case: 3 rows against a b of about 2^17 uids."""
    rng = np.random.default_rng(1)
    big = np.unique(rng.integers(1, 1 << 24, 1 << 17, dtype=np.uint64))
    rows = _giant_rows(rng, big)
    want = ref_dispatch.SetOpDispatcher().run_rows_vs_one(op, rows, big)
    got = dispatch.SetOpDispatcher(device="cpu").run_rows_vs_one(op, rows, big)
    npop = np.intersect1d if op == "intersect" else np.setdiff1d
    for g, w, r in zip(got, want, rows):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, npop(r, big, assume_unique=True))
    assert giant_b == [True]


@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_giant_b_above_2_32_falls_through(giant_b, op):
    """Rows with uids in two hi-32 segments: `_run_rows_sharded` returns
    None and the single-device path answers, as the reference's."""
    rng = np.random.default_rng(2)
    big = np.unique(rng.integers(1, 1 << 24, 1 << 17, dtype=np.uint64))
    rows = _giant_rows(rng, big, hi=1 << 32)
    want = ref_dispatch.SetOpDispatcher().run_rows_vs_one(op, rows, big)
    got = dispatch.SetOpDispatcher(device="cpu").run_rows_vs_one(op, rows, big)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert giant_b == [False]


def test_giant_b_on_one_device_skips_the_mesh(giant_b, monkeypatch):
    monkeypatch.setattr(pmesh, "HOST_WIDTH", 1)
    rng = np.random.default_rng(1)
    big = np.unique(rng.integers(1, 1 << 24, 1 << 17, dtype=np.uint64))
    rows = _giant_rows(rng, big)
    got = dispatch.SetOpDispatcher(device="cpu").run_rows_vs_one("intersect", rows, big)
    for g, r in zip(got, rows):
        np.testing.assert_array_equal(g, np.intersect1d(r, big))
    assert giant_b == []


def test_sharded_operand_is_cached(giant_b):
    """With a version token, the sharded b is uploaded once and served
    from the device cache under ("bshard", token, hi, pb)."""
    rng = np.random.default_rng(3)
    big = np.unique(rng.integers(1, 1 << 24, 1 << 17, dtype=np.uint64))
    rows = _giant_rows(rng, big)
    d = dispatch.SetOpDispatcher(device="cpu")
    tok = (b"key", 7)
    first = d.run_rows_vs_one("intersect", rows, big, b_token=tok)
    entries = [t for t in d.device_cache._entries if t[0] == "bshard"]
    assert len(entries) == 1 and entries[0][1] == tok
    (tiles,), _ = d.device_cache._entries[entries[0]]
    assert isinstance(tiles, pmesh.Sharded) and len(tiles) == 8
    again = d.run_rows_vs_one("intersect", rows, big, b_token=tok)
    for x, y in zip(first, again):
        np.testing.assert_array_equal(x, y)
    assert d.device_cache.stats()["hits"] >= 1


# ---------------------------------------------------------------------------
# VectorIndex with SHARD_VECTORS=1
# ---------------------------------------------------------------------------


@pytest.fixture
def shard_vectors(monkeypatch, meshes):
    monkeypatch.setenv("DGRAPH_TPU_SHARD_VECTORS", "1")
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")


def _indexes(metric, V, uids):
    ref = ref_vector.VectorIndex("emb", metric=metric)
    port = vector.VectorIndex("emb", metric=metric, device="cpu")
    for idx in (ref, port):
        idx.bulk_load(uids, V)
    return ref, port


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_shard_vectors_index_matches(shard_vectors, metric):
    """search, search_batch and a filtered search (its pool widens 4x a
    step) on a corpus row-sharded over 8 shards: equal uids."""
    rng = np.random.default_rng(3)
    V = rng.standard_normal((300, 16)).astype(np.float32)
    Q = rng.standard_normal((5, 16)).astype(np.float32)
    ref, port = _indexes(metric, V, np.arange(1, 301, dtype=np.uint64))
    np.testing.assert_array_equal(port.search(Q[0], 10), ref.search(Q[0], 10))
    assert ref._mesh is not None and port._mesh.size == 8
    assert port._device["sqnorm"] is None
    np.testing.assert_array_equal(port.search_batch(Q, 7), ref.search_batch(Q, 7))
    # far uids: no pool short of the live set holds 5 of them
    d2 = ((V - Q[1][None, :]) ** 2).sum(axis=1)
    allowed = np.sort(np.argsort(d2)[-12:] + 1).astype(np.uint64)
    got = port.search(Q[1], 5, allowed=allowed)
    np.testing.assert_array_equal(got, ref.search(Q[1], 5, allowed=allowed))
    assert len(got) == 5 and set(got.tolist()) <= set(allowed.tolist())
    np.testing.assert_array_equal(port.search(Q[2], 4, ef=40), ref.search(Q[2], 4, ef=40))


def test_shard_vectors_pads_rows_to_the_mesh(shard_vectors):
    """A live count that the mesh does not divide: the padded rows are
    invalid and never answer; IVF trains above its threshold but the
    mesh serves."""
    rng = np.random.default_rng(6)
    V = rng.standard_normal((1001, 8)).astype(np.float32)
    ref = ref_vector.VectorIndex("emb", ivf_threshold=500)
    port = vector.VectorIndex("emb", ivf_threshold=500, device="cpu")
    for idx in (ref, port):
        idx.bulk_load(np.arange(1, 1002, dtype=np.uint64), V)
    q = rng.standard_normal(8).astype(np.float32)
    np.testing.assert_array_equal(port.search(q, 1001), ref.search(q, 1001))
    assert port._ivf is not None and ref._ivf is not None
    before = vector.COUNTERS.path_jit_ivf
    port.search(q, 10)
    assert vector.COUNTERS.path_jit_ivf == before


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_shard_vectors_on_one_device(shard_vectors, monkeypatch, metric):
    """One device: both packages take the single-device path."""
    monkeypatch.setattr(pmesh, "HOST_WIDTH", 1)
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    rng = np.random.default_rng(7)
    V = rng.standard_normal((200, 16)).astype(np.float32)
    Q = rng.standard_normal((3, 16)).astype(np.float32)
    ref, port = _indexes(metric, V, np.arange(1, 201, dtype=np.uint64))
    np.testing.assert_array_equal(port.search(Q[0], 10), ref.search(Q[0], 10))
    np.testing.assert_array_equal(port.search_batch(Q, 5), ref.search_batch(Q, 5))
    assert port._mesh is None and ref._mesh is None
    assert port._device["sqnorm"] is not None


@pytest.mark.parametrize("side", ["ref", "port"])
def test_sharded_cosine_ranks_by_euclidean(shard_vectors, side):
    """`sharded_topk` takes no metric: on a mesh a cosine index ranks by
    squared euclidean distance in both packages, where one device ranks
    by cosine. The rows differ in norm, so the two orders differ."""
    rng = np.random.default_rng(8)
    V = (rng.standard_normal((256, 8)) * rng.uniform(0.1, 10.0, (256, 1))).astype(np.float32)
    q = rng.standard_normal(8).astype(np.float32)
    uids = np.arange(1, 257, dtype=np.uint64)
    ref, port = _indexes("cosine", V, uids)
    idx = ref if side == "ref" else port
    got = idx.search(q, 10)
    euclid = uids[np.argsort(((V - q) ** 2).sum(axis=1), kind="stable")[:10]]
    cos = 1 - V @ q / (np.linalg.norm(V, axis=1) * np.linalg.norm(q))
    cosine = uids[np.argsort(cos, kind="stable")[:10]]
    np.testing.assert_array_equal(got, euclid)
    assert list(got) != list(cosine)


# ---------------------------------------------------------------------------
# Phase 13's mesh part (13b), rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_mesh_phase_on_cpu(monkeypatch):
    """chip_smoke's (13b) at a tiny size on 4 shards of the host: the
    mesh functions equal their plain versions, the one-device mesh and
    numpy; (b) enters `_run_rows_sharded` and falls through on the
    two-segment graph (equal to phase 4's answer), and the mesh answers
    it on the one-segment graph; `similar_to` over a row-sharded index
    equals the exact top-10, each query through 5 top-k calls (4 shards
    and the global one)."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    monkeypatch.setattr(pmesh, "DEVICES", ["cpu"] * chip_smoke.MESH_SHARDS)
    quiet = lambda m: None  # noqa: E731
    g, answers = chip_smoke.mesh_data("cpu", fanout=6, pool=400, log=quiet)
    V, Q = chip_smoke.make_corpus(2000, 16, nq=4)
    exact = chip_smoke.exact_topk(V, Q, 10)
    fns, (topk, _) = chip_smoke.mesh_functions("cpu", g, V, Q, exact, V[:1000].copy(), log=quiet)
    assert set(fns) == {"sharded_rows_membership", "sharded_membership",
                        "sharded_intersect_count", "sharded_topk", "sharded_kmeans_step",
                        "sharded_ivf_train"}
    assert fns["sharded_rows_membership"]["hits"] > 0
    assert fns["sharded_intersect_count"]["count"] == fns["sharded_membership"]["hits"] > 0
    assert fns["sharded_topk"]["launches"] == 0  # plain calls on the CPU
    assert {key[0] for key in topk} == {(1, 500), (1, 40)}
    texts = list(chip_smoke.nquad_chunks(g))
    path, (topk, _) = chip_smoke.mesh_main_path("cpu", g, answers, texts, V[:500].copy(), Q,
                                                min_b=1, log=quiet)
    assert path["phase 4's graph"]["entered"] >= 1
    assert path["phase 4's graph"]["mesh_answered"] == 0
    assert path["one segment"]["mesh_answered"] >= 1
    assert path["launches"]["vector_topk"] == 5 * len(Q)
    assert {key[0] for key in topk} == {(1, 128), (1, 40)}  # 500 rows padded to 512
