"""The port's vector index against the JAX reference, on the CPU.

`dgraph_tpu_torch/models/vector.py` is a guarded copy of
`dgraph_tpu/models/vector.py` whose device functions are rewritten for
torch (tests/test_torch_isolation.py lists them); on CPU tensors its
kernels' wrappers (ops/vector_topk.py KV1, ops/ivf_scan.py KV2) take their
plain versions. The same numpy inputs go through both packages:

- the device functions (`_distances*`, `_jit_brute*`, `_jit_ivf*`)
  against the reference's jitted ones on jax-CPU, for every metric. On
  small-integer vectors (|x| <= 8, d <= 64, many duplicates) every dot is
  exact, so ids and distances must be identical, ties included. On
  Gaussian vectors the sums run in another order: distances must agree
  to RTOL of the row's scale, and ids wherever the neighbouring
  distances stand further apart than that;
- the order of lax.top_k, pinned on -0.0, +-inf and NaN;
- the cases of tests/test_vector.py on whole indexes (`VEC_QUANT=0`,
  the float paths), the IVF layout (same centroids and slabs) and the
  quantized engine (`VEC_QUANT` at its default);
- `similar_to` through `Server(device="cpu")` and through a store
  carried from the reference: response bytes equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dgraph_tpu.models import vector as ref_vector
from dgraph_tpu_torch.models import vector
from dgraph_tpu_torch.ops import ivf_scan, vector_topk

METRICS = ["euclidean", "cosine", "dotproduct"]
# Gaussian data: distances agree to RTOL of the row's largest |distance|
# (sums of <= 64 products in two orders differ by a few ulps of that)
RTOL = 1e-5


@pytest.fixture
def float_paths(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")


def _data(kind, n, d, seed, nq=4):
    rng = np.random.default_rng(seed)
    if kind == "int":  # exact dots; about 40 copies of each vector
        base = rng.integers(-8, 9, (max(1, n // 40), d))
        V = base[rng.integers(0, len(base), n)].astype(np.float32)
        Q = rng.integers(-8, 9, (nq, d)).astype(np.float32)
    else:
        V = rng.standard_normal((n, d)).astype(np.float32)
        Q = rng.standard_normal((nq, d)).astype(np.float32)
    return V, Q


def _assert_topk(kind, d_port, i_port, d_ref, i_ref):
    d_port, d_ref = np.asarray(d_port), np.asarray(d_ref)
    i_port, i_ref = np.asarray(i_port), np.asarray(i_ref)
    if kind == "int":
        np.testing.assert_array_equal(i_port, i_ref)
        np.testing.assert_array_equal(d_port.view(np.int32), d_ref.view(np.int32))
        return
    fin = np.isfinite(d_ref)
    scale = np.abs(np.where(fin, d_ref, 0)).max(axis=-1, keepdims=True) + 1e-30
    tol = RTOL * scale
    np.testing.assert_array_equal(np.isfinite(d_port), fin)
    diff = np.abs(np.where(fin, d_port, 0) - np.where(fin, d_ref, 0))
    assert (diff <= tol).all()
    # ids must agree where both neighbours stand further than tol away
    big_d = np.where(fin, d_ref, np.finfo(np.float32).max)
    gap = np.diff(big_d.astype(np.float64), axis=-1)
    big = np.full(d_ref.shape, np.inf)
    lo = np.concatenate([big[..., :1], gap], axis=-1)
    hi = np.concatenate([gap, big[..., :1]], axis=-1)
    apart = (np.minimum(lo, hi) > tol) & fin
    np.testing.assert_array_equal(i_port[apart], i_ref[apart])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the device functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_reference(kind, metric):
    V, Q = _data(kind, 300, 48, 1)
    sq = (V * V).sum(1)
    got = vector._distances_batch(_t(V), _t(sq), _t(Q), metric).numpy()
    want = np.asarray(ref_vector._distances_batch(jnp.asarray(V), jnp.asarray(sq), jnp.asarray(Q), metric))
    one = vector._distances(_t(V), _t(sq), _t(Q[0]), metric).numpy()
    ref_one = np.asarray(ref_vector._distances(jnp.asarray(V), jnp.asarray(sq), jnp.asarray(Q[0]), metric))
    if kind == "int":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(one, ref_one)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)
        np.testing.assert_allclose(one, ref_one, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("npool", [1, 10, 80, 512])
def test_brute_matches_reference(kind, metric, npool):
    V, Q = _data(kind, 512, 32, npool)
    sq = (V * V).sum(1)
    valid = np.random.default_rng(2).random(len(V)) > 0.2  # +inf rows
    d, i = vector._jit_brute_batch(metric, npool)(_t(V), _t(sq), _t(valid), _t(Q))
    rd, ri = ref_vector._jit_brute_batch(metric, npool)(
        jnp.asarray(V), jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(Q)
    )
    _assert_topk(kind, d, i, rd, ri)
    d1, i1 = vector._jit_brute(metric, npool)(_t(V), _t(sq), _t(valid), _t(Q[1]))
    rd1, ri1 = ref_vector._jit_brute(metric, npool)(
        jnp.asarray(V), jnp.asarray(sq), jnp.asarray(valid), jnp.asarray(Q[1])
    )
    _assert_topk(kind, d1, i1, rd1, ri1)


def _slab_layout(kind, seed, nlist=12, n=900, d=16):
    """A slab layout built the reference's way (host numpy), as both
    packages' device functions take it."""
    V, Q = _data(kind, n, d, seed, nq=5)
    cents = V[np.random.default_rng(seed).choice(n, nlist, replace=False)]
    cell = ref_vector._assign_top1(V, cents)
    S = ref_vector._SLAB
    order = np.argsort(cell, kind="stable")
    lens = np.bincount(cell, minlength=nlist)
    per = np.maximum(1, -(-lens // S))
    rows = np.full((per.sum(), S), -1, np.int32)
    slab_cell = np.repeat(np.arange(nlist), per).astype(np.int32)
    off = 0
    for c in range(nlist):
        r = order[lens[:c].sum() : lens[: c + 1].sum()]
        rows.reshape(-1)[off * S : off * S + len(r)] = r
        off += per[c]
    fv = np.where(rows[..., None] >= 0, V[np.maximum(rows, 0)], 0).astype(np.float32)
    args = (cents, (cents * cents).sum(1), slab_cell, fv, (fv * fv).sum(2), rows)
    return args, Q


@pytest.mark.parametrize("kind", ["int", "gauss"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m_slabs,npool", [(3, 10), (6, 128), (10, 10 * 128)])
def test_ivf_probe_matches_reference(kind, metric, m_slabs, npool):
    args, Q = _slab_layout(kind, m_slabs + npool)
    d, rows = vector._jit_ivf_batch(metric, m_slabs, npool)(*map(_t, args), _t(Q))
    rd, rrows = ref_vector._jit_ivf_batch(metric, m_slabs, npool)(
        *map(jnp.asarray, args), jnp.asarray(Q)
    )
    _assert_topk(kind, d, rows, rd, rrows)
    d1, r1 = vector._jit_ivf(metric, m_slabs, npool)(*map(_t, args), _t(Q[2]))
    rd1, rr1 = ref_vector._jit_ivf(metric, m_slabs, npool)(
        *map(jnp.asarray, args), jnp.asarray(Q[2])
    )
    _assert_topk(kind, d1, r1, rd1, rr1)


@pytest.mark.parametrize("metric", METRICS)
def test_slab_scan_plain_matches_reference_gather(metric):
    """KV2's plain version against the reference probe's gather and
    distances (exact on integer data)."""
    args, Q = _slab_layout("int", 3)
    _, _, _, fv, fsq, rows = args
    sidx = np.stack([np.random.default_rng(i).permutation(len(rows))[:5] for i in range(len(Q))])
    got = ivf_scan.slab_distances(
        _t(fv), _t(fsq), _t(rows), _t(sidx.astype(np.int32)), _t(Q),
        vector_topk.query_stat(_t(Q), metric), metric,
    ).numpy()
    for i in range(len(Q)):
        Vs = fv[sidx[i]].reshape(-1, fv.shape[2])
        want = np.asarray(ref_vector._distances(
            jnp.asarray(Vs), jnp.asarray(fsq[sidx[i]].reshape(-1)), jnp.asarray(Q[i]), metric
        ))
        want = np.where(rows[sidx[i]].reshape(-1) >= 0, want, np.inf)
        np.testing.assert_array_equal(got[i], want)


def test_topk_order_is_lax_top_k():
    """-0.0 before 0.0, -inf first, NaN after +inf, ties to the lower
    index: what lax.top_k(-d) gives on jax-CPU."""
    d = np.array([[0.0, -0.0, 1.0, 0.0, -0.0, np.inf, np.nan, -np.inf, np.inf, 1.0]], np.float32)
    neg, ridx = jax.lax.top_k(-jnp.asarray(d), d.shape[1])
    assert np.asarray(ridx)[0].tolist() == [7, 1, 4, 0, 3, 2, 9, 5, 8, 6]
    for k in (1, 3, 10):
        got_d, got_i = vector_topk.topk(_t(d), k, "distance")
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ridx)[:, :k])
        np.testing.assert_array_equal(
            got_d.numpy().view(np.int32), (-np.asarray(neg)[:, :k]).view(np.int32)
        )


def test_topk_plain_counts_apart_from_launches():
    x = torch.zeros((2, 8))
    launches, plain = vector_topk.LAUNCHES, vector_topk.PLAIN_CALLS
    vector_topk.topk(x, 3, "distance")
    assert (vector_topk.LAUNCHES, vector_topk.PLAIN_CALLS) == (launches, plain + 1)


@pytest.mark.parametrize(
    "call",
    [
        lambda x: vector_topk.topk(x, 9, "distance"),  # k > n
        lambda x: vector_topk.topk(x, 0, "distance"),
        lambda x: vector_topk.topk(x.double(), 2, "distance"),
        lambda x: vector_topk.topk(x, 2, "euclidean"),  # no sqnorm / qstat
        lambda x: vector_topk.topk(x, 2, "hamming"),
        lambda x: vector_topk.topk(x, 2, "dotproduct", valid=torch.ones(3, dtype=torch.bool)),
        # more columns than the kernel's pow2 sort fits in an int32 (a
        # zero-stride view: no 4 GiB tensor)
        lambda x: vector_topk.topk(
            x, 1, "distance",
            col_index=torch.zeros(1, dtype=torch.int32).expand(vector_topk.MAX_N + 1),
        ),
    ],
)
def test_topk_rejects_bad_inputs(call):
    with pytest.raises(ValueError):
        call(torch.zeros((2, 8)))


@pytest.mark.parametrize("before", [True, False])
def test_f32_matmul_leaves_the_callers_tf32_flag(before):
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    try:
        flags.allow_tf32 = before
        a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        np.testing.assert_array_equal(vector_topk.f32_matmul(a, a.T).numpy(), (a @ a.T).numpy())
        assert flags.allow_tf32 is before
    finally:
        flags.allow_tf32 = saved


# ---------------------------------------------------------------------------
# whole indexes: the cases of tests/test_vector.py
# ---------------------------------------------------------------------------


def _pair(**kw):
    return ref_vector.VectorIndex("emb", **kw), vector.VectorIndex("emb", device="cpu", **kw)


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_exact_both(float_paths, metric):
    rng = np.random.default_rng(0)
    V = rng.standard_normal((500, 32)).astype(np.float32)
    ref, port = _pair(metric=metric)
    for u, v in zip(range(1, 501), V):
        ref.insert(u, v)
        port.insert(u, v)
    for _ in range(4):
        q = rng.standard_normal(32).astype(np.float32)
        np.testing.assert_array_equal(port.search(q, 10), ref.search(q, 10))
        Q = rng.standard_normal((3, 32)).astype(np.float32)  # padded to 4
        np.testing.assert_array_equal(port.search_batch(Q, 7), ref.search_batch(Q, 7))
        np.testing.assert_array_equal(port.search_one(q, 5), ref.search_one(q, 5))


def test_insert_update_remove_filtered_threshold(float_paths):
    ref, port = _pair()
    for idx in (ref, port):
        idx.insert(1, [0.0, 0.0])
        idx.insert(2, [1.0, 1.0])
        idx.insert(3, [5.0, 5.0])
    got = []
    for idx in (ref, port):
        out = [list(idx.search([0.1, 0.1], 2))]
        idx.insert(1, [10.0, 10.0])
        out.append(list(idx.search([0.1, 0.1], 2)))
        idx.remove(2)
        out.append(list(idx.search([0.1, 0.1], 3)))
        out.append(len(idx))
        got.append(out)
    assert got[0] == got[1] == [[1, 2], [2, 3], [3, 1], 2]
    ref, port = _pair()
    for idx in (ref, port):
        for u in range(1, 11):
            idx.insert(u, [float(u), 0.0])
    for kw, want in (
        ({"allowed": np.array([4, 5, 6], np.uint64)}, [4, 5, 6]),
        ({"distance_threshold": 9.1}, [1, 2, 3]),
        ({"ef": 8, "allowed": np.array([9, 10], np.uint64)}, [9, 10]),
    ):
        k = 3 if "allowed" in kw else 10
        assert list(port.search([0.0, 0.0], k, **kw)) == list(ref.search([0.0, 0.0], k, **kw)) == want
    assert list(port.search_with_uid(3, 2)) == list(ref.search_with_uid(3, 2)) == [2, 4]


@pytest.mark.parametrize("n,far", [(3000, False), (20_000, True)])
def test_filtered_search_widens_to_the_whole_set(float_paths, n, far):
    """The allowed filter widens the pool 4x until k survivors or the
    live set is exhausted: npool reaches n, where KV1 takes the whole row.
    With `far`, the allowed uids are the two farthest from the query, so
    the pool widens past 16,384 (k = 8, 32, ..., 8192, then n)."""
    rng = np.random.default_rng(5)
    V = rng.integers(-8, 9, (n, 8)).astype(np.float32)
    ref, port = _pair(ivf_threshold=1 << 62)
    uids = np.arange(1, n + 1, dtype=np.uint64)
    ref.bulk_load(uids, V)
    port.bulk_load(uids, V.copy())
    q = V[5]
    if far:
        dist = ((V - q) ** 2).sum(1)
        allowed = np.sort(np.argsort(dist, kind="stable")[-2:] + 1).astype(np.uint64)
    else:
        allowed = np.array([7, 2999], np.uint64)
    got = port.search(q, 2, allowed=allowed)
    np.testing.assert_array_equal(got, ref.search(q, 2, allowed=allowed))
    assert sorted(got.tolist()) == allowed.tolist()


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_ivf_same_layout_and_answers(float_paths, kind):
    """IVF tier: the same centroids and slabs (host numpy, seed 0) on
    both sides, the same slab selections, the same answers."""
    V, _ = _data(kind, 4000, 16, 1)
    rng = np.random.default_rng(7)
    uids = np.arange(1, 4001, dtype=np.uint64)
    ref, port = _pair(ivf_threshold=1000, nprobe=4)  # probes 8 slabs of 126 cells
    ref.bulk_load(uids, V)
    port.bulk_load(uids, V.copy())
    Q = (V[rng.integers(0, 4000, 6)] + rng.integers(-1, 2, (6, 16))).astype(np.float32)
    ivf_paths = vector.COUNTERS.path_jit_ivf
    for q in Q:
        np.testing.assert_array_equal(port.search(q, 10), ref.search(q, 10))
        np.testing.assert_array_equal(port.search(q, 10, ef=64), ref.search(q, 10, ef=64))
    np.testing.assert_array_equal(port.search_batch(Q[:1], 10), ref.search_batch(Q[:1], 10))
    r, p = ref._ivf, port._ivf
    assert p is not None and vector.COUNTERS.path_jit_ivf > ivf_paths
    for key in ("m_slabs", "n_slabs"):
        assert p[key] == r[key]
    np.testing.assert_array_equal(p["centroids"], r["centroids"])
    for key in ("slab_cell", "flat_rows", "flat_sq"):
        np.testing.assert_array_equal(p["dev"][key].numpy(), np.asarray(r["dev"][key]))
    # the slabs each query probes
    for q in Q:
        args = [p["dev"][k] for k in ("cents", "csq", "slab_cell")]
        qt = _t(q)[None, :]
        _, sidx = vector_topk.topk(
            vector_topk.f32_matmul(qt, args[0].T), p["m_slabs"], "euclidean",
            sqnorm=args[1], qstat=vector_topk.query_stat(qt, "euclidean"), col_index=args[2],
        )
        cd = np.asarray(r["dev"]["csq"]) - 2.0 * (np.asarray(r["dev"]["cents"]) @ q) + (q * q).sum()
        _, ref_sidx = jax.lax.top_k(-jnp.asarray(cd[np.asarray(r["dev"]["slab_cell"])]), r["m_slabs"])
        if kind == "int":
            np.testing.assert_array_equal(sidx[0].numpy(), np.asarray(ref_sidx))
        else:
            assert set(sidx[0].tolist()) == set(np.asarray(ref_sidx).tolist())


def test_ivf_recall_port(float_paths):
    """tests/test_vector.py::test_ivf_recall on the port."""
    rng = np.random.default_rng(1)
    n, d, k = 4000, 16, 10
    V = rng.standard_normal((n, d)).astype(np.float32)
    idx = vector.VectorIndex("emb", ivf_threshold=1000, nprobe=16, device="cpu")
    for u, v in zip(range(1, n + 1), V):
        idx.insert(u, v)
    idx._sync_device()
    assert idx._ivf is not None
    hits = 0
    for _ in range(20):
        q = rng.standard_normal(d).astype(np.float32)
        exact = np.argsort(((V - q) ** 2).sum(1), kind="stable")[:k] + 1
        hits += len(set(idx.search(q, k).tolist()) & set(exact.tolist()))
    assert hits / (20 * k) >= 0.90


@pytest.mark.parametrize("ivf_threshold", [1 << 62, 2000])
def test_quantized_engine_equals_reference(monkeypatch, ivf_threshold):
    """VEC_QUANT at its default: the CPU-bound port takes the quantized
    engine (a verbatim copy) exactly where the reference on jax-CPU does."""
    monkeypatch.delenv("DGRAPH_TPU_VEC_QUANT", raising=False)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((200, 24)).astype(np.float32)
    V = base[rng.integers(0, 200, 6000)] + np.float32(0.05) * rng.standard_normal((6000, 24)).astype(np.float32)
    uids = np.arange(1, 6001, dtype=np.uint64)
    ref, port = _pair(ivf_threshold=ivf_threshold)
    ref.bulk_load(uids, V)
    port.bulk_load(uids, V.copy())
    assert port._use_quant() and ref._use_quant()
    Q = base[:5] + np.float32(1e-3)
    np.testing.assert_array_equal(port.search_batch(Q, 12), ref.search_batch(Q, 12))
    for q in Q:
        np.testing.assert_array_equal(port.search(q, 12), ref.search(q, 12))
    port.remove(7)
    ref.remove(7)
    np.testing.assert_array_equal(port.search(V[6], 3), ref.search(V[6], 3))


def test_cuda_index_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        vector.VectorIndex("emb")
    assert vector.VectorIndex("emb", device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# similar_to through the servers
# ---------------------------------------------------------------------------

SCHEMA = 'embedding: float32vector @index(hnsw(metric:"euclidean")) .\nname: string @index(exact) .'
RDF = "\n".join([
    '<0x1> <name> "a" .', '<0x1> <embedding> "[1.0, 0.0]"^^<float32vector> .',
    '<0x2> <name> "b" .', '<0x2> <embedding> "[0.9, 0.1]"^^<float32vector> .',
    '<0x3> <name> "c" .', '<0x3> <embedding> "[-1.0, 0.5]"^^<float32vector> .',
    '<0x4> <name> "d" .', '<0x4> <embedding> "[0.9, 0.1]"^^<float32vector> .',
])
QUERIES = [
    '{ v(func: similar_to(embedding, 2, "[1.0, 0.05]")) { name } }',
    '{ v(func: similar_to(embedding, 2, 0x3)) { name } }',
    '{ v(func: uid(0x1)) { embedding } }',
    '{ v(func: similar_to(embedding, 3, "[1.0, 0.05]", ef: 8)) { uid name } }',
    '{ v(func: similar_to(embedding, 4, "[1.0, 0.05]", distance_threshold: 0.05)) { name } }',
    '{ v(func: eq(name, ["a", "c", "d"])) @filter(similar_to(embedding, 2, "[1.0, 0.05]")) { name } }',
    '{ q as var(func: eq(name, "c")) { e as embedding } '
    'v(func: similar_to(embedding, 2, val(e))) { name } }',
]
DELETE = "<0x1> <embedding> * ."


def _bytes(server, q):
    try:
        return server.query(q, want="raw")["data"].raw
    except Exception as exc:  # the error surface is part of the answer
        return f"{type(exc).__name__}: {exc}"


def _load(server):
    server.alter(SCHEMA)
    server.new_txn().mutate_rdf(set_rdf=RDF, commit_now=True)
    return server


def test_similar_to_bytes_equal_reference(float_paths):
    from dgraph_tpu.api.server import Server as RefServer
    from dgraph_tpu_torch.api.server import Server

    ref, port = _load(RefServer()), _load(Server(device="cpu"))
    assert port.vector_indexes["embedding"].device.type == "cpu"
    for q in QUERIES:
        assert _bytes(port, q) == _bytes(ref, q), q
    for s in (ref, port):
        s.new_txn().mutate_rdf(del_rdf=DELETE, commit_now=True)
    for q in QUERIES:
        assert _bytes(port, q) == _bytes(ref, q), q
    assert json.loads(_bytes(port, QUERIES[0])) == {"v": [{"name": "b"}, {"name": "d"}]}
    for s in (ref, port):
        s.alter(drop_attr="embedding")
    assert "embedding" not in port.vector_indexes
    assert _bytes(port, QUERIES[0]) == _bytes(ref, QUERIES[0])


def test_carried_store_answers_similar_to(float_paths):
    from dgraph_tpu.admin.export import _schema_line
    from dgraph_tpu.api.server import Server as RefServer
    from dgraph_tpu_torch.carry import carry_state

    ref = _load(RefServer())
    ref.new_txn().mutate_rdf(set_rdf='<0x2> <embedding> "[0.5, 0.5]"^^<float32vector> .',
                             commit_now=True)
    text = "\n".join(_schema_line(ref.schema.get(p)) for p in ref.schema.predicates())
    port = carry_state(ref.kv.dump_bytes(), text, ref.zero._max_uid, ref.zero.max_assigned,
                       device="cpu")
    assert len(port.vector_indexes["embedding"]) == 4
    for q in QUERIES:
        assert _bytes(port, q) == _bytes(ref, q), q


def test_serve_vectors_phase_on_cpu(float_paths):
    """chip_smoke's vector main path (phase 7), rehearsed at a tiny size
    on the CPU: the plain versions run, no kernel launches; read (i), the
    filtered `similar_to`, equals the exact top-k of its allowed set."""
    import chip_smoke

    out = chip_smoke.serve_vectors(
        "cpu", n=6000, d=16, n_named=500, n_small=1000, nq=16,
        ivf_threshold=2000, reps=1, log=lambda m: None,
    )
    assert out["launches"] == {"vector_topk": 0, "ivf_slab_scan": 0}
    assert min(out["plain_calls"].values()) >= 1
    assert out["recall"] >= 0.90 and out["batch_exact_ids"] == 16
    # read (i) widened its pool 4x a step up to the live set
    assert out["filtered_ks"] == [40, 160, 640, 1000] and out["topk_per_read"]["i"] == 4
    topk_sites, slab_sites = out["captured"]
    assert any(gathered for (_, _, _, gathered) in topk_sites) and slab_sites


# ---------------------------------------------------------------------------
# Batch-width independence: a solo search equals its row of a coalesced one
# ---------------------------------------------------------------------------

BW_N, BW_D = 20_000, 768
TIERS = {"brute": dict(ivf_threshold=1 << 62), "ivf": dict(ivf_threshold=2000, nprobe=2)}


@pytest.fixture(scope="module")
def width_indexes():
    """Both packages' indexes over one Gaussian (20,000, 768) corpus, per
    tier, on the float paths. nprobe 2 keeps the IVF tier chosen for every
    batch width up to 5 (`_ivf_pick`)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    rng = np.random.default_rng(21)
    V = rng.standard_normal((BW_N, BW_D)).astype(np.float32)
    Q = rng.standard_normal((5, BW_D)).astype(np.float32)
    uids = np.arange(1, BW_N + 1, dtype=np.uint64)
    out = {}
    for tier, kw in TIERS.items():
        ref, port = _pair(**kw)
        ref.bulk_load(uids, V)
        port.bulk_load(uids, V.copy())
        out[tier] = (ref, port)
    yield V, Q, out
    mp.undo()


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_solo_search_is_its_row_of_every_batch_width(width_indexes, float_paths, tier, width):
    """`search_one(Q[i])` equals row i of `search_batch(Q[:width])`
    exactly (the micro-batcher's promise), on the tier the index picks
    for both; and the batch equals the reference's wherever neighbours
    stand further apart than f32 rounding."""
    V, Q, idx = width_indexes
    ref, port = idx[tier]
    ivf = vector.COUNTERS.path_jit_ivf
    batch = port.search_batch(Q[:width], 10)
    assert (vector.COUNTERS.path_jit_ivf - ivf == width) == (tier == "ivf")
    for i in range(width):
        np.testing.assert_array_equal(port.search_one(Q[i], 10), batch[i])
    want = ref.search_batch(Q[:width], 10)
    for i in range(width):
        if not np.array_equal(batch[i], want[i]):
            d = [np.sort(((V[np.asarray(r, np.int64) - 1] - Q[i]).astype(np.float64) ** 2).sum(1))
                 for r in (batch[i], want[i])]
            scale = float(d[1].max())
            assert np.abs(d[0] - d[1]).max() <= RTOL * scale


@pytest.mark.parametrize("width", [2, 3, 4, 5])
def test_row_scores_do_not_depend_on_batch_width(width_indexes, float_paths, width):
    """The device functions behind both tiers give each row the same
    distances bit for bit alone and at every width up to
    vector_topk.MIN_ROWS: the GEMM and |q|^2 run at that width at least
    (BLAS picks its kernel, and so each dot's order of sums, by the row
    count)."""
    _, Q, idx = width_indexes
    port = idx["ivf"][1]
    port._sync_device()
    dev, ivf = port._device, port._ivf
    Qt = _t(Q[:width])
    brute = vector._jit_brute_batch("euclidean", 10)
    m, npool = vector._probe_plan(ivf, 40)
    probe = vector._ivf_probe("euclidean", m, npool)
    args = [ivf["dev"][k] for k in ("cents", "csq", "slab_cell", "flat_vecs", "flat_sq", "flat_rows")]
    b_d, b_i = brute(dev["vecs"], dev["sqnorm"], dev["valid"], Qt)
    p_d, p_i = probe(*args, Qt)
    for i in range(width):
        s_d, s_i = brute(dev["vecs"], dev["sqnorm"], dev["valid"], Qt[i : i + 1])
        assert torch.equal(s_d[0], b_d[i]) and torch.equal(s_i[0], b_i[i])
        s_d, s_i = probe(*args, Qt[i : i + 1])
        assert torch.equal(s_d[0], p_d[i]) and torch.equal(s_i[0], p_i[i])
