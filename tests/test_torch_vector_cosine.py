"""A cosine vector index served through `Server.query` `similar_to`,
against the plain reference `models/vector_reference.py`, on the CPU.

The rows are a seeded mixture of clusters, each a centre plus a
low-dimensional manifold plus noise, each row scaled to a lognormal norm
as an unnormalised embedding model gives them (the benchmark's
`vectordbbench-cohere-1m` configuration, at a small size). On the float
paths (`VEC_QUANT=0`, the card's paths):

- the brute tier (4,096 x 768) answers the reference's exact top-10;
- the IVF tier (20,000 x 64, an index built with a low `ivf_threshold`)
  holds recall@10 >= 0.95, with every answer ordered by its float64
  distances within the slab scan's float32 bound. On these rows cells
  trained by euclidean distance on the raw rows held 0.89: a cosine
  index trains and probes its cells on the unit-normalised rows, so its
  layout does not depend on the rows' norms, and keeps its centroids on
  the unit sphere (spherical k-means), so that no centroid shared by two
  clusters sinks toward the origin and becomes every row's second cell;
- a search opens a `vector_search` span with its route, k, pool and
  slabs, an IVF search an `ivf_probe` span inside it, the device sync a
  `vector_sync` and the IVF build an `ivf_train` span; the counters
  `vector_rows_scanned_total` and `vector_slabs_probed_total` count the
  rows scored and the slabs probed;
- a commit's vectors reach the index as one block, with the index left
  as row-by-row inserts would leave it;
- the reference is exact, and imports nothing of JAX nor of the port's
  kernels.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.api import server as server_module
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.models import vector, vector_reference
from dgraph_tpu_torch.utils import hosttrace
from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET
from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import keys

SCHEMA = 'emb: float32vector @index(hnsw(metric:"cosine")) .\nid: int @index(int) .'
# the top-k ranked by cosine distance, as Dgraph's documentation writes
# it (similar_to alone answers a uid set, in uid order)
READ = ('query r($v: float32vector = "{vec}") {{ '
        'var(func: similar_to(emb, {k}, $v)) {{ e as emb '
        's as math(1.0 - (e dot $v) / (sqrt(e dot e) * sqrt($v dot $v))) }} '
        'q(func: uid(s), orderasc: val(s)) {{ uid id score: val(s) }} }}')
UID_BASE = 0x10000
# the slab scan's float32 bound on a cosine distance (ops/ivf_scan.tolerance)
ORDER_TOL = 2e-5


def mixture(n, d, k, m, sigma, noise, norm_sigma, nq, seed):
    """n rows and nq queries of one mixture: Zipf(0.5) cluster sizes, each
    cluster a centre from N(0, I_d) plus an m-dim orthonormal basis times
    N(0, sigma^2), plus N(0, noise^2 I_d), each row then scaled to a
    lognormal(0, norm_sigma) norm."""
    r = np.random.default_rng(seed)
    C = r.standard_normal((k, d))
    B = np.linalg.qr(r.standard_normal((k, d, m)))[0]
    w = 1.0 / np.arange(1, k + 1) ** 0.5
    lab = r.choice(k, n + nq, p=w / w.sum())
    X = (C[lab] + np.einsum("ndm,nm->nd", B[lab], sigma * r.standard_normal((n + nq, m)))
         + noise * r.standard_normal((n + nq, d)))
    X *= (np.exp(norm_sigma * r.standard_normal(n + nq)) / np.linalg.norm(X, axis=1))[:, None]
    X = X.astype(np.float32)
    return X[:n], X[n:]


def load(server, V, block=2000):
    for s in range(0, len(V), block):
        objs = [{"uid": hex(UID_BASE + i), "id": i, "emb": v}
                for i, v in zip(range(s, s + block), V[s : s + block].tolist())]
        server.new_txn().mutate_json(set_obj=objs, commit_now=True)


def ask(server, q, k=10):
    """The answered rows of one read, in answered order, and their
    scores."""
    vec = json.dumps(q.astype(np.float64).tolist())
    got = json.loads(server.query(READ.format(k=k, vec=vec), want="raw")["data"].raw)["q"]
    assert all(int(o["uid"], 16) == UID_BASE + o["id"] for o in got)
    return [o["id"] for o in got], [o["score"] for o in got]


def wrong(V, q, answer):
    """Adjacent answered rows out of order by their float64 distances, and
    scores further than 1e-6 from them."""
    rows, score = answer
    d = vector_reference.distances(
        *(torch.from_numpy(x.astype(np.float64)) for x in (V[rows], q[None, :])), "cosine",
    )[0].numpy()
    return int((d[:-1] > d[1:] + ORDER_TOL).sum()), int((np.abs(d - score) > 1e-6).sum())


@pytest.fixture(scope="module")
def float_paths():
    mp = pytest.MonkeyPatch()
    mp.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def brute(float_paths):
    V, Q = mixture(4096, 768, k=16, m=32, sigma=4.0, noise=0.1, norm_sigma=0.25, nq=24, seed=3)
    s = Server(device="cpu")
    s.alter(SCHEMA)
    load(s, V)
    return s, V, Q


@pytest.fixture(scope="module")
def ivf(float_paths):
    V, Q = mixture(20000, 64, k=32, m=16, sigma=1.0, noise=0.1, norm_sigma=0.4, nq=200, seed=5)
    s = Server(device="cpu")
    s.alter(SCHEMA)
    s.vector_indexes["emb"] = vector.VectorIndex(
        "emb", metric="cosine", ivf_threshold=2000, device="cpu")
    load(s, V)
    return s, V, Q


def test_brute_tier_answers_the_exact_top_k(brute):
    s, V, Q = brute
    before = vector.COUNTERS.path_jit_brute
    want, _ = vector_reference.topk(V, Q, 10, "cosine")
    got = [ask(s, q) for q in Q]
    assert vector.COUNTERS.path_jit_brute - before == len(Q)
    assert [g[0] for g in got] == want.tolist()
    assert [wrong(V, q, g) for q, g in zip(Q, got)] == [(0, 0)] * len(Q)


def test_ivf_tier_holds_recall_and_order(ivf):
    s, V, Q = ivf
    before = vector.COUNTERS.path_jit_ivf
    want, _ = vector_reference.topk(V, Q, 10, "cosine")
    got = [ask(s, q) for q in Q]
    idx = s.vector_indexes["emb"]
    assert vector.COUNTERS.path_jit_ivf - before == len(Q)
    # the probe reads a small share of the rows, so the tier is approximate
    assert idx._ivf["m_slabs"] * vector._SLAB * 10 < len(V)
    assert vector_reference.recall([g[0] for g in got], want) >= 0.95
    assert all(len(g[0]) == 10 for g in got)
    assert [wrong(V, q, g) for q, g in zip(Q, got)] == [(0, 0)] * len(Q)
    # the read's order is the executor's float64 `math`; the index's own
    # ranking holds the slab scan's float32 bound too
    for q in Q:
        rows = [int(u) - UID_BASE for u in idx.search(q, 10)]
        d = vector_reference.distances(
            torch.from_numpy(V[rows].astype(np.float64)),
            torch.from_numpy(q[None, :].astype(np.float64)), "cosine")[0].numpy()
        assert (d[:-1] <= d[1:] + ORDER_TOL).all()


def _layout(V, metric):
    idx = vector.VectorIndex("emb", metric=metric, ivf_threshold=1000, device="cpu")
    idx.bulk_load(np.arange(1, len(V) + 1, dtype=np.uint64), V)
    idx._sync_device()
    return idx._ivf


def test_cosine_cells_do_not_depend_on_row_norms(float_paths):
    """A cosine index's cells are trained and assigned on the unit rows:
    rescaling every row leaves its layout as it was. A euclidean index
    keeps the raw geometry."""
    V, _ = mixture(4000, 32, k=8, m=8, sigma=1.0, noise=0.1, norm_sigma=0.4, nq=0, seed=9)
    scale = np.exp(np.random.default_rng(1).standard_normal(len(V))).astype(np.float32)[:, None]
    a, b = _layout(V, "cosine"), _layout(V * scale, "cosine")
    # spherical k-means: every centroid on the unit sphere
    np.testing.assert_allclose(np.linalg.norm(a["centroids"], axis=1), 1.0, atol=1e-5)
    for key in ("slab_cell", "flat_rows"):
        np.testing.assert_array_equal(a["dev"][key].numpy(), b["dev"][key].numpy())
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=0, atol=1e-5)
    # a euclidean index keeps the raw geometry: its centroids are means
    # of rows of unequal norm
    e = np.linalg.norm(_layout(V, "euclidean")["centroids"], axis=1)
    assert np.abs(e - 1.0).max() > 0.1


def test_cosine_cells_hold_no_catch_all(float_paths):
    """Clusters of unequal sizes, about one for two cells: means of unit
    rows from two clusters, left off the sphere, lay near the origin and
    drew a cell 48 times the mean cell (every row's second cell); on the
    sphere no cell passes 8 times the mean."""
    V, _ = mixture(40000, 256, k=200, m=32, sigma=4.0, noise=0.1, norm_sigma=0.25, nq=0, seed=5)
    lens = _layout(V, "cosine")["cell_lens"]
    assert lens.max() < 8 * lens.mean(), (lens.max(), lens.mean())


class _Closed:
    """Every span closed while installed, in closing order."""

    def __init__(self, monkeypatch):
        self.spans = []
        real = hosttrace.TimedSpan.close

        def close(sp):
            real(sp)
            self.spans.append(sp)

        monkeypatch.setattr(hosttrace.TimedSpan, "close", close)

    def named(self, name):
        return [s for s in self.spans if s.name == name]


def _counts():
    return (METRICS.value("vector_rows_scanned_total"),
            METRICS.value("vector_slabs_probed_total"))


@pytest.mark.parametrize("tier", ["ivf", "brute"])
def test_a_search_opens_its_spans_and_counts_its_rows(ivf, brute, tier, monkeypatch):
    s, V, Q = ivf if tier == "ivf" else brute
    idx = s.vector_indexes["emb"]
    idx._dirty = True  # the next read syncs the device state again
    closed = _Closed(monkeypatch)
    rows0, slabs0 = _counts()
    ask(s, Q[0])
    rows1, slabs1 = _counts()
    (sync,) = closed.named("vector_sync")
    assert sync.attrs["rows"] == len(V)
    (search,) = closed.named("vector_search")
    assert search.attrs["route"] == tier and search.attrs["k"] == 10
    assert search.attrs["pool"] >= 10
    # the sync (and the build) came before the search, not inside it
    assert sync.t1 <= search.t0
    if tier == "ivf":
        (train,) = closed.named("ivf_train")
        assert train.attrs["rows"] == len(V) and train.attrs["nlist"] == len(idx._ivf["centroids"])
        assert sync.t1 <= train.t0 and train.t1 <= search.t0
        (probe,) = closed.named("ivf_probe")
        m = idx._ivf["m_slabs"]
        assert search.attrs["m_slabs"] == probe.attrs["m_slabs"] == m > 0
        assert search.t0 <= probe.t0 and probe.t1 <= search.t1
        assert (rows1 - rows0, slabs1 - slabs0) == (m * vector._SLAB, m)
    else:
        assert not closed.named("ivf_train") and not closed.named("ivf_probe")
        assert search.attrs["m_slabs"] == 0
        assert (rows1 - rows0, slabs1 - slabs0) == (len(V), 0)
    # a second read finds the device state in sync
    closed.spans.clear()
    ask(s, Q[1])
    assert not closed.named("vector_sync") and len(closed.named("vector_search")) == 1


def _state(idx):
    n = idx._n
    return (idx._vecs[:n].copy(), idx._uid_of[:n].copy(), idx._valid[:n].copy(),
            dict(idx._rows), idx._live)


def _row_by_row(indexes, deltas):
    """Each posting of a commit applied on its own, in order."""
    for key, posts in deltas.items():
        pk = keys.parse_key(key)
        vidx = indexes.get(pk.attr)
        if vidx is not None and pk.is_data:
            for p in posts:
                if p.is_value and p.op == OP_SET:
                    vidx.insert(pk.uid, p.val().value)
                elif p.op == OP_DEL:
                    vidx.remove(pk.uid)


@pytest.mark.parametrize("later", ["none", "updates", "deletes"])
def test_a_commit_ingests_its_vectors_as_one_block(later, monkeypatch):
    """A commit of many rows reaches the index in one insert, and every
    commit leaves the index as row-by-row inserts and removes of its
    writes leave another."""
    rng = np.random.default_rng(2)
    V = rng.standard_normal((300, 8)).astype(np.float32)
    s = Server(device="cpu")
    s.alter(SCHEMA)
    model = {"emb": vector.VectorIndex("emb", metric="cosine", device="cpu")}
    calls = []
    real_insert, real_ingest = vector.VectorIndex.insert, server_module.ingest_vectors

    def counted(self, uid, vec):
        calls.append(np.asarray(vec).ndim)
        return real_insert(self, uid, vec)

    def ingest(indexes, deltas):
        real_ingest(indexes, deltas)
        _row_by_row(model, deltas)

    monkeypatch.setattr(server_module, "ingest_vectors", ingest)
    monkeypatch.setattr(vector.VectorIndex, "insert", counted)
    load(s, V, block=300)
    assert calls[0] == 2 and calls.count(2) == 1
    if later == "updates":
        upd = rng.standard_normal((4, 8)).astype(np.float32)
        s.new_txn().mutate_json(
            set_obj=[{"uid": hex(UID_BASE + i), "emb": v} for i, v in zip((3, 7, 11, 250), upd.tolist())],
            commit_now=True)
    elif later == "deletes":
        s.new_txn().mutate_rdf(
            del_rdf=f"<{hex(UID_BASE + 7)}> <emb> * .\n<{hex(UID_BASE + 9)}> <emb> * .",
            commit_now=True)
        s.new_txn().mutate_json(set_obj=[{"uid": hex(UID_BASE + 7), "emb": V[0].tolist()}],
                                commit_now=True)
    got, want = _state(s.vector_indexes["emb"]), _state(model["emb"])
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x, y)
    assert got[3:] == want[3:]
    assert got[4] == 300 - (later == "deletes")


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dotproduct"])
def test_reference_is_the_exact_top_k(metric):
    rng = np.random.default_rng(4)
    V = rng.standard_normal((3000, 24)).astype(np.float32)
    V[1500:1510] = V[10]  # ties: the lower row first
    Q = np.vstack([V[10:11], rng.standard_normal((5, 24)).astype(np.float32)])
    rows, dist = vector_reference.topk(V, Q, 12, metric)
    V64, Q64 = V.astype(np.float64), Q.astype(np.float64)
    if metric == "euclidean":
        full = ((Q64[:, None, :] - V64[None, :, :]) ** 2).sum(-1)
    elif metric == "cosine":
        full = 1 - (Q64 @ V64.T) / np.outer(np.linalg.norm(Q64, axis=1), np.linalg.norm(V64, axis=1))
    else:
        full = -(Q64 @ V64.T)
    for i in range(len(Q)):
        # the 12 nearest by float64, up to float32 rounding at the edge
        kth = np.sort(full[i])[11]
        assert len(set(rows[i].tolist())) == 12
        assert (full[i][rows[i]] <= kth + 1e-5).all()
        assert (np.sort(full[i])[:11] < full[i][rows[i]].max() + 1e-5).all()
        np.testing.assert_allclose(dist[i], full[i][rows[i]], rtol=0, atol=1e-4)
        assert (np.diff(dist[i]) >= 0).all()
    np.testing.assert_array_equal(rows[0][:11], [10] + list(range(1500, 1510)))


def test_reference_imports_no_jax_and_no_port_kernel():
    path = vector_reference.__file__
    tree = ast.parse(open(path).read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods == {"__future__", "numpy", "torch"}, mods
    assert os.path.basename(path) == "vector_reference.py"
