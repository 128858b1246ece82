"""KV1 (vector top-k) and KV2 (IVF slab scan) on the card.

`dgraph_tpu_torch/ops/vector_topk.py` and `ops/ivf_scan.py` hold the
hand-written CUDA kernels' wrappers and, beside them, the plain PyTorch
versions that CPU tensors take (held against the JAX package in
tests/test_torch_vector.py). Here each kernel runs against its plain
version on the same card tensors:

- KV1 must equal `topk_plain` bit for bit (distances and columns) for
  k in {1, 10, 80, 515, n}, rows up to 2^20, every metric, duplicate
  vectors, invalid (+inf) rows, the total order of ready distances
  (-0.0, +-inf, NaN) and rows full of them, the gathered-column form,
  both sides of the one-pass / radix switch, one row split over many
  CTAs (the last one merges their lists), 65,535 rows, zero query rows
  (a padded batch), rows of all-equal keys, and calls back to back
  (the kernel's tickets and histograms must come back to zero by
  themselves);
- KV2 must agree with `slab_distances_plain` to `ivf_scan.tolerance`
  (the kernel sums each dot in its own order), on ragged slabs.

Every test is marked `cuda` and skips without a card. They import no
jax, so they also run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_vector_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.ops import ivf_scan, vector_topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ only")
    return torch.device("cuda")


def _corpus(seed, n, d, kind):
    """(V (n, d), Q (4, d)) float32 from a numpy seed. "dup": 64 distinct
    vectors repeated; "int": small integers (exact dots); "gauss": normal;
    "const": every row the same vector. Q is three queries and a zero row,
    as `search_batch` pads a batch of 3 to 4."""
    rng = np.random.default_rng(seed)
    if kind == "dup":
        V = rng.standard_normal((64, d)).astype(np.float32)[rng.integers(0, 64, n)]
    elif kind == "int":
        V = rng.integers(-8, 9, (n, d)).astype(np.float32)
    elif kind == "const":
        V = np.repeat(rng.standard_normal((1, d)).astype(np.float32), n, 0)
    else:
        V = rng.standard_normal((n, d)).astype(np.float32)
    Q = np.vstack([rng.standard_normal((3, d)), np.zeros((1, d))]).astype(np.float32)
    return V, Q


def _topk_args(V, Q, metric, invalid, seed, dev):
    Vt, Qt = torch.from_numpy(V).to(dev), torch.from_numpy(Q).to(dev)
    x = vector_topk.f32_matmul(Qt, Vt.T).contiguous()
    valid = torch.from_numpy(np.random.default_rng(seed).random(len(V)) >= invalid).to(dev)
    return x, (Vt * Vt).sum(1), valid, vector_topk.query_stat(Qt, metric)


def _same(got, want):
    (gd, gi), (wd, wi) = got, want
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    # bitwise: -0.0 and 0.0, NaN payloads included
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))


CASES = [  # (n, d, kind, invalid share, ks)
    (256, 8, "int", 0.0, (1, 10, 80, 256)),
    (4096, 32, "dup", 0.25, (1, 10, 80, 515, 2048, 2049, 4096)),
    (100_000, 16, "gauss", 0.1, (1, 10, 80, 515, 100_000)),
    (1 << 20, 8, "dup", 0.03, (1, 10, 80, 515, 1 << 20)),
    (1 << 16, 8, "const", 0.0, (1, 10, 515, 2048, 1 << 16)),
]


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dotproduct"])
@pytest.mark.parametrize("n,d,kind,invalid,ks", CASES, ids=lambda c: str(c))
def test_topk_kernel_equals_plain(card, metric, n, d, kind, invalid, ks):
    V, Q = _corpus(n + d, n, d, kind)
    x, sq, valid, qs = _topk_args(V, Q, metric, invalid, n, card)
    for k in ks:
        launches = vector_topk.LAUNCHES
        got = vector_topk.topk(x, k, metric, sqnorm=sq, valid=valid, qstat=qs)
        assert vector_topk.LAUNCHES == launches + 1
        _same(got, vector_topk.topk_plain(x, k, metric, sq, valid, qs))


def test_topk_select_sort_switch(card):
    """Both sides of the regimes' switch (one pass up to
    `onepass_max_k()` on a row short enough for one CTA, radix above), on
    one corpus."""
    omax = vector_topk.onepass_max_k()
    V, Q = _corpus(11, 2 * omax + 3, 16, "gauss")
    x, sq, valid, qs = _topk_args(V, Q, "euclidean", 0.1, 11, card)
    n = x.shape[1]
    assert vector_topk.onepass(4, n, omax) and not vector_topk.onepass(4, n, omax + 1)
    for k in (omax, omax + 1):
        got = vector_topk.topk(x, k, "euclidean", sqnorm=sq, valid=valid, qstat=qs)
        _same(got, vector_topk.topk_plain(x, k, "euclidean", sq, valid, qs))


def test_topk_launch_counts(card):
    """The launch plan the library reports, which chip_smoke.py uses to
    scale traced kernel times to one call: one launch where the switch
    takes one pass (the served shapes among them); otherwise one radix
    pass per 12 bits of the (32 + ceil(log2 n))-bit keys (none for k = n,
    where every key is selected), a collect, a tile sort and one merge per
    doubling of 4096-key runs up to k."""
    assert vector_topk.MAX_N == vector_topk._kernel().vector_topk_max_n()
    omax = vector_topk.onepass_max_k()
    one = {"topk_onepass_kernel": 1}
    for rows, n, k in ((64, 1 << 20, 10), (1, 1 << 17, 10), (1, 67_840, 80),
                       (1, 67_840, 128), (1, 17_103, 530), (1, omax, omax)):
        assert vector_topk.onepass(rows, n, k)
        assert vector_topk.launch_counts(rows, n, k) == one, (rows, n, k)
    for n, k in ((omax + 1, omax + 1), (1 << 20, omax + 1), (1 << 20, 16_385),
                 (1 << 20, 1 << 20), (vector_topk.MAX_N, 5000)):
        merges = max(0, (-(-k // 4096) - 1).bit_length())
        want = {"topk_collect_kernel": 1, "topk_tile_kernel": 1}
        if k < n:
            want["topk_radix_kernel"] = -(-(32 + (n - 1).bit_length()) // 12)
        if merges:
            want["topk_merge_kernel"] = merges
        assert vector_topk.launch_counts(1, n, k) == want, (n, k)
    with pytest.raises(ValueError):
        vector_topk.launch_counts(1, vector_topk.MAX_N + 1, 1)


def _k_of(name, n, rows=1):
    """k by name: "max" the one-pass regime's largest k, "limit" the
    largest it takes on rows x n, "n" the whole row, else a number."""
    omax = vector_topk.onepass_max_k()
    limit = max(k for k in range(1, min(n, omax) + 1) if vector_topk.onepass(rows, n, k))
    named = {"max": omax, "max+1": omax + 1, "limit": limit, "limit+1": limit + 1, "n": n}
    return named.get(name) or int(name)


@pytest.mark.parametrize("k", ["1", "10", "limit", "limit+1", "530", "max", "max+1", "16385"])
def test_topk_one_row_many_ctas(card, k):
    """One row of 2^20 is cut over many CTAs; the last one to finish
    merges the others' lists (one pass) or settles the row's histogram
    (radix). "limit": the largest k the switch takes in one pass here."""
    V, Q = _corpus(21, 1 << 20, 8, "gauss")
    x, sq, valid, qs = _topk_args(V, Q[:1], "euclidean", 0.03, 21, card)
    k = _k_of(k, 1 << 20)
    _same(vector_topk.topk(x, k, "euclidean", sqnorm=sq, valid=valid, qstat=qs),
          vector_topk.topk_plain(x, k, "euclidean", sq, valid, qs))


@pytest.mark.parametrize("k", ["1", "10", "max", "max+1", "n"])
def test_topk_rows_of_special_values(card, k):
    """Ready distances where 30% are NaN, +inf, -inf, -0.0 or 0.0."""
    rng = np.random.default_rng(31)
    n = 50_000
    d = rng.standard_normal((4, n)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0], np.float32)
    d = np.where(rng.random(d.shape) < 0.3, special[rng.integers(0, 5, d.shape)], d)
    x = torch.from_numpy(d.astype(np.float32)).to(card)
    k = _k_of(k, n)
    _same(vector_topk.topk(x, k, "distance"), vector_topk.topk_plain(x, k, "distance"))


def test_topk_most_rows(card):
    """65,535 rows (the grid's limit) of a small n, one CTA each."""
    V, _ = _corpus(41, 64, 16, "gauss")
    Q = np.random.default_rng(41).standard_normal((65535, 16)).astype(np.float32)
    x, sq, valid, qs = _topk_args(V, Q, "euclidean", 0.1, 41, card)
    for k in (1, 10, 64):
        _same(vector_topk.topk(x, k, "euclidean", sqnorm=sq, valid=valid, qstat=qs),
              vector_topk.topk_plain(x, k, "euclidean", sq, valid, qs))


@pytest.mark.parametrize("k", ["10", "max", "max+1", "n"])
def test_topk_back_to_back(card, k):
    """Calls back to back, with no memset between them, give equal
    answers, and leave the kernel's state at zero."""
    V, Q = _corpus(51, 100_000, 8, "dup")
    x, sq, valid, qs = _topk_args(V, Q, "euclidean", 0.1, 51, card)
    k = _k_of(k, 100_000)
    args = (x, k, "euclidean", sq, valid, qs)
    first = vector_topk.topk(*args)
    second = vector_topk.topk(*args)
    want = vector_topk.topk_plain(*args)
    _same(first, want)
    _same(second, want)
    assert all(int(t.abs().sum()) == 0 for t in vector_topk._STATE.values())


def test_topk_total_order_of_ready_distances(card):
    """-0.0 before 0.0, -inf first, NaN after +inf, ties to the lower
    column: lax.top_k's order of -d (pinned on jax-CPU in
    tests/test_torch_vector.py)."""
    d = torch.tensor([[0.0, -0.0, 1.0, 0.0, -0.0, np.inf, np.nan, -np.inf, np.inf, 1.0]],
                     device=card)
    for k in (1, 4, 10):
        got = vector_topk.topk(d, k, "distance")
        _same(got, vector_topk.topk_plain(d, k, "distance"))
    assert got[1][0].tolist() == [7, 1, 4, 0, 3, 2, 9, 5, 8, 6]


@pytest.mark.parametrize("n_cols,k", [(3000, 1), (20_000, 527), (20_000, 2049), (40_000, 16_385)])
def test_topk_gathered_columns(card, n_cols, k):
    """The centroid step: columns of x picked by col_index (slab_cell),
    many columns sharing one (exact ties)."""
    rng = np.random.default_rng(n_cols + k)
    nlist, d = 2000, 32
    C = torch.from_numpy(rng.standard_normal((nlist, d)).astype(np.float32)).to(card)
    Q = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32)).to(card)
    cell = torch.from_numpy(np.sort(rng.integers(0, nlist, n_cols)).astype(np.int32)).to(card)
    x = vector_topk.f32_matmul(Q, C.T).contiguous()
    args = (x, k, "euclidean", (C * C).sum(1), None, vector_topk.query_stat(Q, "euclidean"), cell)
    _same(vector_topk.topk(*args), vector_topk.topk_plain(*args))


def _slabs(seed, n_slabs, d, dev):
    """A slab layout with ragged tails: each slab's rows past a random
    length are padding (flat_rows = -1, zero vectors)."""
    rng = np.random.default_rng(seed)
    fv = rng.standard_normal((n_slabs, ivf_scan.SLAB, d)).astype(np.float32)
    lens = rng.integers(1, ivf_scan.SLAB + 1, n_slabs)
    lens[::7] = ivf_scan.SLAB
    pad = np.arange(ivf_scan.SLAB)[None, :] >= lens[:, None]
    fv[pad] = 0.0
    rows = np.where(pad, -1, np.arange(n_slabs * ivf_scan.SLAB).reshape(n_slabs, -1))
    fsq = (fv * fv).sum(2)
    t = [torch.from_numpy(a).to(dev) for a in (fv, fsq, rows.astype(np.int32))]
    return t, rng


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dotproduct"])
@pytest.mark.parametrize("n_slabs,M,nq,d", [(40, 8, 1, 768), (600, 300, 5, 96), (64, 64, 3, 30)])
def test_slab_scan_within_tolerance(card, metric, n_slabs, M, nq, d):
    (fv, fsq, rows), rng = _slabs(n_slabs + M + d, n_slabs, d, card)
    sidx = torch.from_numpy(
        np.stack([rng.permutation(n_slabs)[:M] for _ in range(nq)]).astype(np.int32)
    ).to(card)
    Q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(card)
    qs = vector_topk.query_stat(Q, metric)
    launches = ivf_scan.LAUNCHES
    got = ivf_scan.slab_distances(fv, fsq, rows, sidx, Q, qs, metric)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES == launches + 1
    want = ivf_scan.slab_distances_plain(fv, fsq, rows, sidx, Q, qs, metric)
    pad = rows[sidx.long()].reshape(nq, -1) < 0
    assert torch.isinf(got[pad]).all() and torch.isinf(want[pad]).all()
    tol = ivf_scan.tolerance(fsq[sidx.long()].reshape(nq, -1), Q, metric)
    assert ((got - want).abs()[~pad] <= tol[~pad]).all()
