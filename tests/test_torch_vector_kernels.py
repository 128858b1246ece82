"""KV1 (vector top-k) and KV2 (IVF slab scan) on the card.

`dgraph_tpu_torch/ops/vector_topk.py` and `ops/ivf_scan.py` hold the
hand-written CUDA kernels' wrappers and, beside them, the plain PyTorch
versions that CPU tensors take (held against the JAX package in
tests/test_torch_vector.py). Here each kernel runs against its plain
version on the same card tensors:

- KV1 must equal `topk_plain` bit for bit (distances and columns) for
  k in {1, 10, 80, 515, n}, rows up to 2^20, every metric, duplicate
  vectors, invalid (+inf) rows, the total order of ready distances
  (-0.0, +-inf, NaN), the gathered-column form, both sides of the
  select/sort switch, zero query rows (a padded batch), and a row of
  all-equal keys (the select regime's
  spill to scratch);
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
    """Both sides of the regimes' switch, on one corpus."""
    smax = vector_topk.select_max_k()
    V, Q = _corpus(11, 2 * smax + 3, 16, "gauss")
    x, sq, valid, qs = _topk_args(V, Q, "euclidean", 0.1, 11, card)
    for k in (smax, smax + 1):
        got = vector_topk.topk(x, k, "euclidean", sqnorm=sq, valid=valid, qstat=qs)
        _same(got, vector_topk.topk_plain(x, k, "euclidean", sq, valid, qs))


def test_topk_launch_counts(card):
    """The launch plan the library reports, which chip_smoke.py uses to
    scale traced kernel times to one call: three launches for the
    select regime; for the sort, one bitonic stage per doubling of the
    sorted run, each merge stage a tile pass plus one global step per
    stride that spans tiles."""
    assert vector_topk.MAX_N == vector_topk._kernel().vector_topk_max_n()
    smax = vector_topk.select_max_k()
    select = {"topk_hist_kernel": 1, "topk_collect_kernel": 1, "topk_finish_kernel": 1}
    assert vector_topk.launch_counts(1 << 20, 10) == select
    assert vector_topk.launch_counts(smax, smax) == select
    for n in (smax + 1, 1 << 20, vector_topk.MAX_N):
        plan = vector_topk.launch_counts(n, smax + 1)
        merges = plan["topk_tile_kernel"] - 1
        npad = 1 << (n - 1).bit_length()
        tile = npad >> merges
        assert tile <= smax and plan["topk_global_step_kernel"] == merges * (merges + 1) // 2
        assert (plan["topk_keys_kernel"], plan["topk_emit_kernel"]) == (1, 1)
    with pytest.raises(ValueError):
        vector_topk.launch_counts(vector_topk.MAX_N + 1, 1)


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
