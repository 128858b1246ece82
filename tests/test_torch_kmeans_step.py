"""KV4 (`dgraph_tpu_torch/ops/kmeans_step.py`) and the mesh's Lloyd step
against the JAX reference, on the CPU.

On CPU tensors KV4's wrapper runs its plain version, `kmeans_step_plain`,
which the tests hold to the reference:

- per shard, to the reference's own expressions (`dgraph_tpu/parallel/
  mesh.py:203-210`: `xsq - 2 X C^T + csq`, `jnp.argmin`, `segment_sum`)
  in jax, and the step it finishes to the reference's
  `sharded_kmeans_step` on a one-device mesh;
- through `parallel/mesh.py`'s `sharded_kmeans_step` on 8 host shards,
  to the reference's on its 8-device CPU mesh, with the last shard all
  padding.

Over d = 1, 3, 8 and 769 and the kinds of `case`: Gaussian clusters,
small integers (every product and sum exact, so ties are exact and
frequent: a tied row must take the lower centroid), c = 1, c > n (empty
clusters keep their centroid), a far centroid no row takes, a shard of
padding only, and NaN rows (jnp.argmin's first NaN). Integer kinds must
be equal bit for bit; on the others the assignments and counts must be
equal (no row is near a tie) and the sums within
`kmeans_step.sums_tolerance` of the reference's (the two add in other
orders), the finished centroids within 1e-4 (the reference test's own
tolerance). Last, phase 13b's k-means checks, rehearsed at a tiny size on
4 host shards (`chip_smoke.mesh_kmeans`).
"""

import numpy as np
import pytest
import torch

import chip_smoke

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dgraph_tpu.parallel import mesh as ref_mesh
from dgraph_tpu_torch.ops import kmeans_step
from dgraph_tpu_torch.parallel import mesh as pmesh

DIMS = [1, 3, 8, 769]
KINDS = ["gauss", "ints", "c1", "c_gt_n", "far", "padding", "nan"]
EXACT = {"ints", "c1", "padding"}


def case(kind, d, n=64, seed=0):
    """(X (n, d), w (n,), C (c, d)) float32 of one kind."""
    rng = np.random.default_rng(seed * 1000 + d)
    w = np.ones(n, np.float32)
    if kind in ("ints", "c1", "padding"):
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = X[rng.choice(n, 1 if kind == "c1" else 6, replace=False)].copy()
        C[-1] = C[0]  # a duplicate centroid: every tie of it goes to the lower
        if kind == "padding":
            w[:] = 0.0
        return X, w, C
    centers = rng.standard_normal((5, d)).astype(np.float32) * 8.0
    X = (centers[rng.integers(0, 5, n)] + rng.standard_normal((n, d))).astype(np.float32)
    C = centers.copy()
    if kind == "c_gt_n":
        C = np.concatenate([C, rng.standard_normal((n, d)).astype(np.float32) * 100.0])
    elif kind == "far":
        C = np.concatenate([C, np.full((1, d), 1e4, np.float32)])
    elif kind == "nan":
        X[[3, 17]] = np.nan
    w[rng.random(n) < 0.2] = 0.0
    return X, w, C


def ref_shard(X, w, C):
    """The reference's per-shard expressions in jax: (sums, cnts, assign)."""
    X, w, C = jnp.asarray(X), jnp.asarray(w), jnp.asarray(C)
    xsq = (X * X).sum(axis=1)
    csq = (C * C).sum(axis=1)
    d2 = xsq[:, None] - 2.0 * (X @ C.T) + csq[None, :]
    assign = jnp.argmin(d2, axis=1)
    sums = jax.ops.segment_sum(X * w[:, None], assign, num_segments=C.shape[0])
    cnts = jax.ops.segment_sum(w, assign, num_segments=C.shape[0])
    return np.asarray(sums), np.asarray(cnts), np.asarray(assign)


def kmeans_min_gap(X, C) -> float:
    """The smallest gap, over X's rows, between the nearest and the second
    nearest centroid's squared distance (float64), relative to the scale
    of their float32 rounding, |x|^2 + |c|^2 of the nearest: how far the
    inputs are from a tie that the kernel's and torch's sums could break
    differently (a few 2^-24 of that scale)."""
    X64, C64 = np.asarray(X, np.float64), np.asarray(C, np.float64)
    d2 = ((X64[:, None, :] - C64[None, :, :]) ** 2).sum(axis=2)
    order = np.argsort(d2, axis=1)[:, :2]
    rows = np.arange(len(X64))
    gap = d2[rows, order[:, 1]] - d2[rows, order[:, 0]]
    scale = (X64 ** 2).sum(axis=1) + (C64 ** 2).sum(axis=1)[order[:, 0]]
    return float((gap / np.maximum(scale, 1e-30)).min())


def dryrun_kmeans_inputs():
    """The k-means step's X (64, 8) and C (4, 8) of
    `__graft_entry_torch__.dryrun_multichip(chip_smoke.MESH_SHARDS)`, drawn in its
    order from its seed."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16 * chip_smoke.MESH_SHARDS, 8)).astype(np.float32)
    return X, X[:4].copy()


def _ref_sharded(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", DIMS)
def test_plain_matches_reference_shard(d, kind):
    """KV4's wrapper on CPU tensors against the reference's per-shard
    math: assignments and counts equal, sums equal (integer kinds) or
    within `sums_tolerance`, NaN where the reference has NaN; and the
    step finished from them equal to the reference's step on one
    device within 1e-4."""
    X, w, C = case(kind, d)
    before = kmeans_step.PLAIN_CALLS
    sums, cnts, assign = kmeans_step.kmeans_step(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(C))
    assert kmeans_step.PLAIN_CALLS - before == 1
    assert sums.shape == C.shape and cnts.shape == (len(C),) and assign.dtype == torch.int32
    rs, rc, ra = ref_shard(X, w, C)
    np.testing.assert_array_equal(assign.numpy(), ra)
    np.testing.assert_array_equal(cnts.numpy(), rc)
    if kind in EXACT:
        np.testing.assert_array_equal(sums.numpy(), rs)
    else:
        tol = kmeans_step.sums_tolerance(torch.from_numpy(X), torch.from_numpy(w), assign,
                                         len(C)).numpy()
        fin = np.isfinite(rs)
        np.testing.assert_array_equal(np.isnan(sums.numpy()), np.isnan(rs))
        assert (np.abs(sums.numpy() - rs)[fin] <= tol[fin]).all()
    if kind == "nan":
        assert ra[3] == ra[17] == 0  # every d2 of a NaN row is NaN: the first
    if kind == "ints":
        dup = len(C) - 1  # C[-1] == C[0]: no row takes the duplicate
        assert not (assign.numpy() == dup).any() and (assign.numpy() == 0).any()
    if kind in ("c_gt_n", "far"):
        assert (cnts.numpy()[5:] == 0).sum() >= 1
    got = torch.where(cnts[:, None] > 0, sums / torch.clamp_min(cnts, 1.0)[:, None],
                      torch.from_numpy(C)).numpy()
    rm1 = ref_mesh.make_mesh(1)
    want = np.asarray(ref_mesh.sharded_kmeans_step(
        rm1, _ref_sharded(rm1, X), _ref_sharded(rm1, w > 0), jnp.asarray(C)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if kind == "padding":
        np.testing.assert_array_equal(got, C)  # no valid row: nothing moves


@pytest.mark.parametrize("kind", ["gauss", "ints", "c1", "c_gt_n", "far"])
@pytest.mark.parametrize("d", DIMS)
def test_mesh_step_matches_reference(d, kind, monkeypatch):
    """`sharded_kmeans_step` on 8 host shards (one KV4 call a shard,
    here its plain version), its last shard all padding, against the
    reference's on 8 CPU devices: equal for integer kinds, within 1e-4
    otherwise; an empty cluster keeps its centroid."""
    monkeypatch.setattr(pmesh, "HOST_WIDTH", 8)
    rm, pm = ref_mesh.make_mesh(8), pmesh.make_mesh(8, device="cpu")
    X, _, C = case(kind, d, n=128, seed=1)
    valid = np.arange(128) < 112  # the last shard of 16 rows: padding only
    X[112:] = 50.0
    before = kmeans_step.PLAIN_CALLS
    got = pmesh.sharded_kmeans_step(pm, X, valid, torch.from_numpy(C)).numpy()
    assert kmeans_step.PLAIN_CALLS - before == 8
    want = np.asarray(ref_mesh.sharded_kmeans_step(
        rm, _ref_sharded(rm, X), _ref_sharded(rm, valid), jnp.asarray(C)))
    if kind in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    _, cnts, _ = ref_shard(X[:112], np.ones(112, np.float32), C)
    np.testing.assert_array_equal(got[cnts == 0], C[cnts == 0])


def test_wrapper_checks_its_inputs():
    X = torch.zeros((4, 3))
    w = torch.ones(4)
    with pytest.raises(ValueError):
        kmeans_step.kmeans_step(X.double(), w, torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        kmeans_step.kmeans_step(X, w, torch.zeros((0, 3)))
    with pytest.raises(ValueError):
        kmeans_step.kmeans_step(X, w[:3], torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        kmeans_step.kmeans_step(X, w, torch.zeros((2, 3)), torch.zeros((4, 3)))
    assert kmeans_step.launch_counts(0) == {k: 1 for k in kmeans_step.KERNELS
                                            if k not in ("kmeans_assign_kernel",
                                                         "kmeans_scatter_kernel")}


def test_plain_on_an_empty_shard():
    """A shard of no rows: sums and counts zero, every centroid kept."""
    C = torch.randn(3, 5)
    sums, cnts, assign = kmeans_step.kmeans_step(torch.zeros((0, 5)), torch.zeros(0), C)
    assert not sums.any() and not cnts.any() and assign.shape == (0,)


def test_mesh_kmeans_phase_on_cpu(monkeypatch):
    """Phase 13b's k-means part (`chip_smoke.mesh_kmeans`) at a tiny size
    on 4 host shards: the mesh's step equals the plain one-device step
    and the one-device mesh; every shard input KV4 took is held to its
    plain version (assignments, counts, sums, a repeat); the sharded
    training equals the plain one-device training within its stated
    tolerance; the dry run's inputs (`__graft_entry_torch__`) have no
    row near a tie."""
    monkeypatch.setattr(pmesh, "DEVICES", ["cpu"] * chip_smoke.MESH_SHARDS)
    quiet = lambda m: None  # noqa: E731
    V, _ = chip_smoke.make_corpus(2000, 16, nq=1)
    res = {}

    def row(name, route, shape, nbytes, ops=0, **kw):
        res[name] = dict(route=route, shape=shape, **kw)

    kv4 = chip_smoke.mesh_kmeans("cpu", V[:1000].copy(), row,
                                 lambda fn, launched, **kw: {}, log=quiet)
    assert set(res) == {"sharded_kmeans_step", "sharded_ivf_train"}
    assert res["sharded_ivf_train"]["objective_rel_diff"] <= 1e-4
    assert list(kv4) == ["KV4 250x16 c=256"]
    gap = kmeans_min_gap(*dryrun_kmeans_inputs())
    assert gap > 1e-5, gap  # over 100 ulps of the scale
