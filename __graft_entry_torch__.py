"""Entry points of the PyTorch port: the flagship step and the
mesh dry run, beside `__graft_entry__.py`, which drives the JAX package.

entry(device="cuda"): the flagship compute step, one "query level" of
the engine at `__graft_entry__.entry()`'s shapes and inputs: a batch of
sorted-set intersections (the handleUidPostings fan-out, ref
worker/task.go:783) through setop_rows' padded form (K2 + K3), and a
brute-force vector top-k (the similar_to scorer): a full-float32 GEMM,
then KV1 on sqn - 2 Q V^T + |q|^2, the reference's expression.

dryrun_multichip(n, device="cuda"): the full distributed step over the
port's device mesh (`dgraph_tpu_torch/parallel/mesh.py`) of n shards:
the row-sharded k-means step (psum), the row-sharded vector top-k (KV3's
distances, KV1 a shard, all_gather, KV1), and the sharded memberships
(K1 in chunks of 128 queries); then a DQL read through a
`DistributedCluster` whose level-batched dispatch row-shards its giant
operand over the mesh. On a card the n shards lie round-robin over the
visible cards; with device="cpu" they are n shards of the host.

    python -c "import __graft_entry_torch__ as g; g.dryrun_multichip(4, device='cpu')"

Nothing runs on the host unless the caller asks for device="cpu".
"""

import numpy as np


def entry(device="cuda"):
    """(query_step, example_args): query_step(*example_args) returns
    (out, counts, idx) as the reference's: out (32, 1024) int64 holding
    each row's kept u32 uids first, UINT32_MAX after them, counts (32,)
    int32, idx (32, 10) int32 the rows of the 10 nearest vectors of each
    query, nearest first."""
    import torch

    from dgraph_tpu_torch.device import resolve_device
    from dgraph_tpu_torch.ops import setop_rows, vector_topk

    dev = resolve_device(device)
    B, PA, PB = 32, 1024, 4096  # batch of list pairs (one query level)
    N, D, K = 4096, 256, 10  # vector corpus

    rng = np.random.default_rng(0)

    def mk(npad, n):
        a = np.full((B, npad), 0xFFFFFFFF, np.uint32)
        lens = np.zeros((B,), np.int32)
        for i in range(B):
            v = np.unique(rng.integers(0, 1 << 30, n, dtype=np.uint64)).astype(
                np.uint32
            )
            a[i, : len(v)] = v
            lens[i] = len(v)
        return a, lens

    A, LA = mk(PA, 900)
    Bm, LB = mk(PB, 3800)
    V = rng.standard_normal((N, D)).astype(np.float32)
    Q = rng.standard_normal((B, D)).astype(np.float32)

    def query_step(a, la, b, lb, vecs, queries):
        # batched set intersection: one setop_rows launch for the level
        out, counts = setop_rows.intersect_batch(a, la, b, lb)
        # brute top-k: the GEMM in full float32, then KV1's euclidean
        # epilogue (sqn - 2 dot) + |q|^2, the mask and the top-k
        sqn = (vecs * vecs).sum(dim=1)
        dots = vector_topk.f32_matmul(queries, vecs.T)
        qstat = vector_topk.query_stat(queries, "euclidean")
        _, idx = vector_topk.topk(dots, K, "euclidean", sqnorm=sqn, qstat=qstat)
        return setop_rows.to_u32(out), counts, idx

    def put(x):
        return torch.from_numpy(x).to(dev)

    # uids travel as their u32 bits in int32
    example_args = (
        put(A.view(np.int32)),
        put(LA),
        put(Bm.view(np.int32)),
        put(LB),
        put(V),
        put(Q),
    )
    return query_step, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    import torch

    from dgraph_tpu_torch.device import resolve_device
    from dgraph_tpu_torch.parallel import mesh as pmesh

    dev = resolve_device(device)
    saved = (pmesh.DEVICES, pmesh.HOST_WIDTH)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        pmesh.DEVICES = [f"cuda:{i % cards}" for i in range(n_devices)]
    else:
        pmesh.DEVICES, pmesh.HOST_WIDTH = None, n_devices
    try:
        _full_step(pmesh.make_mesh(n_devices, device=dev))
        _dryrun_distributed_query(n_devices, dev)
    finally:
        pmesh.DEVICES, pmesh.HOST_WIDTH = saved


def _full_step(mesh) -> None:
    """The reference's `full_step` on `mesh`, its inputs drawn in the same
    order from the same seed; beside its shape checks, each result is
    held to numpy."""
    import torch

    from dgraph_tpu_torch.ops import setops
    from dgraph_tpu_torch.parallel import mesh as pmesh

    n_devices = mesh.size
    first = mesh.devices[0]
    rng = np.random.default_rng(0)
    n, d, c, k = 16 * n_devices, 8, 4, 3
    X = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.ones((n,), bool)
    C0 = X[:c].copy()
    a = np.sort(
        rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 8 * n_devices, replace=False)
    )
    b = np.sort(
        rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 64, replace=False)
    )

    Xd, Vd, Ad = pmesh.shard(mesh, X), pmesh.shard(mesh, valid), pmesh.shard(mesh, a)
    Cd = torch.from_numpy(C0).to(first)
    Bd = setops.to_device(b, first)
    q = torch.from_numpy(X[0].copy()).to(first)

    # replicated row batch vs the row-sharded giant list (multi-part
    # posting list data plane, dispatch._run_rows_sharded)
    rows = np.full((4, 16), 0xFFFFFFFF, np.uint32)
    lr = np.zeros((4,), np.int32)
    for i in range(4):
        r = np.sort(rng.choice(a, 8, replace=False))
        rows[i, : len(r)] = r
        lr[i] = len(r)
    Rd = setops.to_device(rows, first)

    # dp training step: sharded Lloyd iteration (psum all-reduce)
    new_c = pmesh.sharded_kmeans_step(mesh, Xd, Vd, Cd)
    # sharded vector top-k (all_gather + global reduce)
    dists, idx = pmesh.sharded_topk(mesh, Xd, Vd, q, k)
    # sharded membership over a row-sharded uid list
    mask = pmesh.sharded_membership(mesh, Ad, len(a), Bd, len(b))
    count = pmesh.sharded_intersect_count(mesh, Ad, len(a), Bd, len(b))
    # whole-level rows vs row-sharded giant list (multi-part lists)
    rmask = pmesh.sharded_rows_membership(
        mesh, Rd, torch.from_numpy(lr).to(first), Ad, len(a)
    )
    out = [t.cpu().numpy() for t in (new_c, dists, idx, mask, rmask, count)]
    assert out[0].shape == (c, d)
    assert out[1].shape == (k,)
    assert out[4].shape == rows.shape
    assert np.isfinite(out[0]).all()
    # q is row 0: its own distance is 0, and the rest ascend
    assert int(out[2][0]) == 0 and out[1][0] == 0.0, (out[1], out[2])
    assert (np.diff(out[1]) >= 0).all(), out[1]
    assert np.array_equal(out[3], np.isin(a, b)), "sharded_membership != numpy"
    assert int(out[5]) == int(np.isin(a, b).sum()), "sharded_intersect_count != numpy"
    want = np.isin(rows, a) & (np.arange(rows.shape[1])[None, :] < lr[:, None])
    assert np.array_equal(out[4], want), "sharded_rows_membership != numpy"
    print(
        f"dryrun_multichip OK on {n_devices} devices: "
        f"kmeans {out[0].shape}, topk {out[1].shape}, "
        f"membership {out[3].shape}, rows_membership {out[4].shape}"
    )
    cards = sorted({str(dv) for dv in mesh.devices})
    print(
        f"the mesh: {n_devices} shards on {len(cards)} distinct "
        f"{'device' if len(cards) == 1 else 'devices'} ({', '.join(cards)})"
    )


def _dryrun_distributed_query(n_devices: int, device) -> None:
    """A REAL query through the distributed engine on the mesh: DQL parse
    -> Zero tablet routing over 2 predicate-sharded groups -> whole-level
    batched dispatch with the big operand ROW-SHARDED over the n-shard
    mesh (dispatch._run_rows_sharded -> parallel.mesh.sharded_rows_membership)
    -> merge -> JSON. Asserts both the result and that the mesh path
    actually executed."""
    from dgraph_tpu_torch.query import dispatch as dsp
    from dgraph_tpu_torch.worker.facade import ClusterFacade
    from dgraph_tpu_torch.worker.groups import DistributedCluster

    sharded_calls = {"n": 0}
    orig = dsp.SetOpDispatcher._run_rows_sharded
    orig_force = dsp._FORCE_DEVICE
    orig_shard_min = dsp._SHARD_MIN_B

    def counting(self, op, rows, b, b_token):
        got = orig(self, op, rows, b, b_token)
        if got is not None:
            sharded_calls["n"] += 1
        return got

    dsp.SetOpDispatcher._run_rows_sharded = counting
    try:
        cluster = DistributedCluster(device=device, n_groups=2, replicas=1)
        facade = ClusterFacade(cluster)
        cluster.alter(
            "name: string @index(exact) .\nfollow: [uid] @reverse ."
        )
        n = 120
        rdf = []
        for i in range(1, n + 1):
            rdf.append(f'<0x{i:x}> <name> "n{i}" .')
            # sliding-window follows: the 2-hop level's shared operand
            # (the filtered union of all follows) spans the whole graph,
            # which is what makes the row-sharded dispatch route fire
            for j in range(1, 8):
                t = (i + j - 1) % n + 1
                rdf.append(f"<0x{i:x}> <follow> <0x{t:x}> .")
        # batched txns: one giant proposal would exceed the in-proc
        # raft apply window
        for off in range(0, len(rdf), 250):
            t = facade.new_txn()
            t.mutate_rdf(
                set_rdf="\n".join(rdf[off : off + 250]), commit_now=True
            )

        # only now force the device path + a dryrun-sized shard threshold
        dsp._FORCE_DEVICE = True
        dsp._SHARD_MIN_B = 64

        # 2-hop with a filter: the level's AND runs every parent's row
        # against the big filtered operand in one rows-vs-one dispatch,
        # row-sharded over the mesh
        res = facade.query(
            '{ q(func: has(name)) '
            '{ follow @filter(has(name)) { name } } }'
        )["data"]
        assert len(res["q"]) == n, len(res["q"])
        got = sorted(x["name"] for x in res["q"][0]["follow"])
        want = sorted(f"n{j}" for j in range(2, 9))
        assert got == want, (got, want)
        assert sharded_calls["n"] > 0, (
            "distributed query never took the mesh-sharded dispatch path"
        )
        print(
            f"distributed query OK on the {n_devices}-device mesh: "
            f"2 groups, {sharded_calls['n']} sharded dispatches, "
            f"{len(got)} rows"
        )
    finally:
        dsp.SetOpDispatcher._run_rows_sharded = orig
        dsp._FORCE_DEVICE = orig_force
        dsp._SHARD_MIN_B = orig_shard_min
