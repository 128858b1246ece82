#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dgraph_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile bc]

Phases, each of which fails the run when it fails:

  1. the card: its name and power limit (nvidia-smi), torch and CUDA;
  2. the build: every hand-written kernel of the port from `csrc/`, one
     nvcc per source, all started together;
  3. the member sweep (K1) against its plain PyTorch version, exactly,
     over a grid of shapes plus rows with equal queries, zero padding and
     lengths on both sides of the search/stream switch, and the sentinel
     cases, with the kernel, plain and library times, the byte bound and
     how many rows took each regime (`member_sweep_crossover.py` measures
     where the regimes cross); (3b) setop_rows (K2 + K3) the same way, in
     its padded and its ragged form (`setop_grid`): every row kind, then
     timed shapes up to (b)'s whole level and (d)'s difference, each
     ragged call twice back to back;
  4. the main path: an embedded `Server(device="cuda")` loads a 3-level
     fan-out graph (1 -> 100 -> 10k -> 1M edges, the level-3 pool split
     across the 2^32 uid segment boundary, a 1%-hot `tag` on every level-3
     node) through its own mutations and answers four DQL reads with the
     device path forced and the member sweep on. Every answer must equal
     the port's host path and an independent numpy reference; (b)'s
     filtered level must be one setop_rows launch over its ragged buffer
     (no K1), a warm (b) must bring back at most 0.5 MB, and (d)'s
     difference must be one launch. Then K1's read: (c) over a small graph
     with a rare hot tag (`k1_read`), whose AND chain reaches the member
     sweep through the pair path, equal to the host path and numpy;
  5. K1 once more, on the inputs K1's read gave it, after checking
     that they meet its precondition (rows sorted as uint32), and
     setop_rows on every shape phase 4 gave it;
  6. the vector kernels against their plain PyTorch versions over a grid:
     KV1 (`vector_topk`, distance epilogue + masked top-k) bit for bit on
     two calls back to back (its tickets and histograms reset
     themselves), at the served shapes, on both sides of its one-pass /
     radix switch, on tied rows, NaN, +-inf and -0.0, 65,535 rows and
     k = n; KV2 (`ivf_slab_scan`) within `ivf_scan.tolerance`; with
     kernel, device, plain and library times and the bound;
  7. the vector main path: a `Server(device="cuda")` serves `similar_to`
     over 1,000,000 x 768 float32 vectors (the mixture-of-gaussians corpus
     of benchmarks/bench_suite.py, rewritten here), 990,000 bulk-loaded
     into the predicate's index and the last 10,000 committed as RDF
     with a name, plus the first 100,000 as `emb_small` (brute tier).
     Five reads: plain `similar_to` (IVF tier), the same with `ef: 64`,
     `similar_to` on `emb_small`, `search_batch` of 64 queries (brute
     tier), and (i) `similar_to` on `emb_small` as a filter of 20 uids far
     from the query, whose pool widens 4x a step up to the live set
     (KV1 at k = 40 ... 100,000, both regimes). Brute answers must equal
     an exact numpy top-k outside near-ties ((i): over its allowed set),
     IVF recall@10 over 64 queries must reach 0.90, the card must answer
     as the same index's CPU float path, KV1 and KV2 must have launched,
     and both are held against their plain versions on the inputs the
     served reads gave them;
  8. the write path, once on the WAL-backed store and once with
     DGRAPH_TPU_STORAGE=lsm: a `Server(device="cuda", data_dir=<tmp>)`
     with group commit on and the device path forced loads phase 4's
     graph and phase 7's `emb_small` rows (100,000 on the WAL store,
     25,000 on lsm) through `mutate_json` (the answers must equal
     numpy), then runs (u1) 8 threads x 250
     email upserts (Dgraph's Upsert Block example; each email must end
     with one uid), (u2) an upsert whose query block is query (b)'s
     filtered level 3 (setop_rows must launch; `has(hot_seen)` must equal
     numpy)
     and (u3) the bank in JSON, 8 threads x 125 transfers with a reader
     checking the total at every snapshot. It closes the store, opens it
     again in a new Server, times the recovery, and every answer of
     before, 16 `similar_to` reads among them, must come back byte for
     byte (setop_rows and KV1 must launch), with a fresh blank node above every
     recovered uid;
  9. the serving front, on phase 4's and phase 7's servers (kept alive
     for it): (9b) the plan cache over (b)'s filtered level rooted at
     each of 50 level-1 uids, with PLAN_CACHE_SIZE 512 and 0 (answers
     equal and equal to numpy); (9d) `query_rdf` of (a) and (b), device path ==
     host path byte for byte, one triple per edge of the JSON answer
     (setop_rows must launch in (b)'s); (9c) the result cache over (a)-(d) (hits equal misses), then one
     committed edge that the next (b), a miss, must show; (9a) 16 client
     threads x 32 plain `similar_to` reads on `emb` (IVF) and `emb_small`
     (brute) at BATCH_WINDOW_US 0 and 200, every answer equal to the same
     query's solo answer, with QPS, p50/p99, the coalesced batches and the
     card's idle share over one traced window; (9e) the same clients with
     ADMISSION=1 and MAX_INFLIGHT=4 (some shed, with the retryable error;
     every admitted answer equal to its solo answer); (9f) ACL and audit:
     a reader of `name` alone is refused `emb` and answered on `name` as
     with ACL off. K1 is held against its plain version at every shape
     these reads gave it, KV1 and KV2 at every shape (the coalesced
     widths 2-4 among them);
 10. data in and out (`serve_ops`), on Servers of its own in a temporary
     directory, group commit on and the device path forced: (10a) the
     parallel bulk loader loads phase 4's graph (the native reduce) and
     phase 7's 100,000 `emb_small` rows (the Python reduce, its map
     workers forked while the card is live); (a)-(d) must equal numpy,
     16 `similar_to` reads the exact top-k, and all of it again after
     the store is closed and reopened; (10b) subscriptions to (b) and to
     one `similar_to` over 20 tag flips (one callback each, equal to
     numpy), 5 unrelated commits (none) and 5 vector commits (each
     callback shows the vectors of the commits before it: subscriptions
     run before a commit's vectors reach the index, as in the
     reference), with commit latency with and without them; (10c) CDC to
     an ndjson file over (10b) and the JSON bank (8 threads x 50
     transfers): commit-ts order, unique ids, one event per committed
     posting, the checkpoint at the last commit; then a final batch that
     an injected emitter crash keeps from the sink, a restart and a
     replay whose union with the first sink is the committed set, and
     which, applied to a fresh Server, answers (b) and the balances as
     the source; (10d) a full and an incremental backup through the task
     queue, restored into a fresh Server (answers equal the source's),
     `until` the full backup into another (equal to the source after
     (10a)) and into the warm source (answers unchanged), an RDF export
     bulk-loaded into a fresh Server ((b) equal), and `rollup_all` twice,
     the second with MAX_PART_UIDS 50,000, which splits the `cold` index
     list ((a)-(d) equal to numpy over its parts). K1 and KV1 are held
     against their plain versions at every shape and site phase 10 gave
     them;
 11. the cluster (`serve_cluster`), group commit on, the columnar path
     off and the device path forced, the coordinator on the card: (11a)
     a `ProcCluster` of 2 groups x 3 replica processes loads phase 4's
     graph at a tenth of its scale (10 level-1 nodes, rows 100 wide, a
     pool of 20,000: 121,010 N-Quads; `--cluster-only` loads all
     1,210,100) through cluster transactions,
     `child` and `tag` on different groups, and answers (a)-(d) equal to
     the host path and numpy (setop_rows must launch in (b)), with each query's
     RPCs; no replica may hold a CUDA context; (11b) the leader of
     `tag`'s group is SIGKILLed, a flip of 100 tags commits, (b) equals
     numpy with the flips, the victim restarts, applies past the commit
     and answers (b) alone by follower reads; (11c) `tag` moves to the
     other group while two threads read (b) back to back, every answer
     equal and one read straddling the ownership flip;
     (11d) the cluster is closed, no replica outlives it, and a new one
     on the same directory answers (a)-(d) byte for byte at the last
     snapshot the client saw; (11e) an in-process `DistributedCluster`
     (2 x 3, a replicated Zero) commits 1,000 of the `emb_small` rows
     through cluster transactions and answers 16 `similar_to` reads
     equal to the exact top-k (KV1 must launch). K1 and KV1 are held
     against their plain versions at every shape and site phase 11 gave
     them;
 12. GraphQL over the port's HTTP front (`serve_graphql`), between phases
     9 and 10, on phase 4's and phase 7's servers, each behind an
     `HTTPServer` on localhost and asked through the port's `client.py`,
     on the forced device path: (12a) `dgraph.type` "Node" on the graph's
     210,101 nodes through `/mutate`, then an SDL mapping `Node` and `Doc`
     onto the existing predicates through `/admin/schema/graphql`, which
     must rebuild no index; (12b) query (b) as `queryNode` and `getNode`,
     equal to numpy and to (b) as DQL over the same front (setop_rows
     must launch; its dispatcher entry is reported); (12c) `aggregateNode` of
     the hot nodes and a page of 10; (12d) 16 `querySimilarDocByEmbedding`
     reads on `emb_small` (brute, KV1: the exact top-k outside near-ties)
     and on `emb` (IVF, KV2 and KV1: recall@10 at least 0.90), with
     `vector_distance` (the float64 distance where the store holds the
     row's vector, null elsewhere), and one `querySimilarDocById`; (12e) 5
     tag flips by `updateNode` alone, then 5 under a graphql-transport-ws
     subscription to (b) over a websocket (every push and every (b)
     after a flip equal to numpy), then a commit that changes no answer
     (no push). K1, KV1 and KV2 are held against their plain versions at
     every shape and site phase 12 gave them.
 13. the command line and the device mesh, after phase 12: (13a)
     `python -m dgraph_tpu_torch bulk` loads phase 4's graph into a fresh
     data dir and `python -m dgraph_tpu_torch alpha -p <dir> --port 0
     --grpc_port 0` serves it on the card (its default device) as a
     child process; (a)-(d) over HTTP and over gRPC (`client_grpc`'s
     stub) must equal phase 4's answers byte for byte, cold and warm, and
     alpha's use of the card is read from outside it (nvidia-smi's
     compute processes, its /proc maps, the set-op counter of its
     metrics route). (13b) the mesh (`parallel/mesh.py`) on 4 shards of
     cuda:0: `sharded_rows_membership`, `sharded_membership` and
     `sharded_intersect_count` of (b)'s level-3 rows against an operand
     of more than 2^22 uids, `sharded_topk` over `emb`'s 1,000,000 x 768
     for 16 queries, `sharded_kmeans_step` on `emb_small`'s rows, each
     against its plain version and the one-device mesh, with times and
     bounds; then, with the counts zeroed, `Server.query` (b) with the
     dispatcher's giant-operand gate lowered (on phase 4's graph it
     enters `_run_rows_sharded` and falls through, its uids spanning two
     hi-32 segments; on the same graph with the pool below 2^32 the mesh
     answers) and `similar_to` with `SHARD_VECTORS=1` on a fresh
     `emb_small` index, equal to the exact top-10. Every KV1 call the
     mesh made is held against its plain version.

`--profile` adds, for the named queries (a-d of phase 4, e-i of phase
7), where one warm run's time goes: host functions by own time
(cProfile) and the card's busy share (torch.profiler). `--crossover`
runs phases 1-2 and then, in place of the others, measures where KV1's
radix regime starts to beat its one-pass regime (`topk_crossover`);
`--ops-only` runs phases 1-2 and then phase 10 alone, on rows made
anew; `--cluster-only` likewise phase 11, on the full graph;
`--graphql-only` likewise phase 12, on the graph bulk-loaded through the
native loader and phase 7's vectors in Servers of its own; `--mesh-only`
likewise phase 13, on the graph, its answers and the corpus made anew.

The second-to-last lines are the kernel table (JSON) and the card; the
last line is `{"ok": true, "device": {...}}`. Without a CUDA card the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

SEG = 1 << 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
U32 = 0xFFFFFFFF

QUERIES = {
    # plain 3-level traversal, counts at the leaves
    "a": "{ q(func: uid(0x1)) { child { child { c: count(child) } } } }",
    # level-3 filter: rows straddle 2^32, so each row is cut into its two
    # segments' sub-rows, all searched against the filter's two segments
    # in one setop_rows launch over the ragged level
    "b": '{ q(func: uid(0x1)) { child { child { uid child @filter('
         'eq(tag, "hot")) { uid } } } } }',
    # AND filter chain
    "c": '{ q(func: uid(0x1)) { child { child { uid child @filter('
         'eq(tag, "hot") AND has(tag)) { uid } } } } }',
    # NOT filter: a difference (every level-3 node is hot or cold)
    "d": '{ q(func: uid(0x1)) { child { child { uid child @filter('
         'NOT eq(tag, "cold")) { uid } } } } }',
}


# ---------------------------------------------------------------------------
# The fan-out graph and its numpy reference
# ---------------------------------------------------------------------------


def make_graph(fanout=100, pool=200_000, seed=7, hot_every=100, roots=None, low=False):
    """The fan-out graph of bench.py (level-3 targets drawn from a pool
    with `np.random.default_rng(seed)`), with half of the pool at or
    above 2^32 (none with `low`) and every `hot_every`-th pool node tagged
    hot. `roots` level-1 nodes (default `fanout`), each row `fanout`
    wide."""
    f = fanout
    r = f if roots is None else roots
    rng = np.random.default_rng(seed)
    half = pool if low else pool // 2
    pool_uids = np.concatenate(
        [0x1000000 + np.arange(half), SEG + np.arange(pool - half)]
    ).astype(np.uint64)
    return {
        "f": f,
        "l1": (0x100 + np.arange(r)).astype(np.uint64),
        "l2": (0x10000 + np.arange(r * f)).astype(np.uint64),
        "l3": pool_uids[rng.integers(0, pool, size=r * f * f)],
        "pool": pool_uids,
        "hot": pool_uids[::hot_every],
    }


def nquad_chunks(g, chunk=50_000, tag_chunk=None):
    """RDF text in commits of about `chunk` N-Quads: the edges level by
    level, then one tag per pool node, `tag_chunk` (default `chunk`) a
    commit."""
    f = g["f"]
    lines = [f"<0x1> <child> <{hex(int(v))}> ." for v in g["l1"]]
    for i, v in enumerate(g["l2"]):
        lines.append(f"<{hex(int(g['l1'][i // f]))}> <child> <{hex(int(v))}> .")
    yield "\n".join(lines)
    per = max(1, chunk // f)
    for s in range(0, len(g["l2"]), per):
        lines = []
        for i in range(s, min(s + per, len(g["l2"]))):
            src = hex(int(g["l2"][i]))
            for t in g["l3"][i * f : (i + 1) * f]:
                lines.append(f"<{src}> <child> <{hex(int(t))}> .")
        yield "\n".join(lines)
    hot = set(g["hot"].tolist())
    tag_chunk = tag_chunk or chunk
    for s in range(0, len(g["pool"]), tag_chunk):
        yield "\n".join(
            f'<{hex(u)}> <tag> "{"hot" if u in hot else "cold"}" .'
            for u in g["pool"][s : s + tag_chunk].tolist()
        )


def load_graph(server, g, chunk=50_000) -> int:
    """Schema plus every N-Quad through the server's own mutations."""
    server.alter("child: [uid] .\ntag: string @index(exact) .")
    n = 0
    for text in nquad_chunks(g, chunk):
        server.new_txn().mutate_rdf(set_rdf=text, commit_now=True)
        n += text.count("\n") + 1
    return n


def expected(g, name, hot=None):
    """What query `name` must answer, from the edge arrays alone (with the
    uids in `hot` tagged hot, if given, instead of the graph's own)."""
    rows = np.sort(g["l3"].reshape(len(g["l2"]), g["f"]), axis=1)
    first = np.ones(rows.shape, bool)  # each uid of a row once
    first[:, 1:] = rows[:, 1:] != rows[:, :-1]
    if name == "a":
        return first.sum(axis=1).tolist()
    hot = g["hot"] if hot is None else np.fromiter(hot, np.uint64, len(hot))
    keep = first & np.isin(rows, hot)
    return {u: r[m].tolist() for u, r, m in zip(g["l2"].tolist(), rows, keep)}


def json_edges(data) -> int:
    """The uid edges of a JSON answer: the objects in lists below its root
    blocks. For queries that ask for no value, as (a) and (b), these are
    the triples its RDF form must hold."""
    def count(v):
        if isinstance(v, list):
            return sum(1 + count(o) for o in v if isinstance(o, dict))
        if isinstance(v, dict):
            return sum(count(x) for x in v.values())
        return 0
    return sum(count(o) for rows in data.values() for o in rows)


def extract(name, data):
    """The comparable part of a response's `data`."""
    level2 = [o for l1 in data["q"][0]["child"] for o in l1["child"]]
    if name == "a":
        return [o["c"] for o in level2]
    return {
        int(o["uid"], 16): [int(x["uid"], 16) for x in o.get("child", [])]
        for o in level2
    }


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------


def _shape_key(args):
    """(n, pa, pb, "shared" or "paired") of a set op's (A, LA, B, LB);
    (n, pa) of a compaction's (A, keep); (m, N, nB, r, "ragged") of a
    ragged set op's (A, offs, rid, B, ranges)."""
    A = args[0]
    if len(args) == 5:
        return (int(args[1].numel()) - 1, int(A.numel()), int(args[3].numel()),
                int(args[4].shape[0]), "ragged")
    if len(args) == 2:
        return (int(A.shape[0]), int(A.shape[1]))
    B = args[2]
    return (int(A.shape[0]), int(A.shape[1]), int(B.shape[-1]),
            "shared" if B.dim() == 1 else "paired")


class _Capture:
    """Keeps, of the inputs the main path hands the named wrappers of a
    kernel module (K1's `membership_batch` by default), the first of each
    shape, cloned, and the largest set, delegating every call unchanged.
    With several names, a shape's key starts with the wrapper's name."""

    def __init__(self, module, names=("membership_batch",)):
        self.module = module
        self.real = {n: getattr(module, n) for n in names}
        self.tagged = len(names) > 1
        self.args = None
        self.shapes = []
        self.by_shape = {}

    def _wrap(self, name):
        real = self.real[name]

        def call(*args):
            key = _shape_key(args)
            key = (name,) + key if self.tagged else key
            self.shapes.append(key)
            if key not in self.by_shape:
                self.by_shape[key] = tuple(t.clone() for t in args)
            if self.args is None or args[0].numel() + args[-2].numel() > (
                self.args[0].numel() + self.args[-2].numel()
            ):
                self.args = self.by_shape[key]  # sizes follow the shape
            return real(*args)

        return call

    def __enter__(self):
        for n in self.real:
            setattr(self.module, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


SETOP_WRAPPERS = ("intersect_batch", "difference_batch", "compact_batch",
                  "intersect_ragged", "difference_ragged")


# the XLA programs the port still runs as plain torch: setops' union,
# merge_sorted, intersect_many and index_of (K4-K7) and the executor's
# device top-k of a `first:` ordering (K11)
PLAIN_OPS = ("union", "merge_sorted", "intersect_many", "index_of", "_order_uids_topk")


class _PlainOps:
    """Counts the calls of PLAIN_OPS (K11: those that reached the device
    sort) and keeps each one's largest input, cloned (K11: the uid count
    and k), delegating every call unchanged."""

    def __enter__(self):
        from dgraph_tpu_torch.ops import setops
        from dgraph_tpu_torch.query import subgraph

        self.calls, self.largest = {}, {}
        self.real = [(setops, n, getattr(setops, n)) for n in PLAIN_OPS[:4]]
        self.real.append((subgraph.Executor, PLAIN_OPS[4], subgraph.Executor._order_uids_topk))
        for owner, name, real in self.real:
            setattr(owner, name, self._wrap(name, real))
        return self

    def _wrap(self, name, real):
        import torch

        def call(*args, **kw):
            got = real(*args, **kw)
            if name == PLAIN_OPS[4]:
                if got is None:
                    return got
                kept = (len(args[-1]), len(got))  # uids sorted on the card, k kept
                size = kept[0]
            else:
                kept = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                size = sum(a.numel() for a in args if torch.is_tensor(a))
            self.calls[name] = self.calls.get(name, 0) + 1
            if size > self.largest.get(name, (-1,))[0]:
                self.largest[name] = (size, kept)
            return got

        return call

    def __exit__(self, *exc):
        for owner, name, real in self.real:
            setattr(owner, name, real)


def plain_op_input(name, device="cuda", seed=0):
    """An input for a PLAIN_OPS program that no path of the run called, at
    (b)'s scale: union over 10,000 pair rows of 64 and 1,024 (a pow2
    bucket), the k-way chains over 3 lists of 100,000, index_of of one uid
    a row in 10,000 rows of 128, K11 over 100,000 uids for a first: 10."""
    import torch

    gen = torch.Generator(device).manual_seed(seed)

    def rows(n, w):
        return torch.randint(0, 1 << 32, (n, w), generator=gen, device=device).sort(-1).values

    def full(n, v):
        return torch.full((n,), v, dtype=torch.int64, device=device)

    if name == "union":
        return rows(10_000, 64), full(10_000, 64), rows(10_000, 1024), full(10_000, 1024)
    if name in ("merge_sorted", "intersect_many"):
        return rows(3, 100_000), full(3, 100_000)
    if name == "index_of":
        a = rows(10_000, 128)
        return a, full(10_000, 128), a[:, 5].contiguous()
    return 100_000, 10


def plain_op_measure(name, args, reps=5):
    """Events ms of one call of a PLAIN_OPS program on its largest served
    input, and its byte bound: the valid u32 words read once and the
    kept ones written once (K11: the float32 scores read, the k indices
    written)."""
    import torch

    from dgraph_tpu_torch.ops import setops

    if name == PLAIN_OPS[4]:
        n, k = args
        x = torch.rand(n, device="cuda")
        fn = lambda: torch.sort(x, descending=True, stable=True).indices[:k].cpu()  # noqa: E731
        nbytes = 4 * n + 8 * k
    else:
        fn = lambda: getattr(setops, name)(*args)  # noqa: E731
        out, cnt = fn() if name != "index_of" else (None, None)
        if name == "union":
            a, la, b, lb = args
            nbytes = 4 * int(la.sum() + lb.sum()) + 4 * int(cnt.sum()) + 12 * la.numel()
        elif name == "index_of":
            a, la, u = args
            nbytes = 4 * int(torch.as_tensor(u).numel()) * 2 + 32 * a.shape[0]
        else:
            lists, lengths = args
            nbytes = 4 * int(torch.as_tensor(lengths).sum()) + 4 * int(cnt.sum())
    return {"ms": _events_ms(fn, reps), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


class _Copies:
    """Counts the bytes the dispatcher copies to the card (`_stage`) and
    back (`_fetch`), and times each read back on the host clock (it ends
    in a sync), delegating every call unchanged."""

    def __enter__(self):
        from dgraph_tpu_torch.query import dispatch

        self.d, self.up, self.down, self.fetch_ms = dispatch, 0, 0, []
        self.real = dispatch._stage, dispatch._fetch

        def stage(dev, parts):
            self.up += sum(np.asarray(p).nbytes for p in parts)
            return self.real[0](dev, parts)

        def fetch(tensors):
            self.down += sum(t.numel() * t.element_size() for t in tensors)
            t0 = time.perf_counter()
            got = self.real[1](tensors)
            self.fetch_ms.append((time.perf_counter() - t0) * 1e3)
            return got

        dispatch._stage, dispatch._fetch = stage, fetch
        return self

    def __exit__(self, *exc):
        self.d._stage, self.d._fetch = self.real

    def bytes(self):
        return self.up, self.down


def setops_count(on_card):
    """setop_rows launches so far on a card, its plain versions' calls on
    the CPU: every (b)-like read runs its filtered level through it."""
    from dgraph_tpu_torch.ops import setop_rows

    return setop_rows.LAUNCHES if on_card else setop_rows.PLAIN_CALLS


def _run_query(server, q):
    return server.query(q, want="raw")["data"].raw


def profile_query(server, q, log=print, top=12, reps=5):
    """Where one warm query's time goes: the host functions by own time
    (cProfile), and the card's busy share (torch.profiler: the sum of
    device kernel and copy time over the query's wall time, over `reps`
    calls). `q` is a DQL string, or a callable that runs the work.
    Returns the card's busy and wall ms a call and its idle share."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    run = q if callable(q) else (lambda: _run_query(server, q))
    pr = cProfile.Profile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pr.enable()
    run()
    pr.disable()
    wall_ms = (time.perf_counter() - t) * 1e3
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(top)
    log(f"host profile ({wall_ms:.3f} ms under cProfile), top {top} by own time:")
    for line in buf.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            log("      " + line.strip())
    best = None
    for _ in range(3):  # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / reps
        # the device's own records (kernels, copies, sets): a CPU op's
        # device time repeats its kernels'
        rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
                and str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / reps
        if best is None or busy_ms > best[0]:
            best = (busy_ms, wall_ms, rows)
    busy_ms, wall_ms, rows = best
    log(f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall per call over {reps} calls "
        f"(idle share {1 - busy_ms / wall_ms:.4f}; the fullest of 3 traces); by kernel, per call:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.self_device_time_total / 1e3 / reps:10.3f} ms  x{e.count / reps:<5g} "
            f"{e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms}


def serve(device="cuda", fanout=100, pool=200_000, reps=3, log=print, profile=(),
          keep=False):
    """Load the fan-out graph into a port Server on `device` and answer
    QUERIES on the forced device path (member sweep on) and on the host
    path; every answer is held to the numpy reference. Returns the
    measurements, the kernel counts and setop_rows calls of the counted
    run, its copies, the captured setop_rows inputs and the plain-torch
    programs' calls, and with `keep` the server and the graph (phase 9
    serves them again). Queries named in `profile` are profiled on the
    device path afterwards (card only)."""
    import torch

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.ops import member_sweep, setop_rows
    from dgraph_tpu_torch.query import dispatch

    on_card = torch.device(device).type == "cuda"
    g = make_graph(fanout, pool)
    server = Server(device=device)
    server.slow_query_ms = float("inf")  # no slow-query log lines here
    t0 = time.perf_counter()
    nq = load_graph(server, g)
    load_s = time.perf_counter() - t0
    log(f"graph: {nq} N-Quads ({len(g['l3']) + len(g['l2']) + len(g['l1'])} "
        f"edges, pool {pool}, {len(g['hot'])} hot) loaded in {load_s:.3f}s "
        "through Server.new_txn().mutate_rdf")

    def count():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    def setop_count():
        return setop_rows.LAUNCHES if on_card else setop_rows.PLAIN_CALLS

    out = {"load_s": load_s, "n_quads": nq, "queries": {}}
    with forced_device():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the counted run: each query once, counts zeroed just before
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        setop_rows.LAUNCHES = setop_rows.PLAIN_CALLS = 0
        answers = {}
        per_query, setop_per_query, copies = {}, {}, {}
        calls, tiles = {}, {}
        with _Capture(member_sweep) as cap, _Capture(setop_rows, SETOP_WRAPPERS) as scap, \
                _Copies() as cp, _PlainOps() as pops:
            for name, q in QUERIES.items():
                c0, s0, b0, n0 = count(), setop_count(), cp.bytes(), len(scap.shapes)
                g0 = setop_rows.GLOBAL_TILES
                answers[name] = _run_query(server, q)
                per_query[name] = count() - c0
                setop_per_query[name] = setop_count() - s0
                copies[name] = {"cold": [b - a for a, b in zip(b0, cp.bytes())]}
                calls[name] = {w: [k[1:] for k in scap.shapes[n0:] if k[0] == w]
                               for w in SETOP_WRAPPERS if any(k[0] == w for k in scap.shapes[n0:])}
                tiles[name] = setop_rows.GLOBAL_TILES - g0
        out["launches"] = member_sweep.LAUNCHES
        out["plain_calls"] = member_sweep.PLAIN_CALLS
        out["setop_launches"] = setop_rows.LAUNCHES
        out["sweep_per_query"] = per_query
        out["setop_per_query"] = setop_per_query
        # each query's setop_rows calls by wrapper, at their shapes, and the
        # tiles of them that searched b in global memory
        out["setop_calls"] = calls
        out["global_tiles"] = tiles
        out["sweep_shapes"] = sorted(set(cap.shapes))
        out["setop_captured"] = scap.by_shape
        out["plain_ops"] = (pops.calls, pops.largest)
        # bytes (to the card, back) of each query's first and of a warm read
        out["copies"] = copies
        if on_card:
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["device_cache"] = dispatch.DISPATCHER.device_cache.stats()
        out["answers"] = answers
        for name, q in QUERIES.items():
            with _Copies() as cp:  # one warm read's copies
                _run_query(server, q)
            copies[name]["warm"] = list(cp.bytes())
            copies[name]["fetch_ms"] = cp.fetch_ms  # each read back, host clock
            ms_dev = []
            for _ in range(reps):
                t = time.perf_counter()
                again = _run_query(server, q)
                ms_dev.append((time.perf_counter() - t) * 1e3)
                if again != answers[name]:
                    raise AssertionError(f"query {name}: device path not stable")
            ms_host = []
            with forced_device(False):  # no set op on the card
                for _ in range(reps):
                    t = time.perf_counter()
                    host = _run_query(server, q)
                    ms_host.append((time.perf_counter() - t) * 1e3)
            if host != answers[name]:
                raise AssertionError(f"query {name}: device path != host path")
            want = expected(g, "a" if name == "a" else "b")
            if extract(name, json.loads(answers[name])) != want:
                raise AssertionError(f"query {name}: != numpy reference")
            out["queries"][name] = {
                "device_ms": float(np.median(ms_dev)),
                "host_ms": float(np.median(ms_host)),
                "bytes": len(answers[name]),
            }
        for name in profile:
            log(f"profile of query ({name}) on the device path:")
            profile_query(server, QUERIES[name], log=lambda m: log("  " + m))
    if keep:
        out["server"], out["graph"] = server, g
    return out


# the graph of K1's served read: a pool of 20,000 with one node in 200 hot,
# about 50 hot uids a segment
K1_GRAPH = {"fanout": 30, "pool": 20_000, "hot_every": 200}


def k1_read(device="cuda", log=print):
    """The served read that reaches K1: query (c) over a small graph with a
    rare hot tag (K1_GRAPH), whose AND chain crosses 2^32 with <= 128 of a
    segment on its small side, so the dispatcher's pair path runs it
    through the member sweep and its compaction (`_run_bucket`), as the
    reference's Pallas branch does. Its answer must equal the host path's
    and numpy's; K1 must launch. Returns K1's launches, the shapes it
    took and its largest input, cloned."""
    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.ops import member_sweep
    from dgraph_tpu_torch.query import dispatch

    g = make_graph(**K1_GRAPH)
    server = Server(device=device)
    server.slow_query_ms = float("inf")
    load_graph(server, g)
    dispatch.DISPATCHER.device_cache.clear()  # no operand of another store
    on_card = device != "cpu"
    with forced_device(), _Capture(member_sweep) as cap:
        c0 = member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS
        got = _run_query(server, QUERIES["c"])
        sweeps = (member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS) - c0
    with forced_device(False):
        host = _run_query(server, QUERIES["c"])
    dispatch.DISPATCHER.device_cache.clear()
    if got != host:
        raise AssertionError("K1's read (c): device path != host path")
    if extract("c", json.loads(got)) != expected(g, "b"):
        raise AssertionError("K1's read (c): != numpy reference")
    if sweeps < 1:
        raise AssertionError("K1's read (c): the member sweep did not launch")
    log(f"K1's read: (c) over make_graph(**{K1_GRAPH}) ({len(g['hot'])} hot): device == "
        f"host == numpy; K1 {sweeps} launches at (n, pa, pb) {sorted(set(cap.shapes))}")
    return {"launches": sweeps, "shapes": sorted(set(cap.shapes)), "captured": cap.args}


# ---------------------------------------------------------------------------
# K1: the member sweep against its plain version
# ---------------------------------------------------------------------------


def _events_ms(fn, reps):
    """Median device time of fn in ms, by CUDA events, after a warm call;
    each timed sample runs fn enough times to last about a millisecond."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    inner = max(1, min(100, int(1.0 / max(s.elapsed_time(e), 1e-3))))
    times = []
    for _ in range(reps):
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


def kernel_device_ms(fn, reps=20, name="member_sweep_kernel"):
    """Device time of one call of fn in ms, from the card's own trace
    (torch.profiler, CUPTI), without the host's time between launches
    that CUDA events around back-to-back calls also take in. `name`: the
    kernel fn launches once, or {kernel name: launches per call} for a
    call that launches several. The trace may hold fewer launches than
    were made (calls whose trace came back short are noted in
    TRACE_SHORT), so each kernel's time is its traced average times its
    launches per call. How many traces and calls it took is left in
    LAST_TRACE."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = {name: 1} if isinstance(name, str) else dict(name)
    fn()
    lead = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    seen = []
    # A trace loses the first kernels launched in it: 7 early in a run,
    # 17 and once 74 late in it, when a trace of `reps` calls of a small
    # kernel can hold none. TRACE_LEAD_IN launches of a fill go first to
    # take that loss; a trace that still holds no kernel of fn is taken
    # again, ten times longer. TRACE_SHORT says where launches were lost.
    for tries, n_calls in enumerate((reps, 10 * reps, 10 * reps), 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD_IN):
                lead.zero_()
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        got = {}
        for e in prof.key_averages():
            for n in per_call:
                if e.count and n in e.key:
                    t, c = got.get(n, (0.0, 0))
                    got[n] = (t + e.self_device_time_total, c + e.count)
        lost = _lost_launches(prof)
        if set(got) == {n for n, c in per_call.items() if c}:
            for n, (_, c) in got.items():
                if c != n_calls * per_call[n]:
                    TRACE_SHORT.append((n, c, n_calls * per_call[n], lost))
            LAST_TRACE.update(traces=tries, calls=n_calls)
            return sum(t / c * per_call[n] for n, (t, c) in got.items()) / 1e3
        TRACE_EMPTY.append((sorted(per_call), n_calls, lost))
        seen = [e.key[:60] for e in prof.key_averages()]
    raise AssertionError(f"no device time traced for {sorted(per_call)} in {tries} traces; "
                         f"saw {seen}")


def _lost_launches(prof):
    """Where a trace lost kernels: the positions, in launch order, of the
    kernel launches whose kernel record (same CUPTI correlation id) the
    trace does not hold, as "first n", "last n" or a list, out of all
    launches traced. A diagnostic only: a trace it cannot read says so."""
    try:
        evs = prof.profiler.kineto_results.events()
        launches = sorted((e for e in evs if e.name().startswith("cudaLaunchKernel")),
                          key=lambda e: e.start_ns())
        ran = {e.correlation_id() for e in evs if str(e.device_type()).endswith("CUDA")}
    except Exception as e:  # noqa: BLE001 - the profiler's private API moved
        return f"not read ({type(e).__name__}: {e})"
    lost = [i for i, e in enumerate(launches) if e.correlation_id() not in ran]
    if ran and len(lost) == len(launches):
        return f"no launch linked to a kernel record, {len(launches)} launches"
    n = len(lost)
    if lost == list(range(n)):
        where = f"first {n}"
    elif lost == list(range(len(launches) - n, len(launches))):
        where = f"last {n}"
    else:
        where = str(lost[:12])
    return f"{where} of {len(launches)} launches"


TRACE_LEAD_IN = 128
LAST_TRACE = {}  # traces and calls per trace that the last kernel_device_ms took
TRACE_EMPTY = []  # (kernels, calls, where launches were lost) of traces without a kernel
TRACE_SHORT = []  # (kernel, calls traced, calls made, lost launches) where they differ


def _to_i64(x):
    import torch

    return x.to(torch.int64) & U32


def sorted_keys(B, LB):
    """B's rows as int64 u32 values with 2^32 past LB: sorted over the full
    width whatever the padding, for torch.searchsorted. A shared B (pb,)
    gives one row (1, pb)."""
    import torch

    cols = torch.arange(B.shape[-1], device=B.device)
    return torch.where(cols < LB.unsqueeze(1), _to_i64(B), 1 << 32)


def _search(key, q):
    """(position of each q in its row of key, the key there): a key of
    one row serves every row of q."""
    import torch

    pb = key.shape[1]
    if key.shape[0] == 1:
        p = torch.searchsorted(key[0], q)
        return p, key[0][p.clamp(max=pb - 1)]
    p = torch.searchsorted(key, q)
    return p, torch.gather(key, 1, p.clamp(max=pb - 1))


def library_membership(A64, LA, Bkey, LB):
    """One batched torch.searchsorted + gather-compare: the yardstick,
    timed here and called nowhere in the port. Bkey from sorted_keys."""
    import torch

    idx, at = _search(Bkey, A64)
    hit = (idx < LB.unsqueeze(1)) & (at == A64)
    return hit & (torch.arange(A64.shape[1], device=A64.device) < LA.unsqueeze(1))


def sweep_bound_ms(A, LA, B, LB):
    """Least time any correct method could take on these sorted rows, in
    ms, and what bounds it. Bytes: A's valid elements, LA, LB (one length
    for a shared B), the n * pa mask, and every distinct 32-byte sector of B that
    holds, for a valid query, its equal element or, where B has none, its
    neighbours in the valid prefix (no method can answer the query without
    them), all at the card's memory rate. Compares are left out: the
    fewest any method needs, about LA * log2(LB / LA + 1) per row, at most
    32 per query, take less time at 67 T/s than the query's own 4 bytes of
    A take at 3.35 TB/s. So the bound is always the bytes."""
    n, pa = A.shape
    nbytes = 4 * int(LA.sum()) + 4 * n + 4 * LB.numel() + n * pa
    return (nbytes + b_sector_bytes(A, LA, B, LB)) / HBM_BYTES_PER_S * 1e3, "bytes"


def b_sector_bytes(A, LA, B, LB):
    """The bytes of B any correct membership method must read: every
    distinct 32-byte sector that holds, for a valid query of A, its equal
    element or, where B has none, its neighbours in the valid prefix. A
    shared B (pb,) counts its sectors once for all rows."""
    import torch

    n, pa = A.shape
    pb = B.shape[-1]
    if not (pb and n):
        return 0
    lb = LB.to(torch.int64).unsqueeze(1)
    key = sorted_keys(B, LB)
    q = _to_i64(A)
    p, at_p = _search(key, q)
    eq = (p < lb) & (at_p == q)
    valid = torch.arange(pa, device=A.device) < LA.to(torch.int64).unsqueeze(1)
    row0 = 0 if B.dim() == 1 else torch.arange(n, device=A.device).unsqueeze(1) * pb
    at = torch.where(valid & (eq | (p < lb)), row0 + p, -1)  # equal or next
    before = torch.where(valid & ~eq & (p > 0), row0 + p - 1, -1)
    elems = torch.cat([at[at >= 0], before[before >= 0]])
    return 32 * int(torch.unique(elems // 8).numel())  # B 32-byte aligned


def all_of_b_ms(A, LA, B, LB):
    """The byte term of the compare-all kernel's bound, for comparison:
    every valid element of A and B read once, the lengths and the mask,
    at the card's memory rate (ms)."""
    n, pa = A.shape
    nbytes = 4 * int(LA.sum()) + 4 * int(LB.sum()) + 8 * n + n * pa
    return nbytes / HBM_BYTES_PER_S * 1e3


def regimes(LA, LB):
    """Rows per regime of the kernel, from the lengths alone, by the
    kernel's own rule (`member_sweep.search_from`)."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    la, lb = LA.to(torch.int64), LB.to(torch.int64)
    live = (la > 0) & (lb > 0)
    table = torch.tensor([member_sweep.search_from(k) for k in range(member_sweep.LANE + 1)],
                         device=la.device)
    search = live & (lb >= table[la.clamp(0, member_sweep.LANE)])
    return {"search": int(search.sum()), "stream": int((live & ~search).sum()),
            "empty": int((~live).sum())}


def measure_sweep(A, LA, B, LB, reps=7):
    """Kernel vs plain (exact), the times of kernel, plain and library,
    the bound, and the rows per regime."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    got = member_sweep.membership_batch(A, LA, B, LB)
    want = member_sweep.membership_batch_plain(A, LA, B, LB)
    torch.cuda.synchronize()
    err = int((got != want).sum().item())
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    A64, Bkey = _to_i64(A), sorted_keys(B, LB)
    lib = library_membership(A64, LA, Bkey, LB)
    lib_agrees = bool(torch.equal(lib, want))
    bound, bound_by = sweep_bound_ms(A, LA, B, LB)
    return {
        "mismatches": err,
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
        "library_agrees": lib_agrees,
        "ms": _events_ms(lambda: member_sweep.membership_batch(A, LA, B, LB), reps),
        "device_ms": kernel_device_ms(lambda: member_sweep.membership_batch(A, LA, B, LB)),
        "device_trace": dict(LAST_TRACE),
        "plain_ms": _events_ms(
            lambda: member_sweep.membership_batch_plain(A, LA, B, LB), max(3, reps // 2)
        ),
        "library_ms": _events_ms(lambda: library_membership(A64, LA, Bkey, LB), reps),
        "bound_ms": bound,
        "bound_by": bound_by,
        "regimes": regimes(LA, LB),
    }


def random_rows(n, pa, pb, seed, kind="random", device="cuda"):
    """Sorted B rows (valid prefix LB in [pb/2, pb], UINT32_MAX after),
    A rows of LA <= pa queries, about half drawn from B, as int32 bits.
    `kind`: "full" sets LA = pa and LB = pb; "equal" repeats each query
    once; "zero_pad" pads A and B with zeros; "switch" takes LA in
    [1, pa] and LB one below, then at, the least LB the kernel searches
    for LA queries, on alternate rows (pb >= that for pa)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    B = torch.randint(0, 1 << 32, (n, pb), generator=gen, device=device).sort(1).values
    LB = torch.randint(max(1, pb // 2), pb + 1, (n,), generator=gen, device=device)
    LA = torch.randint(0, pa + 1, (n,), generator=gen, device=device)
    if kind == "full":
        LA.fill_(pa)
        LB.fill_(pb)
    elif kind == "switch":
        from dgraph_tpu_torch.ops.member_sweep import search_from

        if pb < search_from(pa):
            raise ValueError(f"switch rows need pb >= {search_from(pa)}")
        LA = LA.clamp(min=1)
        at = torch.tensor([search_from(k) for k in range(pa + 1)], device=device)
        LB = at[LA] - torch.arange(n, device=device) % 2
    pad = 0 if kind == "zero_pad" else U32
    cols = torch.arange(pb, device=device)
    B = torch.where(cols < LB.unsqueeze(1), B, pad)
    pick = torch.randint(0, 1 << 30, (n, pa), generator=gen, device=device) % LB.unsqueeze(1)
    fresh = torch.randint(0, 1 << 32, (n, pa), generator=gen, device=device)
    coin = torch.rand((n, pa), generator=gen, device=device) < 0.5
    A = torch.where(coin, torch.gather(B, 1, pick), fresh).sort(1).values
    if kind == "equal":
        A[:, 1::2] = A[:, 0 : pa - pa % 2 : 2]
    A = torch.where(torch.arange(pa, device=device) < LA.unsqueeze(1), A, pad)

    def bits(x):
        return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).contiguous()

    return bits(A), LA.to(torch.int32), bits(B), LB.to(torch.int32)


def sweep_edge_cases():
    """The reference's edge cases: 0xFFFFFFFF is a legal uid, and zeros
    in B's padding never hit."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    def run(a, b, pad):
        A = np.full((1, 8), 0xFFFFFFFF, np.uint32)
        B = np.full((1, 1024), pad, np.uint32)
        A[0, : len(a)] = a
        B[0, : len(b)] = b
        t = [
            torch.from_numpy(x.view(np.int32)).cuda()
            for x in (A, np.array([len(a)], np.int32), B, np.array([len(b)], np.int32))
        ]
        got = member_sweep.membership_batch(*t)
        want = member_sweep.membership_batch_plain(*t)
        if not torch.equal(got, want):
            raise AssertionError(f"edge case {a} in {b}: kernel != plain")
        return got[0, : len(a)].tolist()

    assert run([1, 0xFFFFFFFF], [0xFFFFFFFF], 0xFFFFFFFF) == [False, True]
    assert run([0], [5], 0) == [False]
    assert run([0, 5], [5], 0) == [False, True]


def sweep_grid():
    """Phase 3: kernel == plain over the grid and the special rows."""
    from dgraph_tpu_torch.ops import member_sweep

    shapes = []
    for pb in (1024, 65536, 1 << 20):
        for pa in (1, 8, 64, 128):
            for n in (1, 64, 4096):
                shapes.append(("random", n, pa, pb))
    shapes += [("equal", 4096, 64, 1024), ("equal", 1024, 128, 65536),
               ("zero_pad", 4096, 64, 1024), ("zero_pad", 64, 128, 1 << 20)]
    shapes += [("switch", 4096, pa, member_sweep.search_from(pa)) for pa in (4, 64, 128)]
    for kind, n, pa, pb in shapes:
        # keep B within 1 GiB and a shape within 2^35 compares of the
        # plain version
        m = min(n, (1 << 28) // pb, (1 << 35) // (pa * pb))
        rows = random_rows(m, pa, pb, seed=pa * 131 + pb + n, kind=kind)
        r = measure_sweep(*rows)
        if r["mismatches"] or not r["library_agrees"]:
            raise AssertionError(f"{kind} n={m} pa={pa} pb={pb}: {r}")
        cut = f" (n cut from {n})" if m != n else ""
        print(f"    {kind} n={m}{cut} pa={pa} pb={pb}: equal; " + _fmt(r)
              + f"; rows {r['regimes']}", flush=True)
        del rows


def check_sorted(A, LA, B, LB):
    """The kernel's precondition: every row sorted ascending as uint32
    within its length. Raises on the first row that is not."""
    import torch

    for name, X, L in (("A", A, LA), ("B", B if B.dim() == 2 else B[None], LB)):
        if X.shape[1] < 2:
            continue
        x = _to_i64(X)
        inside = torch.arange(1, X.shape[1], device=X.device) < L.unsqueeze(1)
        bad = ((x[:, 1:] < x[:, :-1]) & inside).any(1)
        if bool(bad.any()):
            raise AssertionError(f"main-path {name} row {int(bad.nonzero()[0, 0])} "
                                 "is not sorted as uint32")


# ---------------------------------------------------------------------------
# K2 + K3: setop_rows against its plain version
# ---------------------------------------------------------------------------

# row kinds of setop_rows_case: "random" draws about half of A from b;
# "all" takes all of A from b, "none" none of it; "max" ends every valid
# row of A and b with UINT32_MAX, a real uid there; "sign" draws every
# value within 4096 of 2^31 (a signed compare fails); "la0" and "lb0"
# empty every other row of A or of b
SETOP_KINDS = ("random", "all", "none", "max", "sign", "la0", "lb0")


def setop_rows_case(n, pa, pb, seed, kind="random", shared=False):
    """Sorted rows for setop_rows, made with numpy from `seed`: A (n, pa)
    against B (n, pb) with LB (n,), or against one B (pb,) with LB (1,)
    when `shared`; uids as int32 bits, UINT32_MAX past each length."""
    rng = np.random.default_rng(seed)
    nb = 1 if shared else n
    lo, hi = ((1 << 31) - 4096, (1 << 31) + 4096) if kind == "sign" else (0, 1 << 32)
    B = np.sort(rng.integers(lo, hi, size=(nb, pb), dtype=np.uint64), axis=1)
    LB = rng.integers(max(1, pb // 2), pb + 1, size=nb) if pb else np.zeros(nb, np.int64)
    LA = rng.integers(0, pa + 1, size=n)
    fresh = rng.integers(lo, hi, size=(n, pa), dtype=np.uint64)
    if kind == "none":  # b even, A odd
        B &= ~np.uint64(1)
        fresh |= np.uint64(1)
    rows = np.zeros(n, np.int64) if shared else np.arange(n)
    lbr = LB[rows]
    pick = rng.integers(0, 1 << 62, size=(n, pa)) % np.maximum(lbr, 1)[:, None]
    from_b = B[rows[:, None], pick] if pb else fresh
    coin = rng.random((n, pa)) < {"all": 2.0, "none": -1.0}.get(kind, 0.5)
    A = np.sort(np.where(coin & (lbr[:, None] > 0), from_b, fresh), axis=1)
    if kind in ("all", "none", "max"):
        LA[:] = pa
    if kind == "la0":
        LA[::2] = 0
    if kind == "lb0":
        LB[::2] = 0
    if kind == "max":
        live = LB > 0
        B[np.flatnonzero(live), LB[live] - 1] = U32
        A[:, -1] = U32
    B = np.where(np.arange(pb) < LB[:, None], B, U32)
    A = np.where(np.arange(pa) < LA[:, None], A, U32)

    def bits(x):
        return np.ascontiguousarray(x.astype(np.uint32)).view(np.int32)

    B = bits(B[0] if shared else B)
    return bits(A), LA.astype(np.int32), B, LB.astype(np.int32)


def setop_ragged_case(lens, blens, seed, kind="random", shared=True):
    """Ragged rows for setop_rows, made with numpy from `seed`: rows of
    `lens` words back to back in A (offsets offs) against the ranges of
    `blens` words of one B (a table of (start, length) pairs); row i
    searches range rid[i], drawn at random when `shared`, else range
    i % len(blens) (one range a row when they are as many). Kinds as in
    SETOP_KINDS ("la0" and "lb0" empty every other row or range). Returns
    int32 numpy arrays (A, offs, rid, B, ranges), uids as their bits."""
    rng = np.random.default_rng(seed)
    lens, blens = np.array(lens, np.int64), np.array(blens, np.int64)
    if kind == "la0":
        lens[::2] = 0
    if kind == "lb0":
        blens[::2] = 0
    m, r = len(lens), len(blens)
    lo, hi = ((1 << 31) - 4096, (1 << 31) + 4096) if kind == "sign" else (0, 1 << 32)
    top = np.uint64(32)
    bid = np.repeat(np.arange(r, dtype=np.uint64), blens)
    bval = rng.integers(lo, hi, size=bid.size, dtype=np.uint64)
    if kind == "none":  # b even, A odd
        bval &= ~np.uint64(1)
    B = np.sort((bid << top) | bval) & np.uint64(U32)  # each range sorted
    start = np.zeros(r, np.int64)
    np.cumsum(blens[:-1], out=start[1:])
    if kind == "max":
        B[(start + blens - 1)[blens > 0]] = U32
    rid = rng.integers(0, r, size=m) if shared else np.arange(m) % r
    aid = np.repeat(np.arange(m), lens)
    own = rid[aid]
    fresh = rng.integers(lo, hi, size=aid.size, dtype=np.uint64)
    if kind == "none":
        fresh |= np.uint64(1)
    from_b = fresh
    if B.size:
        pick = start[own] + rng.integers(0, 1 << 62, size=aid.size) % np.maximum(blens[own], 1)
        from_b = B[np.minimum(pick, B.size - 1)]
    coin = rng.random(aid.size) < {"all": 2.0, "none": -1.0}.get(kind, 0.5)
    vals = np.where(coin & (blens[own] > 0), from_b, fresh)
    A = np.sort((aid.astype(np.uint64) << top) | vals) & np.uint64(U32)  # each row sorted
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if kind == "max":
        A[offs[1:][lens > 0] - 1] = U32

    def bits(x):
        return np.ascontiguousarray(x.astype(np.uint32)).view(np.int32)

    return (bits(A), offs.astype(np.int32), rid.astype(np.int32), bits(B),
            np.stack([start, blens], 1).astype(np.int32))


def setop_plain(name):
    """The plain PyTorch version of setop_rows wrapper `name`."""
    from dgraph_tpu_torch.ops import setop_rows

    if name == "compact_batch":
        return setop_rows.compact_batch_plain
    op = name.split("_")[0]
    if name.endswith("_ragged"):
        return lambda *args: setop_rows.setop_ragged_plain(op, *args)
    return lambda *args: setop_rows.setop_batch_plain(op, *args)


def ragged_keys(A, offs, rid, B, ranges):
    """Keys (range id << 32) | uid of A's words (each keyed by its row's
    range) and of B's ranges in table order, and the index in B of each
    key of B."""
    import torch

    dev = A.device
    lens = (offs[1:] - offs[:-1]).to(torch.int64)
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens,
                                  output_size=A.numel())
    start, length = ranges[:, 0].to(torch.int64), ranges[:, 1].to(torch.int64)
    rr = torch.repeat_interleave(torch.arange(ranges.shape[0], device=dev), length)
    at = torch.arange(rr.numel(), device=dev) - (torch.cumsum(length, 0) - length)[rr] + start[rr]
    return (rid.to(torch.int64)[row] << 32) | _to_i64(A), (rr << 32) | _to_i64(B)[at], at


def library_setop(name, *args):
    """The yardstick, timed here and called nowhere in the port: one
    torch.isin and one torch.masked_select over the same rows (a b per
    row, or a range of B a row, searched as keys row or range * 2^32 +
    uid, made beforehand). Returns the call; it gives the kept uids of
    every row, flat."""
    import torch

    if name == "compact_batch":
        A, keep = args
        return lambda: torch.masked_select(A, keep)
    invert = name.startswith("difference")
    if name.endswith("_ragged"):
        a, b, _ = ragged_keys(*args)
        return lambda: torch.masked_select(args[0], torch.isin(a, b, invert=invert))
    A, LA, B, LB = args
    n, pa = A.shape
    valid = torch.arange(pa, device=A.device) < LA.unsqueeze(1)
    if B.dim() == 1:
        a, b = _to_i64(A), _to_i64(B)[: int(LB[0])]
    else:
        rows = (torch.arange(n, device=A.device) << 32).unsqueeze(1)
        a = _to_i64(A) + rows
        b = (_to_i64(B) + rows)[torch.arange(B.shape[1], device=B.device) < LB.unsqueeze(1)]
    return lambda: torch.masked_select(A, valid & torch.isin(a, b, invert=invert))


def ragged_b_sector_bytes(A, offs, rid, B, ranges):
    """b_sector_bytes for the ragged form: every distinct 32-byte sector
    of B that holds, for a word of A, its equal element in its row's
    range or, where the range has none, its neighbours there. Also
    returns how many words of A the ranges hold."""
    import torch

    a, b, at = ragged_keys(A, offs, rid, B, ranges)
    n = b.numel()
    if not (n and a.numel()):
        return 0, 0
    p = torch.searchsorted(b, a)
    pc, pm = p.clamp(max=n - 1), (p - 1).clamp(min=0)
    eq = (p < n) & (b[pc] == a)
    nxt = (p < n) & ((b[pc] >> 32) == (a >> 32))  # equal or next, same range
    prv = ~eq & (p > 0) & ((b[pm] >> 32) == (a >> 32))
    elems = torch.cat([at[pc[nxt]], at[pm[prv]]])
    return 32 * int(torch.unique(elems // 8).numel()), int(eq.sum())  # B 32-byte aligned


def setop_bound_ms(name, args):
    """Least time any correct method could take, in ms, and what bounds
    it: the bytes. Read once: A's valid elements, the lengths or offsets,
    range ids and range table, and the sectors of B a membership needs,
    or for a compaction the keep mask and the kept elements; written
    once: the padded form's n * pa output words and n counts, the ragged
    form's kept words and m + 1 offsets. The compares, about log2 of the
    range an element, take less time at 67 T/s than its 4 bytes at
    3.35 TB/s."""
    A = args[0]
    if name.endswith("_ragged"):
        _, offs, rid, _, ranges = args
        sectors, held = ragged_b_sector_bytes(*args)
        kept = held if name.startswith("intersect") else A.numel() - held
        nbytes = (4 * A.numel() + 4 * offs.numel() + 4 * rid.numel() + 4 * ranges.numel()
                  + sectors + 4 * kept + 4 * offs.numel())
        return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
    n, pa = A.shape
    nbytes = 4 * n * pa + 4 * n
    if name == "compact_batch":
        nbytes += n * pa + 4 * int(args[1].sum())
    else:
        A, LA, B, LB = args
        nbytes += (4 * int(LA.clamp(0, pa).sum()) + 4 * n + 4 * LB.numel()
                   + b_sector_bytes(A, LA, B, LB))
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _setop_words(name, res):
    """A setop_rows result as what it answers: the padded form's (out,
    cnt) as they are, the ragged form's out_off and its kept words alone
    (head's last word, the tiles that searched global memory, apart)."""
    if not name.endswith("_ragged"):
        return res
    out, head = res
    return head[:-1], out[: int(head[-2])]


def measure_setop(name, args, reps=5, timed=True):
    """setop_rows wrapper `name` against its plain version on `args`
    (exact: mismatching words of out and cnt, or of out_off and the kept
    words), and with `timed` the kernel (events), device (trace), plain
    and library times and the bound, in ms. A ragged call is made twice
    back to back and must give the same words both times."""
    import torch

    from dgraph_tpu_torch.ops import setop_rows

    fn, plain = getattr(setop_rows, name), setop_plain(name)
    raw = fn(*args)
    got, want = _setop_words(name, raw), _setop_words(name, plain(*args))
    ragged = name.endswith("_ragged")
    if ragged:
        again = _setop_words(name, fn(*args))
    torch.cuda.synchronize()
    bad = 0
    for g, w in zip(got, want):
        bad += int((g != w).sum()) if g.shape == w.shape else max(g.numel(), w.numel(), 1)
    if ragged:
        bad += sum(int((g != a).sum()) if g.shape == a.shape else max(g.numel(), 1)
                   for g, a in zip(got, again))
    errs = [(_to_i64(g) - _to_i64(w)).abs() for g, w in zip(got, want) if g.shape == w.shape]
    r = {"mismatches": bad,
         "max_abs_err": float(max([float(e.max()) for e in errs if e.numel()] + [0.0]))}
    if ragged:
        r["global_tiles"] = int(raw[1][-1])
    if not timed:
        return r
    lib = library_setop(name, *args)
    if ragged:
        kept = want[1]
    else:
        pa = args[0].shape[1]
        kept = want[0][torch.arange(pa, device=want[0].device) < want[1].unsqueeze(1)]
    bound, bound_by = setop_bound_ms(name, args)
    r.update({
        "library_agrees": bool(torch.equal(lib(), kept)),
        "ms": _events_ms(lambda: fn(*args), reps),
        "device_ms": kernel_device_ms(lambda: fn(*args), name=setop_rows.kernel_names()),
        "device_trace": dict(LAST_TRACE),
        "plain_ms": _events_ms(lambda: plain(*args), max(3, reps // 2)),
        "library_ms": _events_ms(lib, reps),
        "bound_ms": bound,
        "bound_by": bound_by,
    })
    return r


# (n, pa, pb) of the padded form's timed grid: (b)'s sub-rows against one
# segment's filter, bucketed rows of 64 and 128, longer rows, and (d)'s
# long rows against a long b
SETOP_GRID = [(20000, 64, 1024), (4096, 128, 65536), (1000, 129, 4096), (64, 4096, 65536),
              (2, 1 << 17, 1 << 17), (1, 1 << 20, 1 << 20)]
# (n, pa, pb) of the row kinds' check: one query a row, rows of 8 and of
# 129, two long rows
SETOP_EDGE_SHAPES = [(1000, 1, 64), (1000, 8, 1024), (300, 129, 2000), (2, 1 << 17, 1 << 17)]


def ragged_grid(seed=0):
    """(label, row lengths, range lengths, shared) of the ragged form's
    timed grid: (b)'s whole level (1M words in 20,000 sub-rows, each
    row's two sub-rows against b's two segments of 1,000), (d)'s
    difference (2 rows of 2^17, a range of 2^17 each), one row of 2^20
    against 2^20, and 20,000 pairs of <= 64 against <= 512."""
    rng = np.random.default_rng(seed)
    return [
        ("(b) level", rng.integers(0, 101, size=20000), [1000, 1000], True),
        ("(d) difference", [1 << 17] * 2, [1 << 17] * 2, False),
        ("one row of 2^20", [1 << 20], [1 << 20], False),
        ("20,000 pairs", rng.integers(0, 65, size=20000), rng.integers(0, 513, size=20000), False),
    ]


# (label, row lengths, range lengths) of the ragged row kinds' check, each
# with a shared and a paired table: rows of 0 and 1, many short rows
# against two ranges, a long row among empty ones
RAGGED_EDGE = [
    ("rows of 0 and 1", [0, 1] * 2000, [50, 0, 3000]),
    ("short rows", list(range(0, 200, 3)), [900, 1500]),
    ("a long row among empty ones", [0] * 30 + [1 << 17] + [0] * 30, [1 << 16, 1 << 17]),
]


def setop_grid(device="cuda", log=print):
    """setop_rows against its plain version, exactly: every wrapper, both
    forms of B and both forms of the rows, every row kind of SETOP_KINDS
    at the edge shapes, timed on random rows at every shape of SETOP_GRID
    and ragged_grid; then K1 with a shared B (stride 0); then the
    forced-device dispatcher over rows across 2^32 against numpy."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    def tensors(case):
        return [torch.from_numpy(x).to(device) for x in case]

    for shared in (False, True):
        for kind in SETOP_KINDS:
            for n, pa, pb in SETOP_EDGE_SHAPES:
                args = tensors(setop_rows_case(n, pa, pb, seed=pa + pb, kind=kind, shared=shared))
                for name in ("intersect_batch", "difference_batch"):
                    if measure_setop(name, args, timed=False)["mismatches"]:
                        raise AssertionError(f"{name} {kind} {shared} {(n, pa, pb)}: != plain")
            for label, lens, blens in RAGGED_EDGE:
                table = blens if shared else [blens[i % len(blens)] for i in range(len(lens))]
                args = tensors(setop_ragged_case(lens, table, seed=len(lens), kind=kind,
                                                 shared=shared))
                for name in ("intersect_ragged", "difference_ragged"):
                    if measure_setop(name, args, timed=False)["mismatches"]:
                        raise AssertionError(f"{name} {kind} {shared} {label}: != plain")
    log(f"edge rows: intersect and difference equal to plain over {len(SETOP_KINDS)} row "
        f"kinds x (n, pa, pb) {SETOP_EDGE_SHAPES} and ragged {[r[0] for r in RAGGED_EDGE]} "
        "x (paired, shared); ragged calls equal twice back to back")
    for n, pa, pb in SETOP_GRID:
        for shared in (False, True):
            args = tensors(setop_rows_case(n, pa, pb, seed=n + pa + pb, shared=shared))
            keep = torch.rand(args[0].shape, device=device,
                              generator=torch.Generator(device).manual_seed(pa)) < 0.5
            form = "shared" if shared else "paired"
            for name in ("intersect_batch", "difference_batch") + (("compact_batch",) * shared):
                r = measure_setop(name, (args[0], keep) if name == "compact_batch" else args)
                if r["mismatches"] or not r["library_agrees"]:
                    raise AssertionError(f"{name} {form} {(n, pa, pb)}: {r}")
                log(f"{name} {form} n={n} pa={pa} pb={pb}: equal; " + _fmt(r))
            del args, keep
    for i, (label, lens, blens, shared) in enumerate(ragged_grid()):
        args = tensors(setop_ragged_case(lens, blens, seed=i, shared=shared))
        for name in ("intersect_ragged", "difference_ragged"):
            r = measure_setop(name, args)
            if r["mismatches"] or not r["library_agrees"]:
                raise AssertionError(f"{name} {label}: {r}")
            log(f"{name} {label} (m={len(lens)}, N={args[0].numel()}, nB={args[3].numel()}): "
                f"equal, twice; global-memory tiles {r['global_tiles']}; " + _fmt(r))
        del args
    # the compaction of K1's mask at the shape (b)'s level gave it when K1
    # served (b): 10,000 rows of 128, 1% kept
    A = tensors(setop_rows_case(10000, 128, 1, seed=7))[0]
    keep = torch.rand(A.shape, device=device, generator=torch.Generator(device).manual_seed(7)) < 0.01
    r = measure_setop("compact_batch", (A, keep))
    if r["mismatches"] or not r["library_agrees"]:
        raise AssertionError(f"compact_batch at (b)'s K1 mask: {r}")
    log("compact_batch n=10000 pa=128, 1% kept ((b)'s former K1 mask): equal; " + _fmt(r))
    del A, keep
    for kind in ("random", "max", "lb0"):
        args = tensors(setop_rows_case(20000, 64, 1024, seed=5, kind=kind, shared=True))
        if not torch.equal(member_sweep.membership_batch(*args),
                           member_sweep.membership_batch_plain(*args)):
            raise AssertionError(f"K1 with a shared B ({kind}) != plain")
    log("K1 with a shared B (stride 0), n=20000 pa=64 pb=1024: equal to plain")
    log(dispatcher_across_segments(device))


def dispatcher_across_segments(device="cuda", seed=4):
    """The forced-device dispatcher's three entries over rows with uids on
    both sides of 2^32, against numpy: rows against a shared b in its
    ragged and list forms (one setop_rows launch over every segment),
    and pairs, wide (setop_rows, one launch with a range a pair) and with
    <= 128 of a segment on the small side (intersect: K1 and its
    compaction, a bucket of padded shapes)."""
    from dgraph_tpu_torch.query import dispatch

    rng = np.random.default_rng(seed)

    def straddle(k, width=4000):
        return np.union1d(rng.integers(SEG - width, SEG, size=k // 2, dtype=np.uint64),
                          rng.integers(SEG, SEG + width, size=k - k // 2, dtype=np.uint64))

    d = dispatch.SetOpDispatcher(device=device)
    with forced_device():
        for op, np_op in (("intersect", np.intersect1d), ("difference", np.setdiff1d)):
            for width in (80, 900):
                rows = [straddle(int(k)) for k in rng.integers(0, 2 * width, size=300)]
                b = straddle(3000)
                flat = np.concatenate(rows).astype(np.uint64)
                offs = np.zeros(len(rows) + 1, np.int64)
                np.cumsum([len(r) for r in rows], out=offs[1:])
                want = [np_op(r, b, assume_unique=True) for r in rows]
                got, got_offs = d.run_rows_vs_one_ragged(op, flat, offs, b)
                if not (np.array_equal(got, np.concatenate(want))
                        and np.array_equal(np.diff(got_offs), [len(w) for w in want])):
                    raise AssertionError(f"dispatcher {op} ragged rows of {width} != numpy")
                for g, w in zip(d.run_rows_vs_one(op, rows, b), want):
                    if not np.array_equal(g, w):
                        raise AssertionError(f"dispatcher {op} rows of {width} != numpy")
            pairs = [(straddle(20000), straddle(15000)) for _ in range(3)]
            pairs += [(straddle(200), straddle(3000)) for _ in range(3)]
            for (a, b), g in zip(pairs, d.run_pairs(op, pairs)):
                if not np.array_equal(g, np_op(a, b, assume_unique=True)):
                    raise AssertionError(f"dispatcher {op} pairs != numpy")
    return ("dispatcher over rows across 2^32 (ragged, list, pairs wide and of <= 128 a "
            "segment; intersect and difference): equal to numpy")


def setop_shapes_equal(by_shape):
    """setop_rows against its plain version, exactly, on the inputs of
    every shape a path gave each wrapper (a `_Capture` of SETOP_WRAPPERS).
    Returns {(wrapper, *shape): mismatches}."""
    return {key: measure_setop(key[0], args, timed=False)["mismatches"]
            for key, args in sorted(by_shape.items(), key=str)}


def setop_served(by_shape, log=print):
    """setop_rows against its plain version, exactly, on the inputs of
    every shape the main path gave each wrapper, and timed on the
    heaviest of each wrapper. Returns {wrapper: measurement}."""
    bad = {k: n for k, n in setop_shapes_equal(by_shape).items() if n}
    if bad:
        raise AssertionError(f"main-path setop_rows != plain at {bad}")
    out = {}
    for key, args in sorted(by_shape.items(), key=str):
        name = key[0]
        if name not in out or setop_bound_ms(name, args)[0] > setop_bound_ms(name, out[name][1])[0]:
            out[name] = (key, args)
    log(f"equal to plain at every shape it took: {sorted(by_shape, key=str)}")
    res = {}
    for name, (key, args) in out.items():
        res[name] = measure_setop(name, args)
        res[name]["shape"] = key[1:]
        if not res[name]["library_agrees"]:
            raise AssertionError(f"main-path {key}: library != plain")
        log(f"{name} at {key[1:]} (served): " + _fmt(res[name]))
    return res


def k1_route_against_setop_rows(A, LA, B, LB, reps=7):
    """The two routes of an intersect over rows of <= 128 on the card, on
    the same inputs: K1 and its compaction (member_sweep.intersect_batch,
    the dispatcher's route) and setop_rows' one fused kernel. They must be
    equal; returns the events and device ms of each, in ms."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep, setop_rows

    routes = {
        "k1_compact": (lambda: member_sweep.intersect_batch(A, LA, B, LB),
                       {"member_sweep_kernel": 1, **setop_rows.kernel_names()}),
        "setop_rows": (lambda: setop_rows.intersect_batch(A, LA, B, LB),
                       setop_rows.kernel_names()),
    }
    (o1, c1), (o2, c2) = (fn() for fn, _ in routes.values())
    torch.cuda.synchronize()
    if not (torch.equal(o1, o2) and torch.equal(c1, c2)):
        raise AssertionError(f"K1 and its compaction != setop_rows at {_shape_key((A, LA, B, LB))}")
    res = {"shape": _shape_key((A, LA, B, LB))}
    for key, (fn, names) in routes.items():
        res[key] = {"ms": _events_ms(fn, reps), "device_ms": kernel_device_ms(fn, name=names)}
    return res


# ---------------------------------------------------------------------------
# KV1 / KV2: the vector kernels against their plain versions
# ---------------------------------------------------------------------------

# f32 operations per element of the distance epilogue, by metric
_EPILOGUE_OPS = {"euclidean": 3, "cosine": 5, "dotproduct": 1, "distance": 0}


def _bound(nbytes, ops):
    """(ms, what bounds it): the larger of the bytes at the card's memory
    rate and the f32 operations at its f32 rate."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def topk_bound_ms(x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
    """KV1's least time: x read once, and each of sqnorm, valid, qstat and
    col_index once where the call gives it and the metric reads it (only
    euclidean and cosine read sqnorm and qstat), the (rows, k) distances
    and indices written once; and the epilogue's operations, one per
    element and op."""
    rows, w = x.shape
    n = w if col_index is None else col_index.shape[0]
    nbytes = 4 * rows * w + 8 * rows * k
    stats = metric in ("euclidean", "cosine")
    for t, read in ((sqnorm, stats), (qstat, stats), (valid, True), (col_index, True)):
        if t is not None and read:
            nbytes += t.numel() * t.element_size()
    return _bound(nbytes, rows * n * _EPILOGUE_OPS[metric])


def slab_bound_ms(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric):
    """KV2's least time: each probed slab's live rows (flat_rows >= 0) read
    once with their norm and id, the ids of the padding rows, the queries
    and sidx read once, the distances written once; a multiply and an add
    per element of each live row's dot, plus the epilogue."""
    nq, M = sidx.shape
    d = flat_vecs.shape[2]
    live = int((flat_rows[sidx.long()] >= 0).sum())
    slots = nq * M * flat_vecs.shape[1]
    nbytes = live * (4 * d + 4) + 4 * slots + 4 * nq * (d + 1 + M) + 4 * slots
    return _bound(nbytes, live * (2 * d + _EPILOGUE_OPS[metric]))


def library_topk(x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
    """The yardstick of KV1: torch.topk on the distances (computed once,
    outside the timed call). Timed here, called nowhere in the port."""
    import torch

    from dgraph_tpu_torch.ops import vector_topk

    if col_index is not None:
        x, sqnorm = x[:, col_index.long()], sqnorm[col_index.long()]
    d = vector_topk.epilogue_plain(x, sqnorm, qstat, metric)
    if valid is not None:
        d = d.masked_fill(~valid[None, :], float("inf"))
    d = d.contiguous()
    return lambda: torch.topk(d, k, dim=1, largest=False)


def library_slabs(flat_vecs, flat_sq, flat_rows, sidx, Q, qstat, metric):
    """The yardstick of KV2: the gather flat_vecs[sidx] and one torch.bmm
    with the queries (the dots alone). Timed here, called nowhere in the
    port."""
    import torch

    nq, M = sidx.shape
    s = sidx.long()

    def run():
        sub = flat_vecs[s].reshape(nq, M * flat_vecs.shape[1], -1)
        return torch.bmm(sub, Q[:, :, None])

    return run


def measure_topk(args, reps=7):
    """KV1 vs plain (bitwise: distances and indices, on two calls back
    to back), with the kernel, device, plain and library times and the
    bound. `args`: the keyword arguments of vector_topk.topk."""
    import torch

    from dgraph_tpu_torch.ops import vector_topk

    def kernel():
        return vector_topk.topk(**args)

    # two calls back to back, nothing between them: the kernel's state
    # (tickets, histograms) must come back to zero by itself
    got = kernel()
    again = kernel()
    want = vector_topk.topk_plain(**args)
    torch.cuda.synchronize()
    idx_bad = int((got[1] != want[1]).sum()) + int((again[1] != want[1]).sum())
    d_bad = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum()) + int(
        (again[0].view(torch.int32) != want[0].view(torch.int32)).sum())
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max()) if bool(fin.any()) else 0.0
    bound, bound_by = topk_bound_ms(**args)
    return {
        "mismatches": idx_bad + d_bad,
        "max_abs_err": err,
        "ms": _events_ms(kernel, reps),
        "device_ms": kernel_device_ms(kernel, name=vector_topk.launch_counts(
            args["x"].shape[0],
            args["x"].shape[1] if args.get("col_index") is None else args["col_index"].shape[0],
            args["k"])),
        "device_trace": dict(LAST_TRACE),
        "plain_ms": _events_ms(lambda: vector_topk.topk_plain(**args), max(3, reps // 2)),
        "library_ms": _events_ms(library_topk(**args), reps),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def measure_slabs(args, reps=7):
    """KV2 vs plain within ivf_scan.tolerance (padding rows +inf in
    both), with the kernel, device, plain and library times and the
    bound. `args`: the positional arguments of ivf_scan.slab_distances."""
    import torch

    from dgraph_tpu_torch.ops import ivf_scan

    def kernel():
        return ivf_scan.slab_distances(*args)

    got = kernel()
    want = ivf_scan.slab_distances_plain(*args)
    torch.cuda.synchronize()
    flat_vecs, flat_sq, flat_rows, sidx, Q, _, metric = args
    nq = sidx.shape[0]
    pad = flat_rows[sidx.long()].reshape(nq, -1) < 0
    tol = ivf_scan.tolerance(flat_sq[sidx.long()].reshape(nq, -1), Q, metric)
    diff = (got - want).abs()
    bad = int((diff[~pad] > tol[~pad]).sum()) + int((~torch.isinf(got[pad])).sum())
    bound, bound_by = slab_bound_ms(*args)
    return {
        "mismatches": bad,
        "max_abs_err": float(diff[~pad].max()) if bool((~pad).any()) else 0.0,
        "ms": _events_ms(kernel, reps),
        "device_ms": kernel_device_ms(kernel, name="slab_scan_kernel"),
        "device_trace": dict(LAST_TRACE),
        "plain_ms": _events_ms(lambda: ivf_scan.slab_distances_plain(*args), 3),
        "library_ms": _events_ms(library_slabs(*args), reps),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _fmt(r):
    tr = r["device_trace"]
    return (f"kernel {r['ms']:.6f} (device {r['device_ms']:.6f}, trace {tr['traces']} of "
            f"{tr['calls']} calls) plain {r['plain_ms']:.6f} "
            f"library {r['library_ms']:.6f} bound {r['bound_ms']:.6f} ({r['bound_by']}); "
            f"max abs err {r['max_abs_err']:.3g}")


def topk_case(rows, n, k, metric, kind="gauss", d=64, seed=0, cells=None):
    """KV1 inputs on the card: dot rows of `rows` queries against n
    vectors of width d ("gauss", "dup": 64 distinct vectors repeated,
    "const": one vector, "special": gauss with 30% of the ready distances
    replaced by NaN, +-inf, -0.0 and 0.0), a 3% invalid mask; metric
    "distance" takes the euclidean distances themselves. `cells`: the n
    columns gather from that many (the centroid step), no mask."""
    import torch

    from dgraph_tpu_torch.ops import vector_topk

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = cells or n
    V = torch.randn((w, d), generator=g, device="cuda")
    if kind == "dup":
        V = V[:64][torch.randint(0, 64, (w,), generator=g, device="cuda")]
    elif kind == "const":
        V = V[:1].expand(w, d).contiguous()
    Q = torch.randn((rows, d), generator=g, device="cuda")
    x = vector_topk.f32_matmul(Q, V.T).contiguous()
    sq = (V * V).sum(1)
    m = "euclidean" if metric == "distance" else metric
    qs = vector_topk.query_stat(Q, m)
    if cells:
        col = torch.sort(torch.randint(0, cells, (n,), generator=g, device="cuda")).values
        return {"x": x, "k": k, "metric": m, "sqnorm": sq, "qstat": qs,
                "col_index": col.to(torch.int32)}
    valid = torch.rand((w,), generator=g, device="cuda") >= 0.03
    if metric == "distance":
        x = vector_topk.epilogue_plain(x, sq, qs, m).masked_fill(~valid[None, :], float("inf"))
        if kind == "special":
            vals = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0],
                                device="cuda")
            pick = torch.randint(0, 5, x.shape, generator=g, device="cuda")
            x = torch.where(torch.rand(x.shape, generator=g, device="cuda") < 0.3, vals[pick], x)
        return {"x": x.contiguous(), "k": k, "metric": "distance"}
    return {"x": x, "k": k, "metric": metric, "sqnorm": sq, "valid": valid, "qstat": qs}


def slab_case(nq, M, d, metric, n_slabs=4096, seed=0):
    """KV2 inputs on the card: n_slabs slabs of 128 rows with ragged tails
    (rows past a random length are padding), M distinct slabs per query."""
    import torch

    from dgraph_tpu_torch.ops import vector_topk

    g = torch.Generator(device="cuda").manual_seed(seed)
    fv = torch.randn((n_slabs, 128, d), generator=g, device="cuda")
    lens = torch.randint(1, 129, (n_slabs,), generator=g, device="cuda")
    pad = torch.arange(128, device="cuda")[None, :] >= lens[:, None]
    fv[pad] = 0.0
    rows = torch.where(pad, -1, torch.arange(n_slabs * 128, device="cuda").reshape(n_slabs, 128))
    sidx = torch.stack([torch.randperm(n_slabs, generator=g, device="cuda")[:M]
                        for _ in range(nq)]).to(torch.int32)
    Q = torch.randn((nq, d), generator=g, device="cuda")
    return (fv, (fv * fv).sum(2), rows.to(torch.int32), sidx, Q,
            vector_topk.query_stat(Q, metric), metric)


def onepass_limit(rows, n):
    """The largest k that KV1 takes in one pass on rows x n (its switch is
    monotone in k), or 0."""
    from dgraph_tpu_torch.ops import vector_topk

    lo, hi = 0, min(n, vector_topk.onepass_max_k())
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if vector_topk.onepass(rows, n, mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def vector_grid():
    """Phase 6: KV1 == plain bitwise and KV2 == plain within tolerance
    over a grid, with times and bounds."""
    from dgraph_tpu_torch.ops import vector_topk

    topk_shapes = [  # (rows, n, k, metric, kind, cells)
        (64, 1 << 20, 10, "euclidean", "gauss", None),   # batched brute
        (1, 1 << 17, 10, "euclidean", "gauss", None),    # one brute query
        (1, 1 << 20, 10, "cosine", "dup", None),         # one row, many CTAs
        (4, 1 << 20, 80, "dotproduct", "dup", None),
        (8, 1 << 20, 10, "euclidean", "const", None),    # all keys tie
        (8, 1 << 20, 2049, "euclidean", "const", None),
        (1, 18000, 527, "euclidean", "gauss", 2000),     # centroid step
        (1, 67456, 80, "distance", "gauss", None),       # IVF final top-k
        (4, 1 << 20, 10, "distance", "special", None),   # NaN, +-inf, -0.0
        (4, 1 << 20, 2049, "distance", "special", None),
        (4096, 1024, 80, "euclidean", "gauss", None),
        (65535, 64, 10, "euclidean", "gauss", None),     # the most rows
    ]
    for rows, n in ((1, 1 << 17), (1, 1 << 20), (16, 1 << 20), (64, 1 << 20)):
        k = onepass_limit(rows, n)  # the one-pass limit and one above it
        topk_shapes += [(rows, n, k, "euclidean", "gauss", None),
                        (rows, n, k + 1, "euclidean", "gauss", None)]
    topk_shapes += [
        (16, 1 << 20, 16384, "euclidean", "gauss", None),
        (16, 1 << 20, 16385, "euclidean", "gauss", None),
        (1, 1 << 20, 1 << 20, "euclidean", "dup", None),      # k = n
    ]
    for rows, n, k, metric, kind, cells in topk_shapes:
        args = topk_case(rows, n, k, metric, kind, seed=rows + n + k, cells=cells)
        r = measure_topk(args)
        if r["mismatches"]:
            raise AssertionError(f"KV1 rows={rows} n={n} k={k} {metric} {kind}: {r}")
        regime = "one pass" if vector_topk.onepass(rows, n, k) else "radix"
        print(f"    KV1 rows={rows} n={n} k={k} {metric} {kind}"
              f"{' cells=' + str(cells) if cells else ''} ({regime}): equal twice; {_fmt(r)}",
              flush=True)
        del args
    for nq, M, d, metric in [(1, 527, 768, "euclidean"), (8, 527, 768, "euclidean"),
                             (1, 527, 768, "cosine"), (4, 64, 96, "dotproduct")]:
        args = slab_case(nq, M, d, metric, seed=nq + M + d)
        r = measure_slabs(args)
        if r["mismatches"]:
            raise AssertionError(f"KV2 nq={nq} M={M} d={d} {metric}: {r}")
        print(f"    KV2 nq={nq} M={M} d={d} {metric}: within tolerance; {_fmt(r)}", flush=True)
        del args


# ---------------------------------------------------------------------------
# The vector main path
# ---------------------------------------------------------------------------

VECTOR_SCHEMA = ('emb: float32vector @index(hnsw(metric:"euclidean")) .\n'
                 'emb_small: float32vector @index(hnsw(metric:"euclidean")) .\n'
                 "name: string @index(exact) .")


def make_corpus(n=1_000_000, d=768, nq=256, seed=1):
    """benchmarks/bench_suite.py's vector corpus, rewritten: a mixture of
    256 gaussians (centers scaled by 4, unit noise) from
    `np.random.default_rng(seed)`, and nq queries drawn near the centers."""
    rng = np.random.default_rng(seed)
    n_clusters = 256
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, n)
    V = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    Qs = (centers[rng.integers(0, n_clusters, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
    return V, Qs


def _vec_text(v) -> str:
    """A vector as the RDF literal: each float32 printed as the shortest
    decimal of its double, which parses back to the same float32."""
    return "[" + ", ".join(map(repr, v.tolist())) + "]"


def exact_topk(V, Q, k, chunk=65536):
    """Squared euclidean top-k of each query over V, in float64 numpy:
    (ids (nq, k) ascending by distance then id, distances (nq, k))."""
    Q64 = Q.astype(np.float64)
    qsq = (Q64 * Q64).sum(1)
    best_d = np.full((len(Q), 0), np.inf)
    best_i = np.zeros((len(Q), 0), np.int64)
    for s in range(0, len(V), chunk):
        Vc = V[s : s + chunk].astype(np.float64)
        d = (Vc * Vc).sum(1)[None, :] - 2.0 * (Q64 @ Vc.T) + qsq[:, None]
        d = np.concatenate([best_d, d], 1)
        ids = np.concatenate([best_i, np.broadcast_to(np.arange(s, s + len(Vc)), (len(Q), len(Vc)))], 1)
        part = np.argpartition(d, min(k, d.shape[1] - 1), axis=1)[:, :k]
        best_d = np.take_along_axis(d, part, 1)
        best_i = np.take_along_axis(ids, part, 1)
    order = np.stack([np.lexsort((i, d)) for i, d in zip(best_i, best_d)])
    return np.take_along_axis(best_i, order, 1), np.take_along_axis(best_d, order, 1)


def near_equal(V, Q, got_rows, want_d, rtol=1e-5):
    """Per query: do the rows a path returned have, in float64, the exact
    top-k distances, to rtol of the distance's terms (|v|^2 + 2|v||q| +
    |q|^2)? Rows may differ only at near-ties. Returns (all equal within
    tolerance, count of queries whose rows equal the exact ids)."""
    ok = True
    for i in range(len(Q)):
        r = np.asarray(got_rows[i], np.int64)
        v = V[r].astype(np.float64)
        q = Q[i].astype(np.float64)
        d = np.sort(((v - q) ** 2).sum(1))
        vn = np.sqrt((V[r].astype(np.float64) ** 2).sum(1)).max()
        qn = np.sqrt((q * q).sum())
        tol = rtol * (vn * vn + 2 * vn * qn + qn * qn)
        if len(d) != len(want_d[i]) or np.abs(d - want_d[i]).max() > tol:
            ok = False
    return ok


def cpu_twin(idx):
    """The same index state on the host: a shallow copy whose torch
    tensors are moved to the CPU, so its searches take the plain versions
    of the kernels on exactly the data the card holds."""
    import copy
    import threading

    import torch

    t = copy.copy(idx)
    t.device = torch.device("cpu")
    t._lock = threading.RLock()
    t._device = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in idx._device.items()}
    if idx._ivf is not None:
        t._ivf = dict(idx._ivf, dev={k: v.cpu() for k, v in idx._ivf["dev"].items()})
    return t


class _VecCapture:
    """Keeps, per call shape, the first inputs the main path hands the KV1
    and KV2 wrappers (references: the tensors are not written after), and
    delegates every call unchanged."""

    def __init__(self):
        from dgraph_tpu_torch.ops import ivf_scan, vector_topk

        self.mods = (vector_topk, ivf_scan)
        self.real = (vector_topk.topk, ivf_scan.slab_distances)
        self.topk, self.slabs = {}, {}

    def _topk(self, x, k, metric, sqnorm=None, valid=None, qstat=None, col_index=None):
        key = (tuple(x.shape), k, metric, col_index is not None)
        self.topk.setdefault(key, dict(x=x, k=k, metric=metric, sqnorm=sqnorm,
                                       valid=valid, qstat=qstat, col_index=col_index))
        return self.real[0](x, k, metric, sqnorm, valid, qstat, col_index)

    def _slabs(self, *args):
        self.slabs.setdefault(tuple(args[3].shape), args)
        return self.real[1](*args)

    def __enter__(self):
        self.mods[0].topk, self.mods[1].slab_distances = self._topk, self._slabs
        return self

    def __exit__(self, *exc):
        self.mods[0].topk, self.mods[1].slab_distances = self.real


def load_vectors(device="cuda", n=1_000_000, d=768, n_named=10_000, n_small=100_000,
                 ivf_threshold=None, log=print):
    """Phase 7's corpus in a port Server on `device`: all n rows into
    `emb`'s index, the first n - n_named bulk-loaded into the index alone
    and the last n_named committed as RDF with a `name` (so only those
    are in the store too), and the first n_small into `emb_small`'s index
    alone. Returns (server, V, Qs, the load's seconds)."""
    from dgraph_tpu_torch.api.server import Server

    t0 = time.perf_counter()
    V, Qs = make_corpus(n, d)
    log(f"corpus: {n} x {d} float32 (256 gaussians, default_rng(1)) and {len(Qs)} queries "
        f"made in {time.perf_counter() - t0:.3f}s")
    server = Server(device=device)
    server.slow_query_ms = float("inf")
    server.alter(VECTOR_SCHEMA)
    emb, small = server.vector_indexes["emb"], server.vector_indexes["emb_small"]
    if ivf_threshold is not None:
        emb.ivf_threshold = small.ivf_threshold = ivf_threshold
    uids = np.arange(1, n + 1, dtype=np.uint64)
    t0 = time.perf_counter()
    emb.bulk_load(uids[: n - n_named], V[: n - n_named])
    small.bulk_load(uids[:n_small], V[:n_small])
    for s in range(n - n_named, n, 1000):
        lines = []
        for i in range(s, min(s + 1000, n)):
            lines.append(f'<{hex(i + 1)}> <name> "v{i + 1}" .')
            lines.append(f'<{hex(i + 1)}> <emb> "{_vec_text(V[i])}"^^<float32vector> .')
        server.new_txn().mutate_rdf(set_rdf="\n".join(lines), commit_now=True)
    load_s = time.perf_counter() - t0
    if len(emb) != n or len(small) != n_small:
        raise AssertionError(f"index sizes {len(emb)}, {len(small)}")
    log(f"loaded in {load_s:.3f}s: {n - n_named} bulk + {n_named} committed as RDF "
        f"into emb, {n_small} into emb_small")
    return server, V, Qs, load_s


def serve_vectors(device="cuda", n=1_000_000, d=768, n_named=10_000, n_small=100_000,
                  nq=64, k=10, reps=3, min_recall=0.90, ivf_threshold=None,
                  n_allow=20, log=print, profile=(), keep=False):
    """Phase 7: load the corpus into a port Server on `device`, serve the
    five vector reads, check them (exact top-k, recall, the CPU float
    path, the kernels' launches) and time them. Returns the measurements,
    the kernel counts of the counted run and the captured kernel inputs,
    and with `keep` the server (phase 9 serves it again).
    `ivf_threshold` overrides the index's (a rehearsal at a small n).
    Read (i) filters `emb_small` to the `n_allow` uids farthest from the
    query, so its pool widens 4x a step up to the whole live set."""
    import os

    import torch

    from dgraph_tpu_torch.ops import ivf_scan, vector_topk

    on_card = torch.device(device).type == "cuda"
    server, V, Qs, load_s = load_vectors(device, n, d, n_named, n_small, ivf_threshold, log=log)
    Q = Qs[:nq]
    emb, small = server.vector_indexes["emb"], server.vector_indexes["emb_small"]

    qtext = [_vec_text(q) for q in Q[:4]]
    # (i): the allow-list lies far from query 0, so no pool short of the
    # live set holds k of it
    d_small = ((V[:n_small].astype(np.float64) - Q[0].astype(np.float64)) ** 2).sum(1)
    allow = np.sort(np.argsort(d_small, kind="stable")[-n_allow:] + 1).astype(np.uint64)
    allow_q = (f'{{ q(func: uid({", ".join(hex(int(u)) for u in allow)})) '
               f'@filter(similar_to(emb_small, {k}, "{qtext[0]}")) {{ uid }} }}')
    reads = {
        "e": lambda i: f'{{ q(func: similar_to(emb, {k}, "{qtext[i]}")) {{ uid }} }}',
        "f": lambda i: f'{{ q(func: similar_to(emb, {k}, "{qtext[i]}", ef: 64)) {{ uid }} }}',
        "g": lambda i: f'{{ q(func: similar_to(emb_small, {k}, "{qtext[i]}")) {{ uid name }} }}',
        "i": lambda i: allow_q,  # query 0 only
    }

    def uids_of(raw):
        return sorted(int(o["uid"], 16) for o in json.loads(raw)["q"])

    out = {"load_s": load_s, "queries": {}}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the counted run: each read once, the counts zeroed just before
    vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
    ivf_scan.LAUNCHES = ivf_scan.PLAIN_CALLS = 0
    answers = {}
    per_read = {}

    def calls():
        return vector_topk.LAUNCHES + vector_topk.PLAIN_CALLS

    t0 = time.perf_counter()
    with _VecCapture() as cap:
        for name, q in reads.items():
            c0 = calls()
            answers[name] = _run_query(server, q(0))
            per_read[name] = calls() - c0
        c0 = calls()
        answers["h"] = emb.search_batch(Q, k)
        per_read["h"] = calls() - c0
    out["first_s"] = time.perf_counter() - t0
    out["topk_per_read"] = per_read
    out["launches"] = {"vector_topk": vector_topk.LAUNCHES, "ivf_slab_scan": ivf_scan.LAUNCHES}
    out["plain_calls"] = {"vector_topk": vector_topk.PLAIN_CALLS,
                          "ivf_slab_scan": ivf_scan.PLAIN_CALLS}
    out["captured"] = (cap.topk, cap.slabs)
    # (i) widened k = 4 * 10, 160, ... up to the live set: one KV1 call
    # a step, on one row of emb_small's padded rows
    small_ks = sorted(kk for (shape, kk, metric, gathered) in cap.topk
                      if shape[0] == 1 and metric != "distance" and not gathered
                      and kk >= 4 * k)
    out["filtered_ks"] = small_ks
    if not small_ks or small_ks[-1] != n_small or per_read["i"] != len(small_ks):
        raise AssertionError(f"read (i) did not widen to the live set: k {small_ks}, "
                             f"{per_read['i']} top-k calls")
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if emb._ivf is None or small._ivf is not None:
        raise AssertionError("emb must hold the IVF tier and emb_small the brute tier")
    out["ivf"] = {key: emb._ivf[key] for key in ("m_slabs", "n_slabs")}
    out["ivf"]["nlist"] = len(emb._ivf["centroids"])
    log(f"first run (index upload and IVF build included) {out['first_s']:.3f}s; "
        f"IVF {out['ivf']}")

    # brute answers against an exact numpy top-k
    t0 = time.perf_counter()
    ex_i, ex_d = exact_topk(V, Q, k)
    rows_h = [np.asarray(u, np.int64) - 1 for u in answers["h"]]
    if not near_equal(V, Q, rows_h, ex_d):
        raise AssertionError("search_batch (brute) != exact top-k beyond near-ties")
    out["batch_exact_ids"] = int(sum(np.array_equal(r, e) for r, e in zip(rows_h, ex_i)))
    sm_i, sm_d = exact_topk(V[:n_small], Q[:4], k)
    for i in range(4):
        got = uids_of(_run_query(server, reads["g"](i)))
        if not near_equal(V, Q[i : i + 1], [np.asarray(got) - 1], sm_d[i : i + 1]):
            raise AssertionError(f"emb_small query {i} != exact top-k beyond near-ties")
    # IVF recall@10 over the nq queries, on the path plain similar_to takes
    ivf_rows = [np.asarray(emb.search_one(q, k), np.int64) - 1 for q in Q]
    recall = float(np.mean([len(set(r) & set(e)) / k for r, e in zip(ivf_rows, ex_i)]))
    out["recall"] = recall
    if recall < min_recall:
        raise AssertionError(f"IVF recall@{k} {recall} < {min_recall}")
    for name in ("e", "f"):
        got = uids_of(answers[name])
        want = sorted(int(u) for u in (emb.search_one(Q[0], k) if name == "e"
                                       else emb.search(Q[0], k, ef=64)))
        if got != want:
            raise AssertionError(f"query ({name}): DQL answer != the index's own")
    # (i): the exact top-k over the allowed set
    got_i = uids_of(answers["i"])
    order = np.argsort(d_small[allow.astype(np.int64) - 1], kind="stable")[:k]
    want_d = np.sort(d_small[allow.astype(np.int64) - 1])[:k]
    if len(got_i) != k or not set(got_i) <= set(allow.tolist()) or not near_equal(
            V, Q[:1], [np.asarray(got_i, np.int64) - 1], want_d[None, :]):
        raise AssertionError(f"query (i) {got_i} != exact top-{k} of the allowed set "
                             f"{sorted(allow[order].tolist())}")
    log(f"checks against numpy exact top-k (float64) in {time.perf_counter() - t0:.3f}s: "
        f"brute equal outside near-ties ({out['batch_exact_ids']}/{nq} id lists identical), "
        f"IVF recall@{k} {recall:.4f}; (i) equals the exact top-{k} of its {n_allow} "
        f"allowed uids after KV1 at k {small_ks}")

    # the card against the same index's CPU float path
    if on_card:
        t0 = time.perf_counter()
        saved = os.environ.get("DGRAPH_TPU_VEC_QUANT")
        os.environ["DGRAPH_TPU_VEC_QUANT"] = "0"
        try:
            twin, twin_small = cpu_twin(emb), cpu_twin(small)
            same = {"batch": 0, "ivf": 0, "ef": 0, "small": 0, "filtered": 0}
            apart = []  # (path, query) whose ids differ beyond a near-tie
            host_b = twin.search_batch(Q, k)
            same["batch"] = int((host_b == answers["h"]).all(1).sum())
            host_rows = [np.asarray(u, np.int64) - 1 for u in host_b]
            if not near_equal(V, Q, host_rows, ex_d):
                apart.append(("batch", "all"))

            def agree(path, i, a, b, Vs=V):
                # equal ids, or ids whose exact distances differ only
                # within the f32 tolerance (a near-tie the two GEMMs'
                # summation orders resolve differently)
                same[path] += int(np.array_equal(a, b))
                ra, rb = np.asarray(a, np.int64) - 1, np.asarray(b, np.int64) - 1
                db = np.sort(((Vs[rb] - Q[i]).astype(np.float64) ** 2).sum(1))
                if not near_equal(Vs, Q[i : i + 1], [ra], db[None, :]):
                    apart.append((path, i))

            for i in range(8):
                agree("ivf", i, twin.search_one(Q[i], k), emb.search_one(Q[i], k))
                agree("ef", i, twin.search(Q[i], k, ef=64), emb.search(Q[i], k, ef=64))
            for i in range(4):
                agree("small", i, twin_small.search_one(Q[i], k), small.search_one(Q[i], k))
            agree("filtered", 0, twin_small.search(Q[0], k, allowed=allow),
                  small.search(Q[0], k, allowed=allow))
            del twin, twin_small
        finally:
            if saved is None:
                os.environ.pop("DGRAPH_TPU_VEC_QUANT", None)
            else:
                os.environ["DGRAPH_TPU_VEC_QUANT"] = saved
        out["cpu_same"] = same
        if apart:
            raise AssertionError(f"card != CPU float path beyond near-ties: {apart}; "
                                 f"identical id lists {same}")
        log(f"card == CPU float path of the same index (plain kernels on the host) "
            f"outside near-ties; identical id lists {same} of (64, 8, 8, 4, 1), "
            f"in {time.perf_counter() - t0:.3f}s")

    # warm medians
    runs = {name: (lambda q=q: _run_query(server, q(0))) for name, q in reads.items()}
    runs["h"] = lambda: emb.search_batch(Q, k)
    for name, run in runs.items():
        ms = []
        for _ in range(reps):
            if on_card:
                torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            if on_card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out["queries"][name] = float(np.median(ms))
    for name in profile:
        log(f"profile of query ({name}):")
        profile_query(server, runs[name], log=lambda m: log("  " + m))
    out["small"] = (V[:n_small].copy(), Qs)  # phase 8 commits these rows
    if keep:
        # uid n has a name; phase 12 reuses the exact top-k of Q
        out["server"], out["named"], out["exact"] = server, n, (ex_i, ex_d)
        out["V"] = V  # phase 13 row-shards it over the mesh
    return out


def served_kernels(captured):
    """KV1 and KV2 on every input shape the served reads gave them:
    equal to the plain versions, with times. Returns {site: result}."""
    topk, slabs = captured
    res = {}
    for (shape, k, metric, gathered), args in topk.items():
        site = f"KV1 {shape[0]}x{shape[1]} k={k} {metric}{' gathered' if gathered else ''}"
        res[site] = measure_topk(args)
        if res[site]["mismatches"]:
            raise AssertionError(f"{site}: kernel != plain on the served inputs: {res[site]}")
    for shape, args in slabs.items():
        site = f"KV2 nq={shape[0]} M={shape[1]} d={args[0].shape[2]}"
        res[site] = measure_slabs(args)
        if res[site]["mismatches"]:
            raise AssertionError(f"{site}: kernel beyond tolerance on the served inputs")
    return res


# ---------------------------------------------------------------------------
# The write path
# ---------------------------------------------------------------------------

WRITE_SCHEMA = ("child: [uid] .\ntag: string @index(exact) .\n"
                "email: string @index(exact) @upsert .\nhot_seen: bool .\n"
                "acct: string @index(exact) @upsert .\nbal: int @upsert .")
SMALL_SCHEMA = 'emb_small: float32vector @index(hnsw(metric:"euclidean")) .'
# (u1), the Upsert Block example of Dgraph's docs
EMAIL_UPSERT = ('{{ v as var(func: eq(email, "{0}")) }}', '_:n <email> "{0}" .',
                "@if(eq(len(v), 0))")
# (u2): query (b)'s filtered level 3 as an upsert's query block
HOT_UPSERT = ('{ var(func: uid(0x1)) { child { child { h as child @filter('
              'eq(tag, "hot")) } } } }', 'uid(h) <hot_seen> "true"^^<xs:boolean> .')
BANK_START = 100
# what a restart must answer byte for byte as before it
STATE_READS = {
    "emails": "{ q(func: has(email)) { uid email } }",
    "hot_seen": "{ q(func: has(hot_seen)) { uid } }",
    "balances": "{ q(func: has(bal)) { uid acct bal } }",
}


def json_chunks(g, chunk=50_000):
    """The fan-out graph as JSON mutation objects, in commits of about
    `chunk` edges: the edges level by level, then one tag per pool node.
    Yields (objects, edges)."""
    f = g["f"]

    def node(u, targets):
        return {"uid": hex(int(u)), "child": [{"uid": hex(int(t))} for t in targets]}

    top = [node(1, g["l1"])] + [node(g["l1"][i], g["l2"][i * f : (i + 1) * f])
                                for i in range(f)]
    yield top, f + f * f
    per = max(1, chunk // f)
    for s in range(0, len(g["l2"]), per):
        e = min(s + per, len(g["l2"]))
        yield [node(g["l2"][i], g["l3"][i * f : (i + 1) * f]) for i in range(s, e)], (e - s) * f
    hot = set(g["hot"].tolist())
    for s in range(0, len(g["pool"]), chunk):
        part = g["pool"][s : s + chunk].tolist()
        yield [{"uid": hex(u), "tag": "hot" if u in hot else "cold"} for u in part], len(part)


def lease_through(zero, top):
    """Lease every uid up to `top` from Zero, as a client does before it
    writes explicit uids, so that blank nodes get uids of their own."""
    first = zero.assign_uids(1)
    if top > first:
        zero.assign_uids(top - first)


def _threads(work, args):
    """Run work(*a) for each a in args on its own thread; re-raise the
    first error any of them met."""
    import threading

    errors = []

    def run(a):
        try:
            work(*a)
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            errors.append(e)

    ts = [threading.Thread(target=run, args=(a,)) for a in args]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=3600)
        if t.is_alive():
            raise AssertionError("a client thread did not finish")
    if errors:
        raise errors[0]


def _conflict():
    from dgraph_tpu_torch.zero.zero import TxnConflictError

    return TxnConflictError


def upsert_emails(server, pool, n_emails=2000, n_pre=1000, threads=8, per_thread=500,
                  seed=11, conflict=None):
    """(u1): `n_pre` emails set on pool nodes, then `threads` clients run
    `per_thread` email upserts each, keys drawn with repeats (every email
    at least once), retrying on `conflict` (the server's conflict error).
    Checks that every email has one uid, the pre-set ones their pool
    node, and that exactly the others are new. Returns the measurements
    and the email -> uid map."""
    conflict = conflict or _conflict()
    rng = np.random.default_rng(seed)
    emails = [f"user{i}@example.com" for i in range(n_emails)]
    pre = rng.choice(pool, n_pre, replace=False)
    server.new_txn().mutate_json(
        set_obj=[{"uid": hex(int(u)), "email": emails[i]} for i, u in enumerate(pre)],
        commit_now=True)
    draws = np.concatenate([np.arange(n_emails),
                            rng.integers(0, n_emails, threads * per_thread - n_emails)])
    rng.shuffle(draws)
    lat = [[] for _ in range(threads)]
    aborts = [0] * threads

    def client(i):
        for key in draws[i::threads]:
            q, m, c = (s.format(emails[key]) for s in EMAIL_UPSERT)
            t0 = time.perf_counter()
            while True:
                try:
                    server.new_txn().upsert(query=q, set_rdf=m, cond=c)
                    break
                except conflict:
                    aborts[i] += 1
            lat[i].append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    _threads(client, [(i,) for i in range(threads)])
    wall = time.perf_counter() - t0
    got = json.loads(_run_query(server, STATE_READS["emails"]))["q"]
    owner = {}
    for o in got:
        owner.setdefault(o["email"], []).append(int(o["uid"], 16))
    if sorted(owner) != sorted(emails) or any(len(v) != 1 for v in owner.values()):
        dup = {k: v for k, v in owner.items() if len(v) != 1}
        raise AssertionError(f"(u1): {len(owner)} emails, not one uid each: {list(dup.items())[:5]}")
    if any(owner[emails[i]] != [int(u)] for i, u in enumerate(pre)):
        raise AssertionError("(u1): a pre-set email lost its pool node")
    new = {owner[e][0] for e in emails[n_pre:]}
    if len(new) != n_emails - n_pre or new & set(int(u) for u in pool):
        raise AssertionError(f"(u1): {len(new)} new nodes, not {n_emails - n_pre}")
    ms = np.concatenate([np.asarray(v) for v in lat]) * 1e3
    return {"upserts": len(draws), "wall_s": wall, "per_s": len(draws) / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "aborts": sum(aborts)}, {e: v[0] for e, v in owner.items()}


def upsert_hot(server, g, count):
    """(u2): the fan-out upsert. Marks every hot level-3 node of query (b)
    through uid(h); checks has(hot_seen) against numpy. Returns the
    setop_rows calls `count()` saw during the upsert."""
    c0 = count()
    t0 = time.perf_counter()
    server.new_txn().upsert(query=HOT_UPSERT[0], set_rdf=HOT_UPSERT[1])
    took = time.perf_counter() - t0
    setops = count() - c0
    want = sorted({u for row in expected(g, "b").values() for u in row})
    got = sorted(int(o["uid"], 16)
                 for o in json.loads(_run_query(server, STATE_READS["hot_seen"]))["q"])
    if got != want:
        raise AssertionError(f"(u2): has(hot_seen) holds {len(got)} uids, numpy {len(want)}")
    return {"s": took, "setops": setops, "marked": len(got)}


def bank(server, n=1000, threads=8, per_thread=250, seed=13, conflict=None):
    """(u3), systest/bank in JSON: `n` accounts of BANK_START, then
    `threads` clients run `per_thread` transfers each (read both balances
    in the txn, mutate_json, commit; retried on `conflict`) while a
    reader checks the total at every snapshot it reads. Checks the total
    and that every committed transfer, and nothing else, moved money."""
    import threading

    conflict = conflict or _conflict()
    made = server.new_txn().mutate_json(
        set_obj=[{"uid": f"_:a{i}", "acct": f"a{i}", "bal": BANK_START} for i in range(n)],
        commit_now=True)
    accts = [int(made[f"a{i}"], 16) for i in range(n)]
    total = n * BANK_START
    done = [[] for _ in range(threads)]
    aborts = [0] * threads
    stop = threading.Event()
    seen = {"reads": 0, "bad": [], "errors": []}

    def transfer(frm, to, amount):
        t = server.new_txn()
        got = t.query(f"{{ a(func: uid({hex(frm)})) {{ bal }} "
                      f"b(func: uid({hex(to)})) {{ bal }} }}")["data"]
        a, b = got["a"][0]["bal"], got["b"][0]["bal"]
        if a < amount:
            t.discard()
            return False
        t.mutate_json(set_obj=[{"uid": hex(frm), "bal": a - amount},
                               {"uid": hex(to), "bal": b + amount}])
        t.commit()
        return True

    def client(i):
        r = np.random.default_rng(seed + i)
        for _ in range(per_thread):
            frm, to = (accts[j] for j in r.choice(n, 2, replace=False))
            amount = int(r.integers(1, 20))
            while True:
                try:
                    if transfer(frm, to, amount):
                        done[i].append((frm, to, amount))
                    break
                except conflict:
                    aborts[i] += 1

    every = f"{{ q(func: uid({', '.join(map(hex, accts))})) {{ bal }} }}"

    def reader():
        try:
            while not stop.is_set():
                bals = json.loads(_run_query(server, every))["q"]
                seen["reads"] += 1
                if sum(o["bal"] for o in bals) != total or len(bals) != n:
                    seen["bad"].append(sum(o["bal"] for o in bals))
                stop.wait(0.1)  # leave the clients most of the interpreter
        except BaseException as e:  # noqa: BLE001 - re-raised after the join
            seen["errors"].append(e)

    rd = threading.Thread(target=reader)
    rd.start()
    t0 = time.perf_counter()
    try:
        _threads(client, [(i,) for i in range(threads)])
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        rd.join(timeout=600)
    if rd.is_alive():
        raise AssertionError("(u3): the snapshot reader did not finish")
    if seen["errors"]:
        raise seen["errors"][0]
    if seen["bad"] or not seen["reads"]:
        raise AssertionError(f"(u3): {len(seen['bad'])} of {seen['reads']} snapshots off "
                             f"the total {total}: {seen['bad'][:5]}")
    want = dict.fromkeys(accts, BANK_START)
    for frm, to, amount in (x for d in done for x in d):
        want[frm] -= amount
        want[to] += amount
    got = {int(o["uid"], 16): o["bal"]
           for o in json.loads(_run_query(server, STATE_READS["balances"]))["q"]}
    if got != want:
        raise AssertionError("(u3): final balances != the committed transfers (a lost update)")
    ok, ab = sum(len(d) for d in done), sum(aborts)
    return {"transfers": ok, "declined": threads * per_thread - ok, "aborts": ab,
            "wall_s": wall, "per_s": ok / wall, "abort_share": ab / max(1, ok + ab),
            "snapshots": seen["reads"]}


@contextlib.contextmanager
def _timing(into, *sites):
    """Add the seconds each (owner, attribute) callable takes to
    into[attribute] while the block runs."""
    saved = []
    for owner, name in sites:
        real = getattr(owner, name)

        def timed(*a, _real=real, _name=name, **k):
            t = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                into[_name] = into.get(_name, 0.0) + time.perf_counter() - t

        saved.append((owner, name, real))
        setattr(owner, name, timed)
    try:
        yield into
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def disk_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def serve_writes(device, data_dir, V, Q, fanout=100, pool=200_000,
                 vec_chunk=1000, edge_chunk=50_000, n_emails=2000, n_pre=1000,
                 upsert_threads=8, upserts_per_thread=500, n_accounts=1000,
                 bank_threads=8, transfers_per_thread=250, n_reads=16, k=10, log=print):
    """Phase 8 on one store: a `Server(device, data_dir)` with group
    commit on (the default) and the device path forced loads the fan-out
    graph and the vectors V (n, d) through `mutate_json`, runs (u1)-(u3),
    then restarts from `data_dir` and must answer everything as before,
    the first `n_reads` queries of Q among it. The store is the one
    DGRAPH_TPU_STORAGE names. Returns the measurements; raises when a
    check fails."""
    import gc

    import torch

    from dgraph_tpu_torch.api import server as server_mod
    from dgraph_tpu_torch.ops import member_sweep, vector_topk
    from dgraph_tpu_torch.query import dispatch
    from dgraph_tpu_torch.utils.observe import METRICS

    on_card = torch.device(device).type == "cuda"

    def sweeps():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    def topks():
        return vector_topk.LAUNCHES if on_card else vector_topk.PLAIN_CALLS

    def setops():
        return setops_count(on_card)

    g = make_graph(fanout, pool)
    vec_base = int(g["pool"].max()) + 1
    saved = (dispatch._FORCE_DEVICE, dispatch._USE_PALLAS)
    dispatch._FORCE_DEVICE, dispatch._USE_PALLAS = True, True
    out = {}
    try:
        server = server_mod.Server(device=device, data_dir=data_dir)
        server.slow_query_ms = float("inf")
        lease_through(server.zero, vec_base + len(V))
        server.alter(WRITE_SCHEMA)
        t0 = time.perf_counter()
        edges = 0
        for objs, n in json_chunks(g, edge_chunk):
            server.new_txn().mutate_json(set_obj=objs, commit_now=True)
            edges += n
        out["load"] = {"edges": edges, "s": time.perf_counter() - t0}
        out["load"]["per_s"] = edges / out["load"]["s"]
        server.alter(SMALL_SCHEMA)
        t0 = time.perf_counter()
        for s in range(0, len(V), vec_chunk):
            server.new_txn().mutate_json(
                set_obj=[{"uid": hex(vec_base + i), "emb_small": V[i].tolist()}
                         for i in range(s, min(s + vec_chunk, len(V)))], commit_now=True)
        out["load"]["vectors"] = len(V)
        out["load"]["vectors_s"] = time.perf_counter() - t0
        if len(server.vector_indexes["emb_small"]) != len(V):
            raise AssertionError("emb_small does not hold every committed vector")
        log(f"loaded {edges} edges through mutate_json in {out['load']['s']:.3f}s "
            f"({out['load']['per_s']:.1f} edges/s), {len(V)} x {V.shape[1]} vectors in "
            f"{out['load']['vectors_s']:.3f}s")
        answers = {}
        for name, q in QUERIES.items():
            answers[name] = _run_query(server, q)
            want = expected(g, "a" if name == "a" else "b")
            if extract(name, json.loads(answers[name])) != want:
                raise AssertionError(f"query {name} after the JSON load != numpy reference")
        qtext = [_vec_text(q) for q in Q[:n_reads]]
        vec_q = [f'{{ q(func: similar_to(emb_small, {k}, "{t}")) {{ uid }} }}' for t in qtext]
        for i, q in enumerate(vec_q):
            answers[f"v{i}"] = _run_query(server, q)
        ex_i, ex_d = exact_topk(V, Q[:n_reads], k)
        rows = [np.asarray([int(o["uid"], 16) - vec_base for o in json.loads(answers[f"v{i}"])["q"]])
                for i in range(n_reads)]
        if not near_equal(V, Q[:n_reads], [np.sort(r) for r in rows], ex_d):
            raise AssertionError("similar_to(emb_small) != exact top-k beyond near-ties")

        gc0 = METRICS.hist_stats("group_commit_batch_size")
        by0 = METRICS.value("group_commit_bypass_total")
        out["u1"], owner = upsert_emails(server, g["pool"], n_emails, n_pre,
                                         upsert_threads, upserts_per_thread)
        log(f"(u1) {out['u1']['upserts']} email upserts from {upsert_threads} threads: "
            f"{out['u1']['per_s']:.1f}/s, p50 {out['u1']['p50_ms']:.3f} ms, p99 "
            f"{out['u1']['p99_ms']:.3f} ms, {out['u1']['aborts']} conflicts retried; "
            f"{n_emails} emails, one uid each, {n_emails - n_pre} new")
        out["u2"] = upsert_hot(server, g, setops)
        if out["u2"]["setops"] < 1:
            raise AssertionError("(u2): setop_rows did not launch during the upsert")
        log(f"(u2) fan-out upsert in {out['u2']['s']:.3f}s marked {out['u2']['marked']} "
            f"hot nodes (== numpy), setop_rows {out['u2']['setops']} launches")
        out["u3"] = bank(server, n_accounts, bank_threads, transfers_per_thread)
        log(f"(u3) bank: {out['u3']['transfers']} transfers from {bank_threads} threads, "
            f"{out['u3']['per_s']:.1f}/s, abort share {out['u3']['abort_share']:.4f}, "
            f"{out['u3']['declined']} declined; total held at all "
            f"{out['u3']['snapshots']} snapshots, no update lost")
        gc1 = METRICS.hist_stats("group_commit_batch_size")
        # coalesced batches only: an idle coalescer sends a commit down
        # the serial path (the adaptive bypass), counted apart
        out["batches"] = gc1[1] - gc0[1]
        out["batch_mean"] = (gc1[0] - gc0[0]) / max(1, out["batches"])
        out["bypassed"] = int(METRICS.value("group_commit_bypass_total") - by0)
        log(f"group commit over (u1)-(u3): {out['batches']} batches of mean "
            f"{out['batch_mean']:.3f} txns, {out['bypassed']} commits bypassed (idle)")
        for name, q in STATE_READS.items():
            answers[name] = _run_query(server, q)
        known_top = max(vec_base + len(V), max(owner.values()),
                        max(int(o["uid"], 16) for o in
                            json.loads(answers["balances"])["q"]))

        # the restart
        server.kv.sync()
        server.kv.close()
        out["disk_bytes"] = disk_bytes(data_dir)
        del server
        gc.collect()
        rec = {}
        t0 = time.perf_counter()
        with _timing(rec, (server_mod, "open_kv"), (server_mod.Server, "_load_persisted_state"),
                     (server_mod.Server, "rebuild_vector_indexes")):
            server = server_mod.Server(device=device, data_dir=data_dir)
        rec["total"] = time.perf_counter() - t0
        server.slow_query_ms = float("inf")
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
        setops0 = setops()
        # KV1's inputs in the counted similar_to reads, held against its
        # plain version once the counts are read
        with _VecCapture() as vec_cap:
            t0 = time.perf_counter()
            again = {"v0": _run_query(server, vec_q[0])}
            if on_card:
                torch.cuda.synchronize()
            rec["first_read"] = time.perf_counter() - t0
            for i, q in enumerate(vec_q[1:], 1):
                again[f"v{i}"] = _run_query(server, q)
        out["recover"] = rec
        log(f"restart: {rec['total']:.3f}s to a served store (open_kv "
            f"{rec['open_kv']:.3f}s, schema/leases "
            f"{rec['_load_persisted_state'] - rec['rebuild_vector_indexes']:.3f}s, "
            f"emb_small rebuilt {rec['rebuild_vector_indexes']:.3f}s), first similar_to "
            f"{rec['first_read']:.3f}s (the index's upload to the card); "
            f"{out['disk_bytes']} bytes on disk")
        per = {"similar_to": topks()}
        cold = {}
        for name, q in QUERIES.items():
            c0 = setops()
            t = time.perf_counter()
            again[name] = _run_query(server, q)
            cold[name] = (time.perf_counter() - t) * 1e3
            per[name] = setops() - c0
        for name, q in STATE_READS.items():
            again[name] = _run_query(server, q)
        out["after_restart_launches"] = {"member_sweep": sweeps(), "vector_topk": topks(),
                                         "setop_rows": setops() - setops0}
        if per["b"] < 1 or per["similar_to"] < n_reads:
            raise AssertionError(f"after the restart: setop_rows {per['b']} in (b), KV1 "
                                 f"{per['similar_to']} in {n_reads} similar_to reads")
        ties = []
        for name in answers:
            if again[name] == answers[name]:
                continue
            if not name.startswith("v"):
                raise AssertionError(f"after the restart, {name} answers differently")
            i = int(name[1:])
            got = np.sort([int(o["uid"], 16) - vec_base for o in json.loads(again[name])["q"]])
            if not near_equal(V, Q[i : i + 1], [got], ex_d[i : i + 1]):
                raise AssertionError(f"after the restart, similar_to read {i} moved beyond "
                                     "a near-tie")
            ties.append(i)
        out["restart_near_ties"] = ties
        out["restart_topk_sites"] = sorted(vec_cap.topk)
        if on_card:
            out["served"] = served_kernels((vec_cap.topk, vec_cap.slabs))
            for site, r in out["served"].items():
                log(f"{site} (the similar_to reads after the restart): equal to plain; "
                    f"{_fmt(r)}")
        # the first read of each after the restart (the card's operand
        # cache empty), then one warm read
        warm = {}
        for name, q in list(QUERIES.items()) + [("similar_to", vec_q[0])]:
            t = time.perf_counter()
            _run_query(server, q)
            warm[name] = (time.perf_counter() - t) * 1e3
        cold["similar_to"] = rec["first_read"] * 1e3
        out["read_ms"] = {"first": cold, "warm": warm}
        fresh = int(server.new_txn().mutate_json(
            set_obj={"uid": "_:fresh", "tag": "fresh"}, commit_now=True)["fresh"], 16)
        if fresh <= known_top:
            raise AssertionError(f"a blank node after the restart got {hex(fresh)}, at or "
                                 f"below a recovered uid {hex(known_top)}")
        log(f"after the restart: (a)-(d), {n_reads} similar_to reads (near-ties {ties}), "
            f"emails, hot_seen and balances equal to before; setop_rows {per['b']} launches in "
            f"(b), "
            f"KV1 {per['similar_to']} in the similar_to reads; fresh blank node "
            f"{hex(fresh)} > {hex(known_top)}; read ms {out['read_ms']}")
        server.kv.close()
    finally:
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS = saved
    return out


# ---------------------------------------------------------------------------
# The serving front (phase 9)
# ---------------------------------------------------------------------------

# (9b): query (b)'s filtered level, rooted at one level-1 uid
ROOTED_B = ('{{ q(func: uid({})) {{ child {{ uid child @filter('
            'eq(tag, "hot")) {{ uid }} }} }} }}')


@contextlib.contextmanager
def knobs(**values):
    """The port's DGRAPH_TPU_* knobs set for the block (it reads them
    live), then put back as they were."""
    import os

    from dgraph_tpu_torch.x import config

    saved = {n: os.environ.get(config.REGISTRY[n].env) for n in values}
    for n, v in values.items():
        config.set_env(n, v)
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                config.unset_env(n)
            else:
                os.environ[config.REGISTRY[n].env] = v


@contextlib.contextmanager
def forced_device(on=True):
    """Every set op of the port on the device path with the member sweep
    on, or (on=False) every size on the host loops; restored after."""
    from dgraph_tpu_torch.query import dispatch

    saved = (dispatch._FORCE_DEVICE, dispatch._USE_PALLAS, dispatch._DEVICE_MIN_TOTAL)
    dispatch._FORCE_DEVICE = dispatch._USE_PALLAS = on
    if not on:
        dispatch._DEVICE_MIN_TOTAL = 1 << 62
    try:
        yield
    finally:
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS, dispatch._DEVICE_MIN_TOTAL = saved


def _p50_p99(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def front_graph(server, g, n_roots=50, log=print):
    """(9b)-(9d) on phase 4's server, on the forced device path: the plan
    cache over (b)'s filtered level rooted at each of the first `n_roots`
    level-1 uids (the cache keeps 16 bindings a shape, so a cycle over
    more misses), twice,
    with PLAN_CACHE_SIZE 512 and 0; `query_rdf` of (a) and (b), device
    path == host path, one triple per edge of the JSON answer; the result
    cache over (a)-(d) (hits == misses), then one committed edge that (b)
    must show on its next read, a miss. Returns the measurements, the K1
    count of these runs (zeroed just before) and K1's inputs per shape."""
    from dgraph_tpu_torch.ops import member_sweep
    from dgraph_tpu_torch.utils.observe import METRICS

    on_card = server.device.type == "cuda"

    def count():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    f, want_b = g["f"], expected(g, "b")
    roots = [hex(int(u)) for u in g["l1"][:n_roots]]
    out = {"plan": {}, "rdf": {}}
    with forced_device(), _Capture(member_sweep) as cap:
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        # two orders of the same 2 x len(roots) queries: every root, then
        # every root again ("cycle"), and each root twice in a row
        # ("repeat"); the plan cache keeps 16 literal bindings per shape,
        # and each arm starts from a new epoch (as after a commit)
        orders = {"cycle": roots + roots, "repeat": [r for r in roots for _ in (0, 1)]}
        answers = {}
        for size in (512, 0):
            for how, seq in orders.items():
                server.serving.plan_cache.invalidate()
                with knobs(PLAN_CACHE_SIZE=size):
                    h0 = METRICS.value("plan_cache_hit_total")
                    m0 = METRICS.value("plan_cache_miss_total")
                    c0, s0, parse_ns, got = count(), setops_count(on_card), [], {}
                    for r in seq:
                        res = server.query(ROOTED_B.format(r), want="raw")
                        parse_ns.append(res["extensions"]["server_latency"]["parsing_ns"])
                        if got.setdefault(r, res["data"].raw) != res["data"].raw:
                            raise AssertionError(f"(9b): root {r} answered two ways")
                    hits = METRICS.value("plan_cache_hit_total") - h0
                    misses = METRICS.value("plan_cache_miss_total") - m0
                answers[size, how] = got
                out["plan"][f"{size} {how}"] = {
                    "hit_rate": hits / max(1, hits + misses), "hits": int(hits),
                    "parse_ms": float(np.mean(parse_ns)) / 1e6, "sweeps": count() - c0,
                    "setops": setops_count(on_card) - s0}
        if any(a != answers[512, "cycle"] for a in answers.values()):
            raise AssertionError("(9b): answers differ with the plan cache on and off")
        for i, r in enumerate(roots):
            l2 = json.loads(answers[512, "cycle"][r])["q"][0]["child"]
            got = {int(o["uid"], 16): [int(x["uid"], 16) for x in o.get("child", [])]
                   for o in l2}
            if got != {int(u): want_b[int(u)] for u in g["l2"][i * f : (i + 1) * f]}:
                raise AssertionError(f"(9b): the query rooted at {r} != numpy")
        if out["plan"]["512 repeat"]["hits"] != len(roots) or out["plan"]["0 cycle"]["hits"]:
            raise AssertionError(f"(9b): plan cache {out['plan']}")
        log(f"(9b) (b)'s filtered level rooted at each of {len(roots)} level-1 uids, twice: "
            f"equal with PLAN_CACHE_SIZE 512 and 0 and to numpy; {out['plan']}")

        for name in ("a", "b"):
            c0, s0 = count(), setops_count(on_card)
            t = time.perf_counter()
            rdf = server.query_rdf(QUERIES[name])
            dev_ms = (time.perf_counter() - t) * 1e3
            sweeps, setops = count() - c0, setops_count(on_card) - s0
            with forced_device(False):
                host = server.query_rdf(QUERIES[name])
            edges = json_edges(json.loads(_run_query(server, QUERIES[name])))
            triples = len(rdf.splitlines())
            if rdf != host or triples != edges:
                raise AssertionError(f"(9d) {name}: device path == host path {rdf == host}, "
                                     f"{triples} triples for {edges} JSON edges")
            out["rdf"][name] = {"triples": triples, "bytes": len(rdf), "ms": dev_ms,
                                "sweeps": sweeps, "setops": setops}
        if out["rdf"]["b"]["setops"] < 1:
            raise AssertionError("(9d): setop_rows did not launch in query_rdf (b)")
        log(f"(9d) query_rdf of (a) and (b): device path == host path byte for byte, one "
            f"triple per edge of the JSON answer; {out['rdf']}")

        with knobs(RESULT_CACHE_SIZE=64):
            h0 = METRICS.value("result_cache_hit_total")
            miss, hit, ms = {}, {}, {"miss": {}, "hit": {}}
            for into, arm in ((miss, "miss"), (hit, "hit")):
                for name, q in QUERIES.items():
                    t = time.perf_counter()
                    into[name] = _run_query(server, q)
                    ms[arm][name] = (time.perf_counter() - t) * 1e3
            hits = METRICS.value("result_cache_hit_total") - h0
            if hit != miss or hits != len(QUERIES):
                raise AssertionError(f"(9c): {hits} hits; hit bytes == miss bytes "
                                     f"{hit == miss}")
            l2 = int(g["l2"][0])
            new = next(int(u) for u in g["hot"] if int(u) not in want_b[l2])
            server.new_txn().mutate_rdf(set_rdf=f"<{hex(l2)}> <child> <{hex(new)}> .",
                                        commit_now=True)
            h1 = METRICS.value("result_cache_hit_total")
            after = extract("b", json.loads(_run_query(server, QUERIES["b"])))
            if METRICS.value("result_cache_hit_total") != h1:
                raise AssertionError("(9c): the read after a commit was a hit")
            if after != {**want_b, l2: sorted(want_b[l2] + [new])}:
                raise AssertionError("(9c): the read after the commit misses its edge")
        out["result_cache"] = {"hits": int(hits), "ms": ms, "edge": [hex(l2), hex(new)]}
        log(f"(9c) RESULT_CACHE_SIZE=64 over (a)-(d): {int(hits)} hits, hit bytes == miss bytes; "
            f"after <{hex(l2)}> <child> <{hex(new)}> committed, (b) missed and shows it; "
            f"ms {ms}")
    out["sweeps"] = count()
    out["sweep_shapes"] = cap.by_shape
    return out


def front_vectors(server, Qs, named, k=10, clients=16, per_client=64, trace_per_client=8,
                  log=print):
    """(9a), (9e), (9f) on phase 7's server. (9a): `clients` threads ask
    `per_client` plain top-k `similar_to` each (Qs in turn), on `emb` and
    `emb_small`, at BATCH_WINDOW_US 0 and 200; every answer must equal
    the same query's solo answer. (9e): ADMISSION=1, MAX_INFLIGHT=4 under
    the same clients: some must be shed with the retryable error, every
    admitted answer must equal its solo answer. (9f): ACL and audit on;
    a reader of `name` alone is refused a query that touches `emb` and
    answers a query on `name` as with ACL off; `named` is a uid with a
    name. Returns the measurements, the KV1 and KV2 counts of these runs
    (zeroed just before) and their inputs per shape."""
    import tempfile

    import torch

    from dgraph_tpu_torch.acl.acl import READ, AclError
    from dgraph_tpu_torch.ops import ivf_scan, vector_topk
    from dgraph_tpu_torch.serving import TooManyRequestsError
    from dgraph_tpu_torch.utils.observe import METRICS

    on_card = server.device.type == "cuda"

    def launches():
        if on_card:
            return {"vector_topk": vector_topk.LAUNCHES, "ivf_slab_scan": ivf_scan.LAUNCHES}
        return {"vector_topk": vector_topk.PLAIN_CALLS, "ivf_slab_scan": ivf_scan.PLAIN_CALLS}

    texts = [_vec_text(q) for q in Qs]
    reads = {p: [f'{{ q(func: similar_to({p}, {k}, "{t}")) {{ uid }} }}' for t in texts]
             for p in ("emb", "emb_small")}
    order = [[(c * per_client + j) % len(Qs) for j in range(per_client)]
             for c in range(clients)]
    out = {"arms": {}}

    def drive(pred, work, n=per_client):
        """work(client, query index) on `clients` threads, each over its
        first n queries; returns (wall s, search_batch widths)."""
        import threading

        idx = server.vector_indexes[pred]
        real, widths = idx.search_batch, []
        wrapped = "search_batch" in vars(idx)

        def recorded(Q, kk):
            widths.append(len(Q))
            return real(Q, kk)

        barrier = threading.Barrier(clients)

        def client(c):
            barrier.wait()
            for i in order[c][:n]:
                work(c, i)

        idx.search_batch = recorded
        try:
            t0 = time.perf_counter()
            _threads(client, [(c,) for c in range(clients)])
            return time.perf_counter() - t0, widths
        finally:
            if wrapped:
                idx.search_batch = real
            else:
                del idx.search_batch

    with _VecCapture() as cap:
        vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
        ivf_scan.LAUNCHES = ivf_scan.PLAIN_CALLS = 0
        solo = {p: [_run_query(server, q) for q in qs] for p, qs in reads.items()}
        nq = clients * per_client
        for pred in ("emb", "emb_small"):
            for window in (0, 200):
                lat, bad = [], []

                def ask(c, i, pred=pred, lat=lat, bad=bad):
                    t = time.perf_counter()
                    got = _run_query(server, reads[pred][i])
                    lat.append((time.perf_counter() - t) * 1e3)
                    if got != solo[pred][i]:
                        bad.append(i)

                c0, l0 = METRICS.value("batch_coalesced_total"), launches()
                with knobs(BATCH_WINDOW_US=window):
                    wall, widths = drive(pred, ask)
                if bad:
                    raise AssertionError(f"(9a) {pred} window {window}: {len(bad)} answers "
                                         f"!= their solo answers, queries {sorted(set(bad))[:8]}")
                wide = [w for w in widths if w > 1]
                l1 = launches()
                p50, p99 = _p50_p99(lat)
                out["arms"][f"{pred} {window}"] = arm = {
                    "qps": nq / wall, "p50_ms": p50, "p99_ms": p99,
                    "batch_coalesced_total": METRICS.value("batch_coalesced_total") - c0,
                    "coalesced_batches": len(wide),
                    "mean_width": float(np.mean(wide)) if wide else 1.0,
                    "widths": sorted(set(widths)),
                    "kv1_per_query": (l1["vector_topk"] - l0["vector_topk"]) / nq,
                    "kv2_per_query": (l1["ivf_slab_scan"] - l0["ivf_slab_scan"]) / nq}
                if window and pred == "emb" and not wide:
                    raise AssertionError(f"(9a) {pred}: nothing coalesced at window {window}")
                log(f"(9a) {pred}, BATCH_WINDOW_US={window}, {clients} clients x {per_client}: "
                    f"every answer == its solo answer; {json.dumps(arm)}")
        if on_card:
            # the card's idle share over one traced window of the 200 us arm
            from torch.profiler import ProfilerActivity, profile

            with knobs(BATCH_WINDOW_US=200), profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                wall, _ = drive("emb", lambda c, i: _run_query(server, reads["emb"][i]),
                                n=trace_per_client)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e6
            out["trace"] = {"queries": clients * trace_per_client, "wall_s": wall,
                            "busy_s": busy, "idle_share": 1 - busy / wall}
            log(f"(9a) traced window, emb at 200 us: {out['trace']}")

        shed, bad = [0] * clients, []

        def admitted(c, i):
            try:
                got = _run_query(server, reads["emb"][i])
            except TooManyRequestsError as e:
                if not (e.retryable and e.code == "too_many_requests"):
                    bad.append(repr(e))
                shed[c] += 1
                return
            if got != solo["emb"][i]:
                bad.append(i)

        s0 = METRICS.value("admission_shed_total")
        with knobs(ADMISSION=True, MAX_INFLIGHT=4, BATCH_WINDOW_US=200):
            wall, _ = drive("emb", admitted)
        out["admission"] = {"shed": sum(shed), "admitted": nq - sum(shed), "wall_s": wall,
                            "shed_metric": METRICS.value("admission_shed_total") - s0}
        if bad or not sum(shed) or out["admission"]["shed_metric"] != sum(shed):
            raise AssertionError(f"(9e): {out['admission']}, wrong answers or errors {bad[:8]}")
        log(f"(9e) ADMISSION=1, MAX_INFLIGHT=4, {clients} clients: every shed raised the "
            f"retryable TooManyRequestsError, every admitted answer == its solo answer; "
            f"{out['admission']}")

        name_q = f'{{ q(func: uid({hex(named)})) {{ uid name }} }}'
        plain = _run_query(server, name_q)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as d:
            server.enable_audit(d)
            server.enable_acl(secret=b"chip-smoke-acl-secret-0123456789")
            groot = server.login("groot", "password")["accessJwt"]
            server.acl.add_user("reader", "readerpw")
            server.acl.add_group("readers")
            server.acl.add_user_to_group("reader", "readers")
            server.acl.set_rule("readers", "name", READ)
            tok = server.login("reader", "readerpw")["accessJwt"]
            try:
                server.query(reads["emb"][0], access_jwt=tok)
                raise AssertionError("(9f): a reader of name alone was answered on emb")
            except AclError:
                pass
            mine = server.query(name_q, access_jwt=tok, want="raw")["data"].raw
            guardian = server.query(reads["emb"][0], access_jwt=groot, want="raw")["data"].raw
            if mine != plain or b'"name"' not in mine or guardian != solo["emb"][0]:
                raise AssertionError(f"(9f): {mine} != {plain} with ACL off, or groot's "
                                     "similar_to != its answer with ACL off")
            out["acl"] = {"audit_lines": len(server.audit.read_all())}
        log(f"(9f) ACL on: emb denied to a reader of name, name answered as with ACL off, "
            f"groot's similar_to unchanged; audit lines {out['acl']['audit_lines']}")
    out["launches"] = launches()
    out["captured"] = (cap.topk, cap.slabs)
    return out


def sweep_shapes_equal(by_shape):
    """K1 against its plain version, exactly, on the inputs of every
    shape the main path gave it. Returns {shape: mismatches}."""
    import torch

    from dgraph_tpu_torch.ops import member_sweep

    res = {}
    for shape, (A, LA, B, LB) in sorted(by_shape.items()):
        got = member_sweep.membership_batch(A, LA, B, LB)
        want = member_sweep.membership_batch_plain(A, LA, B, LB)
        torch.cuda.synchronize()
        res[shape] = int((got != want).sum())
    return res


# ---------------------------------------------------------------------------
# Data in and out (phase 10)
# ---------------------------------------------------------------------------


def _vector_lines(args):
    V, base, pred = args
    return "\n".join(
        f'<{hex(base + i)}> <{pred}> "[{",".join(map("{:.9g}".format, row))}]" .'
        for i, row in enumerate(V.tolist())
    )


def vector_nquads(V, base, pred="emb_small", workers=1, step=4096):
    """The rows of V as N-Quads on uids base, base + 1, ...: each float32
    printed with 9 significant digits, which parse back to the same
    float32 (half the text of a double's shortest form). The literals
    are untyped: the predicate's schema types them, and the bulk
    loader's map takes such lines by its fast
    line pattern (a `^^<float32vector>` suffix sends each through the
    RDF statement splitter, a character at a time). With `workers` above
    1, blocks of `step` rows are printed in forked processes."""
    parts = [(V[s : s + step], base + s, pred) for s in range(0, len(V), step)]
    if workers <= 1 or len(parts) <= 1:
        return "\n".join(map(_vector_lines, parts))
    import multiprocessing as mp

    with mp.get_context("fork").Pool(workers) as pool:
        return "\n".join(pool.map(_vector_lines, parts))


def _event_object(e):
    """A CDC event's object as an N-Quad term."""
    if "value_uid" in e:
        return f"<{hex(e['value_uid'])}>"
    if e["operation"] != "set":
        return "*"
    v = e["value"]
    if isinstance(v, bool):
        return f'"{str(v).lower()}"^^<xs:boolean>'
    if isinstance(v, int):
        return f'"{v}"^^<xs:int>'
    if isinstance(v, float):
        return f'"{v!r}"^^<xs:float>'
    if isinstance(v, list):
        return f'"[{", ".join(map(repr, v))}]"^^<xs:float32vector>'
    return json.dumps(str(v))


def apply_events(server, events):
    """Replay a CDC stream through the mutation path: one transaction per
    source commit, in commit order, its deletes before its sets."""
    by_ts = {}
    for ev in sorted(events, key=lambda ev: (ev["meta"]["commit_ts"], ev["meta"]["seq"])):
        by_ts.setdefault(ev["meta"]["commit_ts"], []).append(ev["event"])
    for evs in by_ts.values():
        lines = {"set": [], "del": []}
        for e in evs:
            lines[e["operation"]].append(f"<{hex(e['uid'])}> <{e['attr']}> {_event_object(e)} .")
        t = server.new_txn()
        if lines["del"]:
            t.mutate_rdf(del_rdf="\n".join(lines["del"]))
        if lines["set"]:
            t.mutate_rdf(set_rdf="\n".join(lines["set"]))
        t.commit()
    return len(by_ts)


def committed_events(kv, since):
    """Every data posting the store holds above `since`, as the CDC event
    it must have had: {(commit_ts, seq): event}."""
    from dgraph_tpu_torch.admin.cdc import events_for
    from dgraph_tpu_torch.posting.pl import KIND_DELTA, decode_record
    from dgraph_tpu_torch.x import keys

    per_ts = {}
    for key, vers in kv.iterate_versions(b"", 1 << 62):
        try:
            if not keys.parse_key(bytes(key)).is_data:
                continue
        except Exception:
            continue  # meta keys: the CDC checkpoint, counters
        for ts, rec in vers:
            if ts <= since:
                break
            if rec[0] != KIND_DELTA:
                raise AssertionError(f"a rolled-up version above {since}: {key!r}")
            per_ts.setdefault(int(ts), {}).setdefault(bytes(key), []).extend(
                decode_record(bytes(rec))[2])
    return {(ev["meta"]["commit_ts"], ev["meta"]["seq"]): ev["event"]
            for ts in per_ts for ev in events_for(ts, per_ts[ts])}


def read_sink(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _by_id(events):
    return {(ev["meta"]["commit_ts"], ev["meta"]["seq"]): ev["event"] for ev in events}


def _answers(server, vec_q):
    out = {name: _run_query(server, q) for name, q in QUERIES.items()}
    out.update({f"v{i}": _run_query(server, q) for i, q in enumerate(vec_q)})
    return out


def _same_answers(what, got, want, V, Q, vec_base, ex_d, new=()):
    """Byte-equal answers; a similar_to read may differ only at an f32
    near-tie of the exact top-k (rows of V; `new` uids equal as they are).
    Returns the reads that differed at a near-tie."""
    ties = []
    for name, w in want.items():
        if got[name] == w:
            continue
        if not name.startswith("v"):
            raise AssertionError(f"{what}: {name} answers differently")
        i = int(name[1:])
        a, b = ([int(o["uid"], 16) for o in json.loads(x)["q"]] for x in (got[name], w))
        if [u for u in a if u in new] != [u for u in b if u in new]:
            raise AssertionError(f"{what}: similar_to read {i} moved a committed vector")
        rows = np.sort([u - vec_base for u in a if u not in new])
        if not near_equal(V, Q[i : i + 1], [rows], ex_d[i : i + 1, : len(rows)]):
            raise AssertionError(f"{what}: similar_to read {i} moved beyond a near-tie")
        ties.append(i)
    return ties


def _wait_task(server, tid, timeout=1800.0):
    from dgraph_tpu_torch.admin import tasks

    st = tasks._queue_of(server).wait(tid, timeout=timeout)
    if st.get("status") != "Success":
        raise AssertionError(f"task {tid}: {st}")
    return st["result"]


def serve_ops(device, workdir, V, Q, fanout=100, pool=200_000, workers=None, n_reads=16,
              k=10, n_flips=20, n_unrelated=5, n_vec_commits=5, n_final=10, n_accounts=1000,
              bank_threads=8, transfers_per_thread=100, split_at=50_000, log=print):
    """Phase 10 in `workdir`: (10a) the parallel bulk loader loads the
    fan-out graph (the native reduce) and the vectors V (the Python
    reduce, its map workers forked while the card is live) into a
    `Server(device, data_dir)` with group commit on and the device path
    forced; the store is closed and reopened. (10b) subscriptions to (b)
    and to one similar_to, over tag flips, unrelated commits and vector
    commits. (10c) CDC to an ndjson file over (10b) and the JSON bank,
    a final batch lost by an injected emitter crash, a restart and a
    replay; the union must equal the committed set, and applied to a
    fresh Server it must answer as the source. (10d) a full and an
    incremental backup through the task queue, restores into fresh
    Servers (whole chain, and `until` the full backup) and into the
    warm source, an RDF export bulk-loaded into a fresh Server, and
    rollups, the second splitting the `cold` index list. Every answer is
    held to numpy or to the source. The kernel counts are zeroed at the
    start and read at the end; K1's inputs per shape and KV1's per site
    are kept for the comparison with the plain versions. Returns the
    measurements; raises when a check fails."""
    import gc
    import os

    import torch

    from dgraph_tpu_torch.admin import backup as bk
    from dgraph_tpu_torch.admin import tasks
    from dgraph_tpu_torch.admin.cdc import cdc_for_uri
    from dgraph_tpu_torch.api import server as server_mod
    from dgraph_tpu_torch.api.subscriptions import Subscriptions
    from dgraph_tpu_torch.conn import faults
    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader
    from dgraph_tpu_torch.ops import member_sweep, vector_topk
    from dgraph_tpu_torch.posting import pl as plmod
    from dgraph_tpu_torch.posting.pl import decode_record
    from dgraph_tpu_torch.posting.rollup import rollup_all
    from dgraph_tpu_torch.tok.tok import build_tokens
    from dgraph_tpu_torch.types.types import TypeID, Val
    from dgraph_tpu_torch.utils.observe import METRICS
    from dgraph_tpu_torch.x import keys

    on_card = torch.device(device).type == "cuda"
    workers = max(2, workers or os.cpu_count() or 2)

    def sweeps():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    def setops():
        return setops_count(on_card)

    def topks():
        return vector_topk.LAUNCHES if on_card else vector_topk.PLAIN_CALLS

    def new_server(name=None):
        s = server_mod.Server(device=device, data_dir=name and os.path.join(workdir, name))
        s.slow_query_ms = float("inf")
        return s

    def close(server):
        server.kv.sync()
        server.kv.close()

    def bulk(server, texts, name):
        ld = ParallelBulkLoader(server, workdir=os.path.join(workdir, name), workers=workers)
        native = ld._native_ok()
        chunks = 1 if native else len(ld._chunk(texts))
        t0 = time.perf_counter()
        ld.load_texts(texts)
        return ld, native, chunks, time.perf_counter() - t0

    g = make_graph(fanout, pool)
    hot = {int(u) for u in g["hot"]}
    vec_base = int(g["pool"].max()) + 1
    new_uids = [vec_base + len(V) + j for j in range(n_vec_commits)]
    qtext = [_vec_text(q) for q in Q[:n_reads]]
    vec_q = [f'{{ q(func: similar_to(emb_small, {k}, "{t}")) {{ uid }} }}' for t in qtext]
    ex_i, ex_d = exact_topk(V, Q[:n_reads], k)
    out = {"step_s": {}}
    t_lap = [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, kept under `name`."""
        now = time.perf_counter()
        out["step_s"][name] = now - t_lap[0]
        t_lap[0] = now

    def check_graph(what, got):
        for name in QUERIES:
            want = expected(g, "a" if name == "a" else "b", hot)
            if extract(name, json.loads(got[name])) != want:
                raise AssertionError(f"{what}: query {name} != numpy")

    with forced_device(), knobs(GROUP_COMMIT=1), _Capture(member_sweep) as cap, \
            _VecCapture() as vcap:
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        setops0 = setops()
        vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0

        # (10a) the bulk loads
        src = new_server("src")
        lease_through(src.zero, new_uids[-1])
        src.alter(WRITE_SCHEMA)
        texts = list(nquad_chunks(g))
        edges = len(g["l1"]) + len(g["l2"]) + len(g["l3"]) + len(g["pool"])  # with the tags
        ld, native, _, graph_s = bulk(src, texts, "bulk_graph")
        if not native:
            raise AssertionError("(10a): the graph load did not take the native reduce")
        lap("10a graph")
        src.alter(SMALL_SCHEMA)
        t0 = time.perf_counter()
        vtext = vector_nquads(V, vec_base, workers=workers)
        text_s = time.perf_counter() - t0
        card_live = on_card and torch.cuda.is_initialized()
        lv, vnative, chunks, vec_s = bulk(src, [vtext], "bulk_vectors")
        del vtext
        idx = src.vector_indexes["emb_small"]
        rows = np.asarray([idx._rows[vec_base + i] for i in range(len(V))])
        if vnative or len(idx) != len(V) or not np.array_equal(idx._vecs[rows], V):
            raise AssertionError("(10a): emb_small does not hold V exactly after the bulk load")
        lap("10a vectors")
        out["load"] = {"edges": edges, "nquads": ld.nquads, "s": graph_s,
                       "edges_per_s": edges / graph_s, "vectors": len(V), "vectors_s": vec_s,
                       "vectors_per_s": len(V) / vec_s, "text_s": text_s, "workers": workers,
                       "map_chunks": chunks, "card_live_at_fork": card_live}
        per = {}
        answers = {}
        for name, q in QUERIES.items():
            c0 = setops()
            answers[name] = _run_query(src, q)
            per[name] = setops() - c0
        c0 = topks()
        answers.update({f"v{i}": _run_query(src, q) for i, q in enumerate(vec_q)})
        per["similar_to"] = topks() - c0
        check_graph("(10a)", answers)
        got_rows = [np.sort([int(o["uid"], 16) - vec_base for o in json.loads(answers[f"v{i}"])["q"]])
                    for i in range(n_reads)]
        if not near_equal(V, Q[:n_reads], got_rows, ex_d):
            raise AssertionError("(10a): similar_to(emb_small) != exact top-k beyond near-ties")
        if per["b"] < 1 or per["similar_to"] < n_reads:
            raise AssertionError(f"(10a): setop_rows {per['b']} launches in (b), KV1 "
                                 f"{per['similar_to']} in {n_reads} similar_to reads")
        log(f"(10a) bulk load, {workers} workers: {edges} edges and tags in {graph_s:.3f}s "
            f"({edges / graph_s:.1f} edges/s, native reduce), {len(V)} x {V.shape[1]} vectors "
            f"in {vec_s:.3f}s ({len(V) / vec_s:.1f} vectors/s, Python reduce, {chunks} map "
            f"chunks forked with the card live: {card_live}; text made in {text_s:.3f}s); "
            f"(a)-(d) == numpy, setop_rows {per['b']} launches in (b), KV1 {per['similar_to']} in "
            f"{n_reads} similar_to reads == exact top-k outside near-ties")
        lap("10a reads")
        close(src)
        del src, idx
        gc.collect()
        t0 = time.perf_counter()
        src = new_server("src")
        out["load"]["reopen_s"] = time.perf_counter() - t0
        ties = _same_answers("(10a) after reopening", _answers(src, vec_q), answers, V, Q,
                             vec_base, ex_d)
        log(f"(10a) reopened in {out['load']['reopen_s']:.3f}s: every answer as before "
            f"(near-ties {ties})")
        after_10a = answers
        lap("10a reopen")

        bdir = os.path.join(workdir, "backup")
        t0 = time.perf_counter()
        full = _wait_task(src, tasks.enqueue_backup(src, bdir))
        out["backup"] = {"full_s": time.perf_counter() - t0, "full_records": full["records"],
                         "full_bytes": disk_bytes(bdir)}
        if full["type"] != "full":
            raise AssertionError(f"(10d): the first backup is {full['type']}")

        lap("full backup")
        # (10c) CDC attached before (10b)'s commits
        attach_ts = src.zero.read_ts()
        commits0 = METRICS.value("num_commits")
        sink1, sink2 = (os.path.join(workdir, f"cdc{i}.ndjson") for i in (1, 2))
        cdc = cdc_for_uri(src, sink1)

        # (10b) subscriptions
        rng = np.random.default_rng(17)
        flips = [int(u) for u in rng.choice(np.unique(g["l3"]), 2 * n_flips + n_final + 3,
                                            replace=False)]

        def flip(u):
            tag = "cold" if u in hot else "hot"
            src.new_txn().mutate_rdf(set_rdf=f'<{hex(u)}> <tag> "{tag}" .', commit_now=True)
            (hot.add if tag == "hot" else hot.discard)(u)

        def timed(fn, *a):
            t = time.perf_counter()
            fn(*a)
            return (time.perf_counter() - t) * 1e3

        lat = {"plain": [timed(flip, u) for u in flips[:n_flips]]}
        lap("10b plain flips")
        subs = Subscriptions(src)
        fired_b, fired_v = [], []
        subs.subscribe(QUERIES["b"], fired_b.append)
        subs.subscribe(vec_q[0], fired_v.append)
        if len(fired_b) != 1 or extract("b", fired_b[0]["data"]) != expected(g, "b", hot):
            raise AssertionError("(10b): (b)'s first callback != numpy")
        c0 = setops()
        lat["subscribed"] = []
        for i, u in enumerate(flips[n_flips : 2 * n_flips]):
            lat["subscribed"].append(timed(flip, u))
            if len(fired_b) != i + 2 or extract("b", fired_b[-1]["data"]) != expected(g, "b", hot):
                raise AssertionError(f"(10b): after flip {i}, (b) fired {len(fired_b) - 1} "
                                     "times or != numpy")
        setops_per_commit = (setops() - c0) / n_flips
        lap("10b subscribed flips")
        for j in range(n_unrelated):
            src.new_txn().mutate_rdf(set_rdf=f'<{hex(flips[-1 - j])}> <hot_seen> "true" .',
                                     commit_now=True)
        if len(fired_b) != n_flips + 1 or len(fired_v) != 1:
            raise AssertionError("(10b): a commit on an unrelated predicate fired a subscription")
        # vector commits, each nearer query 0 than every row of V: the
        # reference re-runs subscriptions before a commit's vectors reach
        # the index, so callback j shows the vectors of commits before j
        q0 = Q[0].astype(np.float32)
        for j, u in enumerate(new_uids):
            vec = q0.copy()
            vec[0] += np.float32(1e-3 * (j + 1))
            src.new_txn().mutate_rdf(set_rdf=f'<{hex(u)}> <emb_small> "{_vec_text(vec)}"'
                                     "^^<xs:float32vector> .", commit_now=True)
        seen = [[int(o["uid"], 16) for o in f["data"]["q"]] for f in fired_v[1:]]
        if len(seen) != n_vec_commits or any(
                [u for u in s if u in new_uids] != new_uids[:j] for j, s in enumerate(seen)):
            raise AssertionError(f"(10b): the similar_to subscription fired {len(seen)} times, "
                                 f"committed vectors seen {[len(set(s) & set(new_uids)) for s in seen]}")
        now = {int(o["uid"], 16) for o in json.loads(_run_query(src, vec_q[0]))["q"]}
        if not now >= set(new_uids):
            raise AssertionError("(10b): a read after the vector commits misses one of them")
        out["subscriptions"] = {
            "b_fired": len(fired_b) - 1, "similar_fired": len(seen),
            "committed_vectors_seen": [len(set(s) & set(new_uids)) for s in seen],
            "setops_per_commit": setops_per_commit,
            "commit_ms": {arm: dict(zip(("p50", "p99"), _p50_p99(ms))) for arm, ms in lat.items()}}
        log(f"(10b) subscriptions: (b) fired once per flip, == numpy ({n_flips} flips), nothing "
            f"on {n_unrelated} unrelated commits; similar_to fired {len(seen)} times on "
            f"{n_vec_commits} vector commits, seeing {out['subscriptions']['committed_vectors_seen']}"
            f" of them (callbacks run before the commit's vectors reach the index); K1 "
            f"{setops_per_commit:.3f} launches a commit; commit ms {out['subscriptions']['commit_ms']}")

        lap("10b the rest")
        # (10c) the bank under CDC, then a batch the sink never gets
        out["bank"] = bank(src, n_accounts, bank_threads, transfers_per_thread)
        lap("10c bank")
        t0 = time.perf_counter()
        if not cdc.flush(timeout_s=600):
            raise AssertionError("(10c): the CDC queue did not drain")
        flush_s = time.perf_counter() - t0
        live = read_sink(sink1)
        ids = [(ev["meta"]["commit_ts"], ev["meta"]["seq"]) for ev in live]
        if ids != sorted(ids) or len(set(ids)) != len(ids):
            raise AssertionError("(10c): sink events out of commit-ts order or ids repeated")
        committed = committed_events(src.kv, attach_ts)
        commits = {ts for ts, _ in committed}
        if _by_id(live) != committed:
            raise AssertionError(f"(10c): {len(live)} events in the sink, {len(committed)} "
                                 "committed postings")
        if cdc.checkpoint != max(commits) or len(commits) != METRICS.value("num_commits") - commits0:
            raise AssertionError(f"(10c): checkpoint {cdc.checkpoint}, last commit "
                                 f"{max(commits)}, {len(commits)} commits in the sink")
        wall = out["bank"]["wall_s"]
        bank_ev = sum(1 for ev in live if ev["event"]["attr"] in ("acct", "bal"))
        out["cdc"] = {"events": len(live), "commits": len(commits), "flush_s": flush_s,
                      "bank_events": bank_ev, "bank_events_per_s": bank_ev / wall}
        lap("10c checks")
        faults.install(faults.FaultPlan(seed=1, rules=[
            dict(point="cdc.emit", action="crash", p=1.0, max=1)]))
        try:
            for u in flips[2 * n_flips : 2 * n_flips + n_final]:
                flip(u)
            deadline = time.time() + 30
            while cdc.dead is None and time.time() < deadline:
                time.sleep(0.02)
        finally:
            faults.reset()
        if cdc.dead is None:
            raise AssertionError("(10c): the injected emitter crash did not fire")
        final_top = src.zero.read_ts()
        close(src)  # no flush: the final batch is committed, not delivered
        del src, subs, cdc
        gc.collect()
        src = new_server("src")
        t0 = time.perf_counter()
        cdc2 = cdc_for_uri(src, sink2)
        if not cdc2.flush(timeout_s=600):
            raise AssertionError("(10c): the replay did not drain")
        replay_s = time.perf_counter() - t0
        cdc2.close()
        committed = committed_events(src.kv, attach_ts)
        lost = set(committed) - set(_by_id(read_sink(sink1)))
        union = _by_id(read_sink(sink1) + read_sink(sink2))
        if not lost or union != committed:
            raise AssertionError(f"(10c): {len(lost)} events undelivered before the restart; "
                                 f"union {len(union)} != committed {len(committed)}")
        out["cdc"].update({"undelivered": len(lost), "replayed": len(read_sink(sink2)),
                           "replay_s": replay_s, "final_top_ts": final_top})
        lap("10c restart and replay")
        fresh = new_server()
        fresh.alter(WRITE_SCHEMA)
        bulk(fresh, texts, "bulk_fresh")
        del texts
        fresh.alter(SMALL_SCHEMA)
        t0 = time.perf_counter()
        applied = apply_events(fresh, [{"meta": {"commit_ts": ts, "seq": s}, "event": ev}
                                       for (ts, s), ev in union.items()])
        out["cdc"]["apply_s"] = time.perf_counter() - t0
        want_b = _run_query(src, QUERIES["b"])
        bal = json.loads(_run_query(src, STATE_READS["balances"]))["q"]
        if (_run_query(fresh, QUERIES["b"]) != want_b
                or json.loads(_run_query(fresh, STATE_READS["balances"]))["q"] != bal
                or sum(o["bal"] for o in bal) != n_accounts * BANK_START):
            raise AssertionError("(10c): the applied events do not answer as the source")
        del fresh
        gc.collect()
        log(f"(10c) CDC: {len(live)} events of {len(commits)} commits in commit-ts order, ids "
            f"unique, each committed posting once, checkpoint == last commit; bank "
            f"{out['bank']['transfers']} transfers ({bank_ev / wall:.1f} bank events/s); "
            f"{len(lost)} events of a final batch undelivered (injected emitter crash), "
            f"the restart's replay sent {len(read_sink(sink2))} in {replay_s:.3f}s; union == "
            f"committed set; {applied} commits applied to a fresh Server answer (b) and the "
            f"balances as the source")

        lap("10c apply")
        # (10d) backup, restore, export and rollup
        t0 = time.perf_counter()
        incr = _wait_task(src, tasks.enqueue_backup(src, bdir))
        out["backup"].update({"incr_s": time.perf_counter() - t0, "incr_records": incr["records"],
                              "bytes": disk_bytes(bdir)})
        if incr["type"] != "incremental" or incr["since"] != full["read_ts"]:
            raise AssertionError(f"(10d): the second backup is {incr['type']} since {incr['since']}")
        lap("10d incremental backup")
        now = _answers(src, vec_q)
        check_graph("(10d) the source", now)
        lap("10d source reads")
        rec = {}
        with _timing(rec, (server_mod.Server, "_load_persisted_state"),
                     (server_mod.Server, "rebuild_vector_indexes")):
            rst = new_server("restored")
            t0 = time.perf_counter()
            records = _wait_task(rst, tasks.enqueue_restore(rst, bdir))["records"]
            rec["total"] = time.perf_counter() - t0
        lap("10d restore")
        c0, v0 = setops(), topks()
        got = _answers(rst, vec_q)
        launched = {"setop_rows": setops() - c0, "vector_topk": topks() - v0}
        ties = _same_answers("(10d) restored", got, now, V, Q, vec_base, ex_d, set(new_uids))
        if launched["setop_rows"] < 1 or launched["vector_topk"] < n_reads:
            raise AssertionError(f"(10d): the restored server launched {launched}")
        out["restore"] = {"records": records, "s": rec["total"],
                          "records_s": rec["total"] - rec["_load_persisted_state"],
                          "state_s": rec["_load_persisted_state"] - rec["rebuild_vector_indexes"],
                          "vector_rebuild_s": rec["rebuild_vector_indexes"],
                          "launches": launched, "near_ties": ties}
        lap("10d restored reads")
        until = new_server()
        bk.restore(until, bdir, until=full["read_ts"])
        lap("10d until restore")
        ties_u = _same_answers("(10d) restored until the full backup", _answers(until, vec_q),
                               after_10a, V, Q, vec_base, ex_d)
        del until
        gc.collect()
        lap("10d until reads")
        before = {name: now[name] for name in QUERIES}
        bk.restore(src, bdir, until=full["read_ts"])  # the warm server
        lap("10d warm restore")
        warm = {name: _run_query(src, q) for name, q in QUERIES.items()}
        if warm != before:
            raise AssertionError("(10d): a restore into the warm source changed its answers")
        log(f"(10d) backups through the task queue: full {full['records']} records "
            f"{out['backup']['full_bytes']} bytes in {out['backup']['full_s']:.3f}s, "
            f"incremental {incr['records']} records in {out['backup']['incr_s']:.3f}s; restore "
            f"of both into a fresh Server {rec['total']:.3f}s (records "
            f"{out['restore']['records_s']:.3f}s, state {out['restore']['state_s']:.3f}s, "
            f"vector rebuild {rec['rebuild_vector_indexes']:.3f}s): (a)-(d) and {n_reads} "
            f"similar_to reads == the source (near-ties {ties}), launches {launched}; until "
            f"the full backup == the source after (10a) (near-ties {ties_u}); restored into "
            "the warm source, (a)-(d) unchanged (newer commits stay)")

        lap("10d warm reads")
        rst.alter(drop_attr="emb_small")  # see PERF.md: the RDF splitter on 768-d rows
        t0 = time.perf_counter()
        exp = _wait_task(rst, tasks.enqueue_export(rst, os.path.join(workdir, "export"),
                                                   fmt="rdf", compress=False))
        export_s = time.perf_counter() - t0
        lap("10d export")
        want_b = _run_query(rst, QUERIES["b"])
        close(rst)
        del rst
        gc.collect()
        reload = new_server()
        with open(exp["schema"]) as f:
            reload.alter(f.read())
        _, rnative, _, reload_s = bulk(reload, [open(exp["data"]).read()], "bulk_export")
        if not rnative or _run_query(reload, QUERIES["b"]) != want_b:
            raise AssertionError("(10d): the export, bulk-loaded, answers (b) differently")
        del reload
        gc.collect()
        out["export"] = {"nquads": exp["nquads"], "s": export_s, "reload_s": reload_s}
        lap("10d reload")

        t0 = time.perf_counter()
        rolled = rollup_all(src)
        out["rollup"] = {"keys": rolled, "s": time.perf_counter() - t0}
        if {name: _run_query(src, q) for name, q in QUERIES.items()} != before:
            raise AssertionError("(10d): rollup_all changed (a)-(d)")
        lap("10d rollup")
        cold = keys.IndexKey("tag", build_tokens(
            Val(TypeID.STRING, "cold"), src.schema.get("tag").tokenizer_objs())[0])
        saved = plmod.MAX_PART_UIDS
        plmod.MAX_PART_UIDS = split_at
        try:
            tail = [u for u in flips[2 * n_flips + n_final :] if u in hot]
            extra = [u for u in np.unique(g["l3"]).tolist() if u in hot and u not in tail]
            tail = (tail + extra)[:3]
            for u in tail[:2]:
                flip(u)  # two deltas on the cold list
            t0 = time.perf_counter()
            out["rollup"]["split_keys"] = rollup_all(src)
            out["rollup"]["split_s"] = time.perf_counter() - t0
            parts = decode_record(src.kv.get(cold, 1 << 62)[1])[3]
            flip(tail[2])  # a delta over the split list: the next read decodes its parts
            c0 = setops()
            got = {name: _run_query(src, q) for name, q in QUERIES.items()}
            out["rollup"]["setops_d"] = setops() - c0
            check_graph("(10d) over the split cold list", got)
        finally:
            plmod.MAX_PART_UIDS = saved
        if len(parts) < 2:
            raise AssertionError(f"(10d): the cold list did not split: parts {parts}")
        out["rollup"]["cold_parts"] = len(parts)
        log(f"(10d) export (RDF, emb_small dropped first) of {exp['nquads']} N-Quads in "
            f"{export_s:.3f}s, bulk-loaded (native) in {reload_s:.3f}s: (b) == the restored "
            f"server; rollup_all {rolled} keys in {out['rollup']['s']:.3f}s, (a)-(d) unchanged; "
            f"MAX_PART_UIDS {split_at}: the cold list rolled into {len(parts)} parts, "
            f"(a)-(d) == numpy over it (setop_rows {out['rollup']['setops_d']} launches)")
        close(src)
        lap("10d split")
        out["launches"] = {"member_sweep": sweeps(), "vector_topk": topks(),
                           "setop_rows": setops() - setops0}
    out["sweep_shapes"] = cap.by_shape
    out["captured"] = (vcap.topk, vcap.slabs)
    return out


# ---------------------------------------------------------------------------
# KV1's regime switch, measured (--crossover)
# ---------------------------------------------------------------------------

# the switch's constants in vector_topk.cu, and their values in the copies
# that take every k in one pass (as far as it can hold) or every k by radix
TOPK_RULE = ("constexpr int kOnePassMaxK = ", "constexpr int kMergeBudget = ")
TOPK_VARIANTS = {"onepass": (2048, 1 << 30), "radix": (0, 0)}
CROSSOVER_KS = (10, 80, 128, 256, 530, 1024, 1536, 2048)
CROSSOVER_SHAPES = [  # (rows, n, metric, cells)
    (1, 1 << 17, "euclidean", None),  # a brute similar_to on 100k vectors
    (1, 67456, "distance", None),     # the IVF top-npool
    (1, 17103, "euclidean", 2000),    # the IVF centroid step
    (1, 1 << 20, "euclidean", None),
    (16, 1 << 20, "euclidean", None),
    (64, 1 << 20, "euclidean", None),
]


def build_topk_variant(name, max_k, budget):
    """vector_topk.cu with the switch's constants replaced, built by nvcc
    into the port's build directory; returns the bound library."""
    import ctypes
    import os

    from dgraph_tpu_torch.ops import cuda_build, vector_topk

    src = open(os.path.join(cuda_build.CSRC, "vector_topk.cu")).read()
    for key, value in zip(TOPK_RULE, (max_k, budget)):
        at = src.index(key) + len(key)
        src = src[:at] + str(value) + src[src.index(";", at):]
    out = os.path.join(cuda_build.BUILD_DIR, "crossover")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, f"topk_{name}.cu"), os.path.join(out, f"topk_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    return vector_topk.bind(ctypes.CDLL(so))


def topk_crossover():
    """Times the built KV1 against a copy that takes every k in one pass
    and one that takes every k by radix, on the same rows (each answer
    equal to topk_plain bit for bit), by device time from the card's
    trace. Prints one line per point, with the regime the built rule
    takes, and per shape the least k from which radix is no slower at
    every larger k of the grid."""
    import ctypes

    import torch

    from dgraph_tpu_torch.ops import vector_topk

    libs = {"rule": vector_topk._kernel()}
    libs.update({k: build_topk_variant(k, *v) for k, v in TOPK_VARIANTS.items()})

    def plan(lib, rows, n, k):
        counts = (ctypes.c_int * 16)()
        m = lib.vector_topk_launch_counts(rows, n, k, counts)
        return {lib.vector_topk_kernel_name(i).decode(): counts[i]
                for i in range(m) if counts[i]}

    def run(lib, args):
        saved = vector_topk._lib
        vector_topk._lib = lib
        vector_topk._sizes.cache_clear()
        try:
            return vector_topk.topk(**args)
        finally:
            vector_topk._lib = saved
            vector_topk._sizes.cache_clear()

    for rows, n, metric, cells in CROSSOVER_SHAPES:
        radix_from = None
        for k in CROSSOVER_KS:
            args = topk_case(rows, n, k, metric, "gauss", seed=rows + n + k, cells=cells)
            want = vector_topk.topk_plain(**args)
            ms = {}
            for name, lib in libs.items():
                got = run(lib, args)
                if not (torch.equal(got[1], want[1]) and torch.equal(
                        got[0].view(torch.int32), want[0].view(torch.int32))):
                    raise AssertionError(f"rows={rows} n={n} k={k}: {name} build != plain")
                ms[name] = kernel_device_ms(lambda lib=lib: run(lib, args), 10,
                                            name=plan(lib, rows, n, k))
            if ms["radix"] > ms["onepass"]:
                radix_from = None
            elif radix_from is None:
                radix_from = k
            rule = "one pass" if vector_topk.onepass(rows, n, k) else "radix"
            print(f"    rows={rows} n={n} k={k} {metric}: one pass {ms['onepass']:.6f} "
                  f"radix {ms['radix']:.6f} rule {ms['rule']:.6f} ({rule})", flush=True)
            del args, want
        print(f"    rows={rows} n={n}: radix no slower from k = "
              f"{radix_from if radix_from else 'none in the grid'} on", flush=True)


# ---------------------------------------------------------------------------


def data_in_and_out(V, Q, json_rate, card, t_start):
    """Phase 10 in a temporary directory, then K1 against its plain
    version at every shape it took and KV1 at every site; prints as it
    goes. Returns the measurements."""
    import tempfile

    print("[10] data in and out on the card: bulk loads, subscriptions, CDC, backup, "
          "restore, export, rollup; at " + card, flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_") as d:
        # the bank at 8 x 50 transfers (8 x 100 before phase 11), for the
        # time limit
        ops = serve_ops("cuda", d, V, Q, transfers_per_thread=50,
                        log=lambda m: print("    " + m, flush=True))
    print(f"    bulk load {ops['load']['edges_per_s']:.1f} edges/s and "
          f"{ops['load']['vectors_per_s']:.1f} vectors/s; phase 8's mutate_json "
          + (f"{json_rate:.1f} edges/s" if json_rate else "not measured in this run"),
          flush=True)
    if ops["load"]["map_chunks"] < 2 or not ops["load"]["card_live_at_fork"]:
        raise AssertionError(f"(10a): the vector load did not fork its map workers with the "
                             f"card live: {ops['load']}")
    if min(n for k, n in ops["launches"].items() if k != "member_sweep") < 1:  # K1: pairs
        raise AssertionError(f"(10) a kernel did not launch: {ops['launches']}")
    bad = {k: n for k, n in sweep_shapes_equal(ops["sweep_shapes"]).items() if n}
    if bad:
        raise AssertionError(f"(10) K1 != plain at shapes (n, pa, pb): {bad}")
    print(f"    K1 launches {ops['launches']['member_sweep']}, equal to plain at every shape "
          f"(n, pa, pb) it took: {sorted(ops.pop('sweep_shapes'))}", flush=True)
    served10 = served_kernels(ops.pop("captured"))
    for site, r in served10.items():
        print(f"    {site} (phase 10 inputs): equal to plain; {_fmt(r)}", flush=True)
    print("    [10] " + json.dumps(ops), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)
    return ops


# ---------------------------------------------------------------------------
# The cluster (phase 11)
# ---------------------------------------------------------------------------

# phase 8's lsm arm: 25,000 of the 100,000 `emb_small` rows (all of them
# before phase 11; 30.0 s to load, 7.26 s to rebuild in PR 5's run)
LSM_VECTORS = 25_000
# phase 10's rows in the whole script: 25,000 of the 100,000 (all of them
# before phase 13, and with `--ops-only`; the vectors' Python reduce took
# 43.0 s and the restores' rebuilds 12.0 s each on the H100 machine)
OPS_VECTORS = 25_000

CLUSTER_SCHEMA = "child: [uid] .\ntag: string @index(exact) ."
# (11e)'s rows: each written key asks the replicated Zero for its tablet,
# one in-process Raft round a key (2,000 rows: 49.7 s on the H100 machine;
# 1,000 before phase 13, and with `--cluster-only`)
CLUSTER_VECTORS = 500
# The graph of phase 11 in the whole script: a tenth of phase 4's (10
# level-1 nodes over a pool of 20,000). Every remote read is one RPC per
# key, so the full graph's (c) alone takes about 200,000 RPCs a read, and
# with its load more than the time limit leaves after phases 1-10;
# `--cluster-only` runs phase 11 on the full graph (PERF.md section 4).
CLUSTER_CUT = {"roots": 10, "pool": 20_000}
CLUSTER_TAG_CHUNK = 2_000  # indexed values a commit (see serve_cluster)
CLUSTER_MODULES = ("dgraph_tpu_torch.worker.alpha_process",
                   "dgraph_tpu_torch.zero.zero_process")


class _RpcCount:
    """Counts the coordinator's RPCs (`RpcPool.call`: reads, health
    probes and proposals; the pool's heartbeats bypass it), delegating
    every call unchanged."""

    def __init__(self, pool):
        import threading

        self.pool, self.real, self.n = pool, pool.call, 0
        self._lock = threading.Lock()

    def __call__(self, *a, **kw):
        with self._lock:
            self.n += 1
        return self.real(*a, **kw)

    def __enter__(self):
        self.pool.call = self
        return self

    def __exit__(self, *exc):
        del self.pool.call


def cluster_children(modules=CLUSTER_MODULES):
    """{pid: module} of this process's live replicas running `modules`."""
    import os

    out = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().split("\0")
        except (OSError, ValueError, IndexError):
            continue  # gone meanwhile
        if ppid == os.getpid() and any(m in cmd for m in modules):
            out[int(pid)] = next(m for m in cmd if m in modules)
    return out


def check_replicas_off_card(cluster, on_card):
    """No replica of `cluster` holds a CUDA context: none maps the
    driver library, and nvidia-smi lists none of them (at most the
    coordinator). Returns what nvidia-smi listed."""
    import os

    pids = {p.pid for p in cluster.procs.values() if p.poll() is None}
    if set(cluster_children()) != pids:
        raise AssertionError(f"replicas {sorted(pids)} != live children {cluster_children()}")
    for pid in pids:
        with open(f"/proc/{pid}/maps") as f:
            if "libcuda" in f.read():
                raise AssertionError(f"replica {pid} mapped the CUDA driver")
    if not on_card:
        return []
    apps = [line.split(",")[0].strip() for line in subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines() if line.strip()]
    if {int(a) for a in apps if a.isdigit()} & pids or len(apps) > 1:
        raise AssertionError(f"nvidia-smi lists {apps}; script {os.getpid()}, replicas "
                             f"{sorted(pids)}")
    return apps


def serve_cluster(device, workdir, V, Q, fanout=100, roots=None, pool=200_000, n_flips=100,
                  n_reads=16, k=10, chunk=10_000, vec_chunk=1000, log=print):
    """Phase 11 in `workdir`, the coordinator on `device`, group commit on,
    the columnar path off and the device path forced. (11a) a
    `ProcCluster` of 2 groups x 3 replica processes loads the fan-out
    graph (rows `fanout` wide under `roots` level-1 nodes, over a pool of
    `pool`) through cluster transactions and answers (a)-(d); (11b) the
    leader of `tag`'s group is killed, a flip of `n_flips` tags commits,
    the victim restarts, catches up and answers (b) alone by follower
    reads; (11c) `tag` moves to the other group while two threads read
    (b) back to back, the flip held until a read is in flight, so that
    one read straddles it; (11d) the cluster is closed and a new one
    opened on `workdir` answers (a)-(d) as before at the last snapshot
    the client saw; (11e) an in-process `DistributedCluster` (2 x 3, a
    replicated Zero) commits the vectors V through cluster RDF
    transactions and answers `n_reads` similar_to reads. Every answer is
    held to numpy (and the graph's to the host path); K1's inputs per
    shape and KV1's per site are kept. Returns the measurements; raises
    when a check fails.

    Commits carry `chunk` N-Quads (CLUSTER_TAG_CHUNK of the indexed
    tags) and a move's proposals 256 KiB: a replica answers a proposal
    once it has applied it, and a second commit of 10,000 indexed values
    into one group (or a 4 MiB move chunk of them) can outlast the
    proposal's 15 s RPC timeout (the full graph's first run failed so),
    which commits of 2,000 do not. Every remote read is one RPC per key,
    so (c)'s `has(tag)` over the level-3 frontier takes about as many
    RPCs as the pool has nodes; a query's budget is 600 s (past it the
    cluster answers in part) and its retry budget 4,096 re-issues (a
    read slower than 150 ms fires a hedge, which spends one; the default
    16 is sized for queries of a few hundred reads)."""
    import os
    import threading

    import torch

    from dgraph_tpu_torch.conn import faults
    from dgraph_tpu_torch.ops import member_sweep, vector_topk
    from dgraph_tpu_torch.query import dispatch
    from dgraph_tpu_torch.utils.observe import METRICS
    from dgraph_tpu_torch.worker.groups import DistributedCluster
    from dgraph_tpu_torch.worker.harness import ProcCluster
    from dgraph_tpu_torch.worker.remote import RemoteGroup

    on_card = torch.device(device).type == "cuda"

    def sweeps():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    def setops():
        return setops_count(on_card)

    def topks():
        return vector_topk.LAUNCHES if on_card else vector_topk.PLAIN_CALLS

    def open_cluster():
        t0 = time.perf_counter()
        c = ProcCluster(device=device, n_groups=2, replicas=3,
                        data_dir=os.path.join(workdir, "proc"))
        return c, time.perf_counter() - t0

    g = make_graph(fanout, pool, roots=roots)
    hot = set(g["hot"].tolist())

    def ask(c, q, read_ts=None):
        got = c.query(q, want="raw", read_ts=read_ts)
        ext = got.get("extensions", {})
        if ext.get("partial"):  # "leaderless" alone is a whole answer
            raise AssertionError(f"a partial answer: {ext.get('unreachable_groups')}")
        return got["data"].raw

    def read_all(c, hot, full=True, read_ts=None):
        """(a)-(d), each equal to numpy; with `full`, once on the host
        path, which must answer the same bytes, and (but (c), whose
        `has(tag)` takes an RPC per candidate) once more warm."""
        answers, res = {}, {}
        for name, q in QUERIES.items():
            c0 = setops()
            with _RpcCount(c.pool) as rpc:
                t = time.perf_counter()
                answers[name] = ask(c, q, read_ts)
                res[name] = {"cold_ms": (time.perf_counter() - t) * 1e3}
            res[name].update(rpcs=rpc.n, setops=setops() - c0, bytes=len(answers[name]))
            if full and name != "c":
                t = time.perf_counter()
                if ask(c, q, read_ts) != answers[name]:
                    raise AssertionError(f"query {name}: device path not stable")
                res[name]["warm_ms"] = (time.perf_counter() - t) * 1e3
            if full:
                with forced_device(False):
                    if ask(c, q, read_ts) != answers[name]:
                        raise AssertionError(f"query {name}: device path != host path")
            want = expected(g, "a" if name == "a" else "b", hot)
            if extract(name, json.loads(answers[name])) != want:
                raise AssertionError(f"query {name}: != numpy reference")
        if res["b"]["setops"] < 1:
            raise AssertionError("setop_rows did not launch during (b)")
        return answers, res

    out = {}
    # Two stores in one process can meet the same (key, latest_ts) with
    # other contents, and the card's operand cache then hands the second
    # the first one's operand (ROADMAP Queue 3): the Servers of phases
    # 4-10 ran in this process, so their entries go before the clusters'.
    dispatch.DISPATCHER.device_cache.clear()
    with forced_device(), knobs(GROUP_COMMIT=1, BATCH_APPLY=0, MOVE_CHUNK_BYTES=1 << 18,
                                QUERY_DEADLINE_S=600, READ_RETRY_BUDGET=4096), \
            _Capture(member_sweep) as cap, _VecCapture() as vcap:
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        setops0 = setops()
        vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
        c = dc = None
        try:
            # (11a) load and read
            c, start_s = open_cluster()
            c.alter(CLUSTER_SCHEMA)
            where = {p: c.zero.belongs_to(p) for p in ("child", "tag")}
            if where["child"] == where["tag"]:
                c.move_tablet("tag", next(x for x in c.remote_groups if x != where["tag"]))
                where["tag"] = c.zero.belongs_to("tag")
            t0 = time.perf_counter()
            edges = commits = 0
            for text in nquad_chunks(g, chunk, CLUSTER_TAG_CHUNK):
                c.new_txn().mutate_rdf(set_rdf=text, commit_now=True)
                edges += text.count("\n") + 1
                commits += 1
                if commits % 25 == 0:
                    log(f"(11a) {edges} N-Quads in {commits} commits, "
                        f"{time.perf_counter() - t0:.3f}s")
            load_s = time.perf_counter() - t0
            out["load"] = {"start_s": start_s, "edges": edges, "commits": commits,
                           "s": load_s, "edges_per_s": edges / load_s, "tablets": where}
            out["card_apps"] = check_replicas_off_card(c, on_card)
            log(f"(11a) {len(c.procs)} replica processes (2 groups x 3) up in "
                f"{start_s:.3f}s; child on group {where['child']}, tag on group "
                f"{where['tag']}; {edges} N-Quads in {commits} cluster commits, "
                f"{load_s:.3f}s, {edges / load_s:.1f} edges/s; no replica holds a CUDA "
                f"context (nvidia-smi lists {out['card_apps']})")
            answers, out["reads"] = read_all(c, hot)
            # (b)-(d) ask for the same fields of the same hot rows
            if not answers["b"] == answers["c"] == answers["d"]:
                raise AssertionError("(11a): (b), (c) and (d) answer other bytes")
            log(f"(11a) (a)-(d) equal to the host path and numpy, (b)-(d) the same bytes; ms, "
                f"RPCs, setop_rows launches: " + json.dumps(out["reads"]))

            # (11b) the leader of tag's group dies under a commit
            gid = c.zero.belongs_to("tag")
            grp = c.remote_groups[gid]
            lead = tuple(grp.leader_addr())
            victim = next(n for n, cfg in c._cfgs.items() if cfg.get("group_id") == gid
                          and tuple(cfg["rpc_addr"]) == lead)
            flips = np.random.default_rng(11).choice(g["pool"], n_flips, replace=False)
            hot ^= set(flips.tolist())
            rdf = "\n".join(f'<{hex(u)}> <tag> "{"hot" if u in hot else "cold"}" .'
                            for u in flips.tolist())
            t0 = time.perf_counter()
            c.kill(victim)
            c.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
            gap_s = time.perf_counter() - t0
            flipped_b = ask(c, QUERIES["b"])
            if extract("b", json.loads(flipped_b)) != expected(g, "b", hot):
                raise AssertionError("(11b): (b) after the flip != numpy")
            floor = grp.read_floor()
            addr = tuple(c._cfgs[victim]["rpc_addr"])
            t0 = time.perf_counter()
            c.restart(victim)
            while True:
                try:
                    if int(c.pool.call(addr, "health", timeout=1.0).applied) >= floor:
                        break
                except Exception:  # noqa: BLE001 - still starting
                    pass
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("(11b): the restarted replica never caught up")
                time.sleep(0.05)
            catch_up_s = time.perf_counter() - t0
            # (b) with tag's group narrowed to the victim alone: every tag
            # read it answers is a follower read at the watermark
            solo = RemoteGroup(gid, [addr], c.pool)
            solo.note_floor(floor)
            c.remote_groups[gid] = solo
            try:
                f0 = METRICS.value("follower_reads_total")
                via_victim = ask(c, QUERIES["b"])
                follower = METRICS.value("follower_reads_total") - f0
            finally:
                c.remote_groups[gid] = grp
            if via_victim != flipped_b or follower < 1:
                raise AssertionError(f"(11b): the victim's (b) differs or was not a follower "
                                     f"read ({follower})")
            out["fault"] = {"victim": victim, "gap_s": gap_s, "floor": floor,
                            "catch_up_s": catch_up_s, "follower_reads": follower}
            log(f"(11b) killed replica {victim}, leader of group {gid}: the flip of "
                f"{n_flips} tags committed {gap_s:.3f}s after the kill, (b) equal to "
                f"numpy; restarted, applied past index {floor} in {catch_up_s:.3f}s, and "
                f"answered (b) alone by {follower} follower reads, equal")

            # (11c) tag moves to the other group under reads of (b): the
            # readers ask back to back, and the move's last step before
            # the flip (the `move.delta` syncpoint, fence held) waits for
            # a read in flight, so that one read straddles the flip
            dst = next(x for x in c.remote_groups if x != gid)
            stop, seen, errors = threading.Event(), [], []
            in_flight, marks = {}, {}
            real_syncpoint = faults.syncpoint

            def syncpoint(point, peer="coordinator"):
                if point == "move.delta":
                    t = time.perf_counter()
                    while not in_flight and not errors and time.perf_counter() - t < 120:
                        time.sleep(0.001)
                marks[point] = time.perf_counter()
                return real_syncpoint(point, peer)

            def reader():
                me = threading.get_ident()
                try:
                    while not stop.is_set():
                        t = in_flight[me] = time.perf_counter()
                        got = ask(c, QUERIES["b"])
                        seen.append((t, time.perf_counter(), got == flipped_b))
                        del in_flight[me]
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            ths = [threading.Thread(target=reader) for _ in range(2)]
            for th in ths:
                th.start()
            faults.syncpoint = syncpoint
            t0 = time.perf_counter()
            try:
                moved = c.move_tablet("tag", dst)
                move_s = time.perf_counter() - t0
            finally:
                faults.syncpoint = real_syncpoint
                stop.set()
                for th in ths:
                    th.join(timeout=900)
            if errors:
                raise errors[0]
            if c.zero.belongs_to("tag") != dst or not moved:
                raise AssertionError("(11c): tag did not move")
            if not seen or not all(ok for _, _, ok in seen):
                raise AssertionError(f"(11c): {sum(not ok for _, _, ok in seen)} of {len(seen)} "
                                     "reads during the move differ")
            flip = (marks["move.delta"], marks["move.flip"])
            when = {"before": sum(e < flip[0] for _, e, _ in seen),
                    "straddling": sum(s < flip[0] and e > flip[1] for s, e, _ in seen),
                    "after": sum(s > flip[1] for s, _, _ in seen)}
            if not when["straddling"]:
                raise AssertionError(f"(11c): no read straddled the flip: {when}")
            c0 = setops()
            if ask(c, QUERIES["b"]) != flipped_b or setops() == c0:
                raise AssertionError("(11c): (b) after the move differs or setop_rows did not "
                                     "launch")
            out["move"] = {"s": move_s, "reads": len(seen), "setops_after": setops() - c0,
                           "read_ms": [(e - s) * 1e3 for s, e, _ in seen], "dst": dst,
                           "reads_by_flip": when,
                           "phases_s": {p: t - t0 for p, t in sorted(marks.items(),
                                                                      key=lambda x: x[1])}}
            log(f"(11c) tag moved to group {dst} in {move_s:.3f}s under {len(seen)} reads of "
                f"(b) from 2 threads, all equal ({when['before']} ended before "
                f"the flip, {when['straddling']} straddled it, {when['after']} began after); "
                f"after it (b) equal, setop_rows {setops() - c0} launches")

            # (11d) full restart. The coordinator's Zero keeps its
            # timestamps in memory, so a new one starts again at 1 (in
            # the reference too, ROADMAP Queue 3): the client reads at the
            # last snapshot it saw before the close
            seen_ts = c._snapshot_ts
            c.close()
            c = None
            left = cluster_children()
            if left:
                raise AssertionError(f"(11d): processes outlived close(): {left}")
            c, recover_s = open_cluster()
            c.alter(CLUSTER_SCHEMA)
            out["card_apps_after_restart"] = check_replicas_off_card(c, on_card)
            t0 = time.perf_counter()
            again, out["reads_after_restart"] = read_all(c, hot, full=False,
                                                          read_ts=seen_ts)
            first_reads_s = time.perf_counter() - t0
            before = {"a": answers["a"], "b": flipped_b, "c": flipped_b, "d": flipped_b}
            if again != before or c.zero.belongs_to("tag") != dst:
                raise AssertionError("(11d): (a)-(d) after the restart differ, or tag left "
                                     f"group {dst}")
            out["restart"] = {"recover_s": recover_s, "first_reads_s": first_reads_s}
            log(f"(11d) closed; a new cluster on the same directory served in "
                f"{recover_s:.3f}s; (a)-(d) byte for byte as before, flips and move "
                f"included, in {first_reads_s:.3f}s")
            c.close()
            c = None
            if cluster_children():
                raise AssertionError(f"processes outlived close(): {cluster_children()}")

            # (11e) vectors on an in-process cluster
            # through RDF: `ClusterFacade`'s JSON mutations raise in both
            # packages (ROADMAP Queue 3)
            dc = DistributedCluster(device=device, n_groups=2, replicas=3,
                                    replicated_zero=True)
            vec_base = int(g["pool"].max()) + 1
            dc.alter(SMALL_SCHEMA)
            t0 = time.perf_counter()
            for s in range(0, len(V), vec_chunk):
                dc.new_txn().mutate_rdf(
                    set_rdf=_vector_lines((V[s : s + vec_chunk], vec_base + s, "emb_small")),
                    commit_now=True)
            vec_s = time.perf_counter() - t0
            if len(dc.vector_indexes["emb_small"]) != len(V):
                raise AssertionError("(11e): emb_small does not hold every committed vector")
            c0 = topks()
            vq = [f'{{ q(func: similar_to(emb_small, {k}, "{_vec_text(q)}")) {{ uid }} }}'
                  for q in Q[:n_reads]]
            t0 = time.perf_counter()
            rows = [np.sort([int(o["uid"], 16) - vec_base for o in dc.query(q)["data"]["q"]])
                    for q in vq]
            read_s = time.perf_counter() - t0
            launched = topks() - c0
            _, ex_d = exact_topk(V, Q[:n_reads], k)
            if not near_equal(V, Q[:n_reads], rows, ex_d):
                raise AssertionError("(11e): similar_to != exact top-k beyond near-ties")
            if launched < n_reads:
                raise AssertionError(f"(11e): KV1 {launched} launches in {n_reads} reads")
            out["vectors"] = {"rows": len(V), "s": vec_s, "per_s": len(V) / vec_s,
                              "reads": n_reads, "read_ms": read_s * 1e3 / n_reads,
                              "kv1": launched}
            log(f"(11e) {len(V)} x {V.shape[1]} vectors through {-(-len(V) // vec_chunk)} "
                f"cluster RDF commits in {vec_s:.3f}s ({len(V) / vec_s:.1f}/s); {n_reads} "
                f"similar_to reads equal to the exact top-k, {read_s * 1e3 / n_reads:.3f} "
                f"ms each, KV1 {launched} launches")
        finally:
            if dc is not None:
                dc.close()
            if c is not None:
                c.close()
        out["launches"] = {"member_sweep": sweeps(), "vector_topk": topks(),
                           "setop_rows": setops() - setops0}
        out["sweep_shapes"] = cap.by_shape
        out["captured"] = (vcap.topk, vcap.slabs)
    left = cluster_children()
    if left:
        raise AssertionError(f"processes outlived phase 11: {left}")
    return out


def cluster_phase(V, Q, card, t_start, full=False):
    """Phase 11 in a temporary directory (on the full graph with `full`,
    else on CLUSTER_CUT), then K1 against its plain version at every
    shape it took and KV1 at every site; prints as it goes. Returns the
    measurements."""
    import tempfile

    print("[11] the cluster on the card: 2 groups x 3 replica processes, "
          "predicate-sharded reads with K1 on this process's card, a leader "
          "killed, a tablet moved, a full restart; vectors on an in-process cluster; "
          f"the graph {'in full' if full else CLUSTER_CUT}; at " + card, flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as d:
        cl = serve_cluster("cuda", d, V, Q, **({} if full else CLUSTER_CUT),
                           log=lambda m: print("    " + m, flush=True))
    if min(n for k, n in cl["launches"].items() if k != "member_sweep") < 1:  # K1: pairs
        raise AssertionError(f"(11) a kernel did not launch: {cl['launches']}")
    bad = {k: n for k, n in sweep_shapes_equal(cl["sweep_shapes"]).items() if n}
    if bad:
        raise AssertionError(f"(11) K1 != plain at shapes (n, pa, pb): {bad}")
    print(f"    K1 launches {cl['launches']['member_sweep']}, equal to plain at every shape "
          f"(n, pa, pb) it took: {sorted(cl.pop('sweep_shapes'))}", flush=True)
    served11 = served_kernels(cl.pop("captured"))
    for site, r in served11.items():
        print(f"    {site} (phase 11 inputs): equal to plain; {_fmt(r)}", flush=True)
    print("    [11] " + json.dumps(cl), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)
    return cl


# ---------------------------------------------------------------------------
# GraphQL over the HTTP front (phase 12)
# ---------------------------------------------------------------------------

# the SDL phase 12 uploads, mapped onto the predicates of phases 4 and 7
GRAPHQL_SDL = (
    'type Node { id: ID! child: [Node] @dgraph(pred: "child") '
    'tag: String @search(by: [exact]) @dgraph(pred: "tag") }\n'
    'type Doc { id: ID! name: String @search(by: [exact]) @dgraph(pred: "name")\n'
    '  emb: [Float!] @embedding @search(by: ["hnsw(metric: euclidean)"]) @dgraph(pred: "emb")\n'
    '  emb_small: [Float!] @embedding @search(by: ["hnsw(metric: euclidean)"]) '
    '@dgraph(pred: "emb_small") }\n')
# query (b) in GraphQL: the level-2 ids and their hot children
LEVELS_B = 'child { child { id child(filter: {tag: {eq: "hot"}}) { id } } }'
GQL_B = 'query { queryNode(filter: {id: ["0x1"]}) { %s } }' % LEVELS_B
GQL_GET_B = 'query { getNode(id: "0x1") { %s } }' % LEVELS_B
SUB_B = 'subscription { queryNode(filter: {id: ["0x1"]}) { %s } }' % LEVELS_B
GQL_FLIP = ('mutation { updateNode(input: {filter: {id: ["%s"]}, set: {tag: "hot"}}) '
            '{ numUids } }')
GQL_SIMILAR = ('query ($v: [Float!]!) { querySimilarDocByEmbedding(by: %s, topK: %d, '
               'vector: $v) { id name vector_distance } }')
GQL_SIMILAR_ID = ('query { querySimilarDocById(by: %s, topK: %d, id: "%s") '
                  '{ id name vector_distance } }')
DISPATCH_ENTRIES = ("run_rows_vs_one_ragged", "run_rows_vs_one", "run_chain", "run_pairs")


def graphql_levels(root):
    """{level-2 uid: [its hot children]} of a (12b) answer's root object."""
    return {int(o["id"], 16): [int(x["id"], 16) for x in o.get("child") or []]
            for l1 in root.get("child") or [] for o in l1.get("child") or []}


def expected_b(g, hot, extra=()):
    """Query (b)'s numpy answer with the uids in `hot` tagged hot and the
    (level-2, child) edges in `extra` added (phase 9 commits one)."""
    want = expected(g, "b", hot)
    hot = set(hot)
    for l2, new in extra:
        if new in hot and new not in want[l2]:
            want[l2] = sorted(want[l2] + [new])
    return want


class _Entries:
    """Counts, per dispatcher entry, the kernel calls `count()` sees made
    under it (the outermost entry of a nesting takes them)."""

    def __init__(self, count):
        import threading

        self.count, self.by, self.local = count, {}, threading.local()

    def __enter__(self):
        from dgraph_tpu_torch.query import dispatch

        self.d = dispatch.DISPATCHER
        for name in DISPATCH_ENTRIES:
            real = getattr(self.d, name)

            def entry(*a, _real=real, _name=name, **kw):
                if getattr(self.local, "inside", False):
                    return _real(*a, **kw)
                self.local.inside, c0 = True, self.count()
                try:
                    return _real(*a, **kw)
                finally:
                    self.local.inside = False
                    self.by[_name] = self.by.get(_name, 0) + self.count() - c0

            setattr(self.d, name, entry)
        return self

    def __exit__(self, *exc):
        for name in DISPATCH_ENTRIES:
            delattr(self.d, name)


class _WsClient:
    """A graphql-transport-ws client on a socket: masked frames out,
    `api/ws.py`'s reader for the server's frames."""

    def __init__(self, port, timeout=600.0):
        import base64
        import os
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET /graphql HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
            "Sec-WebSocket-Protocol: graphql-transport-ws\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            got = self.sock.recv(1)
            if not got:
                raise AssertionError("(12e): the websocket closed during its handshake")
            head += got
        if b" 101 " not in head.split(b"\r\n", 1)[0]:
            raise AssertionError(f"(12e): websocket handshake answered {head[:80]!r}")

    def send(self, obj):
        import os
        import struct

        payload = json.dumps(obj).encode()
        n, mask = len(payload), os.urandom(4)
        if n < 126:
            hdr = bytes([0x81, 0x80 | n])
        elif n < 1 << 16:
            hdr = bytes([0x81, 0x80 | 126]) + struct.pack(">H", n)
        else:
            hdr = bytes([0x81, 0x80 | 127]) + struct.pack(">Q", n)
        self.sock.sendall(hdr + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))

    def recv(self, timeout):
        """The next message, or None if none comes within `timeout` s."""
        import socket

        from dgraph_tpu_torch.api import ws

        self.sock.settimeout(timeout)
        try:
            got = ws.recv_frame(self.sock)
        except socket.timeout:
            return None
        finally:
            self.sock.settimeout(None)
        if got is None:
            raise AssertionError("(12e): the websocket closed")
        return json.loads(got[1])

    def close(self):
        self.send({"id": "b", "type": "complete"})
        self.sock.close()


def serve_graphql(gserver, g, vserver, small_V, Qs, named, exact, extra=(), k=10, n_reads=16,
                  n_flips=5, type_chunk=50_000, reps=3, min_recall=0.90, log=print):
    """Phase 12: GraphQL over the port's HTTP front, on the graph server
    `gserver` (holding the graph g, with the (level-2, child) edges in
    `extra`) and the vector server `vserver` (phase 7's: `emb` holds every
    row of the corpus, `emb_small` the rows `small_V`; `named` is a uid
    whose `emb` is in the store; `exact` is the float64 top-k of Qs over
    the whole corpus). Every request goes through an `HTTPServer` on
    localhost and the port's `client.py` (the websocket through a socket),
    on the forced device path. (12a) `dgraph.type` "Node" on every node,
    the SDL uploaded to both servers, nothing rebuilt; (12b) query (b) as
    `queryNode` and `getNode` (setop_rows), its warm median beside (b) as DQL on
    the same front; (12c) an aggregate and a page; (12d) n_reads
    `querySimilarDocByEmbedding` reads by `emb_small` (brute: KV1) and by
    `emb` (IVF: KV2, KV1) and one `querySimilarDocById`; (12e) n_flips
    tag flips by `updateNode` alone, then n_flips more under a websocket
    subscription to (b), then one commit that changes no answer. Every
    answer is held to numpy or to the exact top-k. The kernel counts are
    zeroed at the start and read at the end; the kernels' inputs are
    kept per shape. Returns the measurements; raises when a check fails."""
    import torch

    from dgraph_tpu_torch.api.http_server import HTTPServer
    from dgraph_tpu_torch.client import DgraphClient
    from dgraph_tpu_torch.ops import ivf_scan, member_sweep, vector_topk

    on_card = gserver.device.type == "cuda"

    def setops():
        return setops_count(on_card)

    setops0 = setops()

    def launches():
        if on_card:
            got = {"member_sweep": member_sweep.LAUNCHES, "vector_topk": vector_topk.LAUNCHES,
                   "ivf_slab_scan": ivf_scan.LAUNCHES}
        else:
            got = {"member_sweep": member_sweep.PLAIN_CALLS,
                   "vector_topk": vector_topk.PLAIN_CALLS, "ivf_slab_scan": ivf_scan.PLAIN_CALLS}
        return {**got, "setop_rows": setops() - setops0}

    def gql(client, q, variables=None):
        got = client.graphql(q, variables)
        if got.get("errors") or got.get("data") is None:
            raise AssertionError(f"GraphQL errors for {q[:80]!r}: {got.get('errors')}")
        return got["data"]

    def ms_of(fn):
        t = time.perf_counter()
        got = fn()
        return (time.perf_counter() - t) * 1e3, got

    hot = {int(u) for u in g["hot"]}
    extra = [(int(a), int(b)) for a, b in extra]
    nodes = np.unique(np.concatenate([[1], g["l1"], g["l2"], g["pool"]]).astype(np.uint64))
    out = {"step_s": {}, "nodes": len(nodes)}
    t_lap = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["step_s"][name] = now - t_lap[0]
        t_lap[0] = now

    front = {"graph": HTTPServer(gserver, port=0).start(),
             "vectors": HTTPServer(vserver, port=0).start()}
    try:
        gc = DgraphClient(f"http://127.0.0.1:{front['graph'].port}", timeout=1800)
        vc = DgraphClient(f"http://127.0.0.1:{front['vectors'].port}", timeout=1800)
        for c, server in ((gc, gserver), (vc, vserver)):
            if server.acl is not None:  # phase 9 turned ACL on: a guardian's token
                c.login("groot", "password")
        with forced_device(), _Capture(member_sweep) as cap, _VecCapture() as vcap, \
                _Entries(setops) as entries:
            member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
            vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
            ivf_scan.LAUNCHES = ivf_scan.PLAIN_CALLS = 0

            # (12a) types, then the SDL on both servers; nothing rebuilt
            lines = [f'<{hex(int(u))}> <dgraph.type> "Node" .' for u in nodes]
            for s in range(0, len(lines), type_chunk):
                gc.txn().mutate(set_rdf="\n".join(lines[s : s + type_chunk]), commit_now=True)
            lap("types")
            reindexed = []

            def before(server):
                return ({p: tuple(server.schema.get(p).tokenizers)
                         for p in ("tag", "name") if server.schema.get(p) is not None},
                        {p: (idx, len(idx)) for p, idx in server.vector_indexes.items()})

            kept = {id(s): before(s) for s in (gserver, vserver)}
            for server in (gserver, vserver):
                server._reindex = lambda su, _r=server._reindex: reindexed.append(
                    su.predicate) or _r(su)
            try:
                gc.set_graphql_schema(GRAPHQL_SDL)
                vc.set_graphql_schema(GRAPHQL_SDL)
            finally:
                for server in (gserver, vserver):
                    del server._reindex
            lap("sdl")
            for server in (gserver, vserver):
                toks, idx = kept[id(server)]
                now_toks, now_idx = before(server)
                gone = {p: v for p, v in idx.items()
                        if p not in now_idx or now_idx[p][0] is not v[0] or len(v[0]) != v[1]}
                if reindexed or {p: now_toks.get(p) for p in toks} != toks or gone:
                    raise AssertionError(f"(12a): the SDL upload rebuilt {reindexed}, tokenizers "
                                         f"{toks} -> {now_toks}, vector indexes {gone}")
            if gserver.graphql is None or vserver.graphql is None:
                raise AssertionError("(12a): no GraphQL schema after the upload")
            out["types"] = {"nodes": len(nodes), "chunks": -(-len(lines) // type_chunk),
                            "s": out["step_s"]["types"], "sdl_s": out["step_s"]["sdl"],
                            "kept": {p: v[1] for p, v in kept[id(vserver)][1].items()}}
            log(f"(12a) dgraph.type on {len(nodes)} nodes through /mutate in "
                f"{out['types']['s']:.3f}s; SDL uploaded to both fronts in "
                f"{out['types']['sdl_s']:.3f}s: no reindex, tokenizers kept, vector "
                f"indexes kept {out['types']['kept']}")

            # (12b) query (b) through GraphQL and DQL on the same front
            want = expected_b(g, hot, extra)
            c0, e0 = setops(), dict(entries.by)
            got = gql(gc, GQL_B)["queryNode"]
            out["b_setops"] = setops() - c0
            out["b_entries"] = {n: v - e0.get(n, 0) for n, v in entries.by.items()
                                if v - e0.get(n, 0)}
            if len(got) != 1 or graphql_levels(got[0]) != want:
                raise AssertionError("(12b): queryNode's level 3 != numpy")
            if out["b_setops"] < 1:
                raise AssertionError("(12b): setop_rows did not launch")
            if graphql_levels(gql(gc, GQL_GET_B)["getNode"]) != want:
                raise AssertionError("(12b): getNode's level 3 != numpy")
            if extract("b", gc.query(QUERIES["b"])["data"]) != want:
                raise AssertionError("(12b): DQL (b) over HTTP != numpy")
            timing = {"graphql": [], "get": [], "dql": []}
            for _ in range(reps):
                timing["graphql"].append(ms_of(lambda: gql(gc, GQL_B))[0])
                timing["get"].append(ms_of(lambda: gql(gc, GQL_GET_B))[0])
                timing["dql"].append(ms_of(lambda: gc.query(QUERIES["b"]))[0])
            out["b_ms"] = {n: float(np.median(v)) for n, v in timing.items()}
            if on_card:
                log("(12b) one GraphQL (b) over HTTP, profiled:")
                out["b_trace"] = profile_query(gserver, lambda: gql(gc, GQL_B), reps=1,
                                               log=lambda m: log("  " + m))
            lap("b")
            log(f"(12b) queryNode and getNode (b) == numpy == DQL (b) over HTTP; setop_rows "
                f"{out['b_setops']} launches, by dispatcher entry {out['b_entries']}; warm "
                f"medians ms {out['b_ms']}")

            # (12c) an aggregate and a page
            count = gql(gc, 'query { aggregateNode(filter: {tag: {eq: "hot"}}) { count } }')
            off = len(nodes) // 2
            page = gql(gc, f"query {{ queryNode(first: 10, offset: {off}) {{ id }} }}")
            page = [int(o["id"], 16) for o in page["queryNode"]]
            if count["aggregateNode"]["count"] != len(hot):
                raise AssertionError(f"(12c): aggregateNode count {count} != {len(hot)}")
            if page != nodes[off : off + 10].tolist():
                raise AssertionError(f"(12c): the page at offset {off} != numpy")
            out["aggregate"] = {"count": len(hot), "page_offset": off}
            lap("c")
            log(f"(12c) aggregateNode(hot) count {len(hot)} and the page of 10 at offset {off} "
                "== numpy")

            # (12d) similarity: brute (emb_small) and IVF (emb)
            Q = Qs[:n_reads]
            ex_i, _ = exact
            sm_i, sm_d = exact_topk(small_V, Q, k)
            sims = {"emb_small": [], "emb": []}
            for by, rows in sims.items():
                for q in Q:
                    ms, got = ms_of(lambda: gql(vc, GQL_SIMILAR % (by, k),
                                                {"v": q.tolist()})["querySimilarDocByEmbedding"])
                    rows.append((ms, got))
            stored = {}  # uid -> its `emb` / `emb_small` in the store, as GraphQL reads it

            def distances(by, q, got):
                """Each row's vector_distance: the float64 distance where
                the store holds the row's vector, null where it does not."""
                uids = [int(o["id"], 16) for o in got]
                ask = [u for u in uids if (by, u) not in stored]
                if ask:
                    res = vc.query(f'{{ q(func: uid({", ".join(map(hex, ask))})) '
                                   f'{{ uid {by} }} }}')["data"]["q"]
                    vals = {int(o["uid"], 16): o.get(by) for o in res}
                    for u in ask:
                        stored[by, u] = vals.get(u)
                n_set = 0
                for o, u in zip(got, uids):
                    v = stored[by, u]
                    d = o["vector_distance"]
                    if v is None:
                        if d is not None:
                            raise AssertionError(f"(12d) {by}: a distance for {u:#x}, whose "
                                                 "vector the store does not hold")
                        continue
                    want_d = float(np.sqrt(((np.asarray(v, np.float64)
                                             - q.astype(np.float64)) ** 2).sum()))
                    if d is None or abs(d - want_d) > 1e-9 * (1 + want_d):
                        raise AssertionError(f"(12d) {by}: {u:#x} at {d} != {want_d}")
                    n_set += 1
                return n_set

            exact_ids, with_d = 0, {"emb_small": 0, "emb": 0}
            for i, (ms, got) in enumerate(sims["emb_small"]):
                r = np.asarray([int(o["id"], 16) for o in got], np.int64) - 1
                if not near_equal(small_V, Q[i : i + 1], [r], sm_d[i : i + 1]):
                    raise AssertionError(f"(12d) emb_small read {i} != exact top-k beyond "
                                         "near-ties")
                exact_ids += int(np.array_equal(np.sort(r), np.sort(sm_i[i])))
                with_d["emb_small"] += distances("emb_small", Q[i], got)
            recall = []
            for i, (ms, got) in enumerate(sims["emb"]):
                r = {int(o["id"], 16) - 1 for o in got}
                recall.append(len(r & set(ex_i[i].tolist())) / k)
                with_d["emb"] += distances("emb", Q[i], got)
            out["recall"] = float(np.mean(recall))
            if out["recall"] < min_recall:
                raise AssertionError(f"(12d) emb: recall@{k} {out['recall']} < {min_recall}")
            own = vc.query(f"{{ q(func: uid({hex(named)})) {{ emb }} }}")["data"]["q"][0]["emb"]
            by_id = gql(vc, GQL_SIMILAR_ID % ("emb", k, hex(named)))["querySimilarDocById"]
            by_vec = gql(vc, GQL_SIMILAR % ("emb", k), {"v": own})["querySimilarDocByEmbedding"]
            me = [o for o in by_id if int(o["id"], 16) == named]
            if by_id != by_vec or len(me) != 1 or me[0]["vector_distance"] != 0.0 \
                    or me[0]["name"] != f"v{named}":
                raise AssertionError(f"(12d) querySimilarDocById({hex(named)}) != the search by "
                                     f"its own vector, or lacks the node itself at 0: {me}")
            out["similar"] = {
                by: {"median_ms": float(np.median([ms for ms, _ in rows])),
                     "first_ms": rows[0][0], "reads": len(rows),
                     "rows_with_distance": with_d[by]}
                for by, rows in sims.items()}
            out["similar"]["emb_small"]["exact_id_lists"] = exact_ids
            lap("d")
            log(f"(12d) {n_reads} querySimilarDocByEmbedding reads a tier: emb_small (brute) == "
                f"exact top-k outside near-ties ({exact_ids}/{n_reads} id lists identical), emb "
                f"(IVF) recall@{k} {out['recall']:.4f}; vector_distance the float64 distance on "
                f"every row whose vector the store holds ({with_d}), null elsewhere; "
                f"querySimilarDocById({hex(named)}) == the search by its own vector; "
                f"{json.dumps(out['similar'])}")

            # (12e) tag flips by updateNode, alone and under a subscription
            l3 = list(dict.fromkeys(int(u) for u in g["l3"]))
            flips = [u for u in l3 if u not in hot][: 2 * n_flips]
            hot_now = set(hot)

            def flip(u):
                c0 = setops()
                ms, got = ms_of(lambda: gql(gc, GQL_FLIP % hex(u)))
                if got["updateNode"]["numUids"] != 1:
                    raise AssertionError(f"(12e): updateNode of {u:#x} answered {got}")
                hot_now.add(u)
                return ms, setops() - c0

            def read_b(what):
                if graphql_levels(gql(gc, GQL_B)["queryNode"][0]) != expected_b(g, hot_now,
                                                                                 extra):
                    raise AssertionError(f"(12e) {what}: (b) != numpy")

            alone = []
            for u in flips[:n_flips]:
                alone.append(flip(u))
                read_b(f"after flipping {u:#x}")
            ws = _WsClient(front["graph"].port)
            try:
                ws.send({"type": "connection_init"})
                if (ws.recv(60) or {}).get("type") != "connection_ack":
                    raise AssertionError("(12e): no connection_ack")
                ws.send({"id": "b", "type": "subscribe", "payload": {"query": SUB_B}})

                def push(what):
                    got = ws.recv(600)
                    if got is None or got.get("type") != "next" or got.get("id") != "b":
                        raise AssertionError(f"(12e) {what}: no push, got {got}")
                    levels = graphql_levels(got["payload"]["data"]["queryNode"][0])
                    if levels != expected_b(g, hot_now, extra):
                        raise AssertionError(f"(12e) {what}: the push != numpy")

                push("on subscribing")
                subscribed = []
                for u in flips[n_flips:]:
                    subscribed.append(flip(u))
                    push(f"after flipping {u:#x}")
                    read_b(f"after flipping {u:#x} (subscribed)")
                same = flips[0]  # hot already: the commit changes no answer
                c0 = setops()
                ms_same, got = ms_of(lambda: gql(gc, GQL_FLIP % hex(same)))
                rerun = setops() - c0
                quiet = ws.recv(2.0)
                if quiet is not None:
                    raise AssertionError(f"(12e): a push for a commit that changed no answer: "
                                         f"{str(quiet)[:200]}")
            finally:
                ws.close()
            out["commits"] = {
                "alone_p50_ms": float(np.median([ms for ms, _ in alone])),
                "subscribed_p50_ms": float(np.median([ms for ms, _ in subscribed])),
                "alone_ms": [ms for ms, _ in alone], "subscribed_ms": [ms for ms, _ in subscribed],
                "setops_per_commit_alone": [n for _, n in alone],
                "setops_per_commit_subscribed": [n for _, n in subscribed],
                "unchanged": {"ms": ms_same, "setops": rerun, "pushed": False}}
            lap("e")
            log(f"(12e) {n_flips} updateNode flips alone, then {n_flips} under a "
                f"graphql-transport-ws subscription to (b): every push and every (b) after a "
                f"flip == numpy; a commit that changed no answer re-ran the subscription "
                f"({rerun} setop_rows launches) and pushed nothing; {json.dumps(out['commits'])}")
        out["launches"] = launches()
        out["entries"] = dict(entries.by)
        out["sweep_shapes"] = cap.by_shape
        out["captured"] = (vcap.topk, vcap.slabs)
    finally:
        for srv in front.values():
            srv.stop()
    return out


def graphql_phase(gserver, g, vserver, small_V, Qs, named, exact, extra, card, t_start):
    """Phase 12, then K1 against its plain version at every shape it took
    and KV1 and KV2 at every site; prints as it goes. Returns the
    measurements."""
    print("[12] GraphQL on the card over the HTTP front and a websocket: types, SDL, "
          "filtered reads (K1), aggregates, similarity (KV1, KV2), flips under a "
          "subscription, on phase 4's and phase 7's servers; at " + card, flush=True)
    gq = serve_graphql(gserver, g, vserver, small_V, Qs, named, exact, extra,
                       log=lambda m: print("    " + m, flush=True))
    if min(n for k, n in gq["launches"].items() if k != "member_sweep") < 1:  # K1: pairs
        raise AssertionError(f"(12) a kernel did not launch: {gq['launches']}")
    bad = {k: n for k, n in sweep_shapes_equal(gq["sweep_shapes"]).items() if n}
    if bad:
        raise AssertionError(f"(12) K1 != plain at shapes (n, pa, pb): {bad}")
    print(f"    K1 launches {gq['launches']['member_sweep']}, equal to plain at every shape "
          f"(n, pa, pb) it took: {sorted(gq.pop('sweep_shapes'))}", flush=True)
    served12 = served_kernels(gq.pop("captured"))
    for site, r in served12.items():
        print(f"    {site} (phase 12 inputs): equal to plain; {_fmt(r)}", flush=True)
    print("    [12] " + json.dumps(gq), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)
    return gq


def graphql_data(device="cuda", fanout=100, pool=200_000, n=1_000_000, d=768, n_named=10_000,
                 n_small=100_000, ivf_threshold=None, nq=16, k=10, log=print):
    """`--graphql-only`'s data: phase 4's graph through the native bulk
    loader and phase 7's vectors (`load_vectors`), in Servers of their
    own on `device`. Returns serve_graphql's arguments."""
    import tempfile

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader

    g = make_graph(fanout, pool)
    gserver = Server(device=device)
    gserver.slow_query_ms = float("inf")
    gserver.alter("child: [uid] .\ntag: string @index(exact) .")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graphql_") as d_:
        ld = ParallelBulkLoader(gserver, workdir=d_)
        if not ld._native_ok():
            raise AssertionError("the graph's bulk load would not take the native reduce")
        ld.load_texts(list(nquad_chunks(g)))
    log(f"graph bulk-loaded (native reduce) in {time.perf_counter() - t0:.3f}s")
    vserver, V, Qs, _ = load_vectors(device, n, d, n_named, n_small, ivf_threshold, log=log)
    return {"gserver": gserver, "g": g, "vserver": vserver, "small_V": V[:n_small].copy(),
            "Qs": Qs, "named": n, "exact": exact_topk(V, Qs[:nq], k)}  # uid n has a name


# ---------------------------------------------------------------------------
# The command line and the device mesh (phase 13)
# ---------------------------------------------------------------------------

# shards of the one card the mesh of (13b) puts the data plane on
MESH_SHARDS = 4
# a shared operand of at least this many uids takes the mesh in (13b):
# query (b)'s filter set holds pool / 100 of them
MESH_MIN_B = 1024


def cli_argv(device, *args):
    """`python -m dgraph_tpu_torch ...` on `device`: the card is the
    command line's default, so only the host is named."""
    dev = ["--device", "cpu"] if device == "cpu" else []
    return [sys.executable, "-m", "dgraph_tpu_torch", *dev, *args]


def _cli_env():
    import os

    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"  # alpha prints its ports as it binds them
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Alpha:
    """`python -m dgraph_tpu_torch alpha -p <dir> --port 0` as a child
    process: the ports it prints, and the process killed on exit."""

    def __init__(self, device, pdir, grpc=True):
        self.argv = cli_argv(device, "alpha", "-p", pdir, "--port", "0",
                             "--grpc_port", "0" if grpc else "-1")
        self.grpc = grpc

    def __enter__(self):
        # a session of its own: alpha's forked apply-pool workers carry its
        # command line and would outlive a kill of alpha alone
        self.proc = subprocess.Popen(self.argv, env=_cli_env(), stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, start_new_session=True)
        self.http = self.grpc_port = None
        try:
            while self.http is None or (self.grpc and self.grpc_port is None):
                line = self.proc.stdout.readline()
                if not line:
                    raise AssertionError(f"alpha exited ({self.proc.wait()}): "
                                         f"{self.proc.stderr.read()[-3000:]}")
                if line.startswith("alpha listening on http://"):
                    self.http = int(line.rsplit(":", 1)[1])
                elif line.startswith("alpha gRPC (api.Dgraph) on "):
                    self.grpc_port = int(line.rsplit(":", 1)[1])
        except BaseException:
            self.__exit__()
            raise
        return self

    def __exit__(self, *exc):
        import os
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.proc.stderr.close()


def _post(port, path, body, ctype="application/dql", timeout=300):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body.encode(),
                                 headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get(port, path, timeout=60):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.read()


def _http_data(body):
    """The `data` bytes of a query response: the front splices the
    engine's encoded answer between `{"data":` and the extensions."""
    head = b'{"data":'
    if not body.startswith(head):
        raise AssertionError(f"not a query response: {body[:200]!r}")
    return body[len(head):body.rindex(b',"extensions":')]


def compute_apps():
    """[(pid, used memory)] of the card's compute processes (nvidia-smi)."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return [tuple(x.strip() for x in r.split(",")) for r in rows if r.strip()]


def protos_generated():
    """gRPC is served from the committed `api_pb2.py`: the package runs
    protoc only when it is older than `api.proto`, and the card machine
    has no protoc."""
    import os

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dgraph_tpu_torch", "protos")
    gen, proto = os.path.join(d, "api_pb2.py"), os.path.join(d, "api.proto")
    if os.path.getmtime(gen) < os.path.getmtime(proto):
        raise AssertionError("api_pb2.py is older than api.proto, so alpha would run protoc")


def serve_cli(device, workdir, g, answers, texts=None, grpc=True, log=print):
    """(13a): phase 4's graph through `python -m dgraph_tpu_torch bulk`
    into a fresh data dir, then `alpha` on it (port 0, on `device`: the
    card by default) answers (a)-(d) over HTTP and, with `grpc`, over
    gRPC, each answer equal to phase 4's (`answers`) byte for byte. On the
    card, alpha's use of it is read from outside the process: nvidia-smi's
    compute processes, its /proc maps and the dispatcher's set-op counter
    on the metrics route. Returns the measurements."""
    import os

    import torch

    from dgraph_tpu_torch.protos import load_api_pb2

    on_card = torch.device(device).type == "cuda"
    texts = list(nquad_chunks(g)) if texts is None else texts
    rdf, schema, pdir = (os.path.join(workdir, n) for n in ("graph.rdf", "schema.txt", "p"))
    with open(rdf, "w") as f:
        for t in texts:
            f.write(t + "\n")
    with open(schema, "w") as f:
        f.write("child: [uid] .\ntag: string @index(exact) .\n")
    out = {}
    t0 = time.perf_counter()
    bulk = subprocess.run(cli_argv(device, "bulk", "-p", pdir, "--schema", schema, rdf),
                          env=_cli_env(), capture_output=True, text=True, timeout=600)
    out["bulk_s"] = time.perf_counter() - t0
    if bulk.returncode or "bulk loaded" not in bulk.stdout:
        raise AssertionError(f"bulk failed ({bulk.returncode}): {bulk.stderr[-3000:]}")
    out["bulk"] = bulk.stdout.strip().splitlines()[-1]
    log(f"bulk: {out['bulk']} ({out['bulk_s']:.3f}s with the process)")
    if grpc:
        protos_generated()
    before = compute_apps() if on_card else []
    t0 = time.perf_counter()
    with Alpha(device, pdir, grpc) as alpha:
        health = json.loads(_get(alpha.http, "/health"))
        out["start_s"] = time.perf_counter() - t0
        if health[0]["status"] != "healthy":
            raise AssertionError(f"alpha not healthy: {health}")
        log(f"alpha pid {alpha.proc.pid} served HTTP on {alpha.http}"
            + (f", gRPC on {alpha.grpc_port}" if grpc else "")
            + f", healthy {out['start_s']:.3f}s after it started")
        sends = {"http": lambda q: _http_data(_post(alpha.http, "/query", q))}
        stub = None
        if grpc:
            from dgraph_tpu_torch.client_grpc import DgraphClientStub

            pb = load_api_pb2()
            stub = DgraphClientStub(f"127.0.0.1:{alpha.grpc_port}")
            sends["grpc"] = lambda q: stub.query(pb.Request(query=q, read_only=True)).json
        try:
            out["ms"] = {}
            for transport, send in sends.items():
                for name, q in QUERIES.items():
                    ms = []
                    for _ in range(2):  # cold, then warm
                        t = time.perf_counter()
                        got = send(q)
                        ms.append((time.perf_counter() - t) * 1e3)
                        if got != answers[name]:
                            raise AssertionError(f"({name}) over {transport} != phase 4's "
                                                 f"answer ({len(got)} vs {len(answers[name])} "
                                                 "bytes)")
                    out["ms"][f"{transport} {name}"] = {"cold": ms[0], "warm": ms[1]}
        finally:
            if stub is not None:
                stub.close()
        metrics = _get(alpha.http, "/debug/prometheus_metrics").decode()
        pairs = [float(line.split()[1]) for line in metrics.splitlines()
                 if line.split(" ")[0].endswith("_setop_pairs_total")]
        out["setop_pairs_total"] = pairs[0] if pairs else 0.0
        if out["setop_pairs_total"] <= 0:
            raise AssertionError("alpha's metrics route shows no set-op pair dispatched")
        if on_card:
            apps = compute_apps()
            with open(f"/proc/{alpha.proc.pid}/maps") as f:
                maps_cuda = "libcuda" in f.read()
            pid_listed = any(a[0] == str(alpha.proc.pid) for a in apps)
            out["card"] = {"apps_before": before, "apps": apps, "pid": alpha.proc.pid,
                           "pid_listed": pid_listed, "maps_libcuda": maps_cuda}
            # nvidia-smi may list a process under another pid namespace:
            # then a compute process more than before, with alpha the one
            # child that maps the CUDA driver
            if not maps_cuda or not (pid_listed or len(apps) > len(before)):
                raise AssertionError(f"alpha on the card? {out['card']}")
    return out


def corpus_centers(d=768, seed=1):
    """make_corpus's 256 cluster centers (its first draw)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((256, d)).astype(np.float32) * 4.0


def _mesh_rows(g):
    """(b)'s level-3 rows in the low hi-32 segment as padded sorted u32
    rows (the dispatcher's form), and their lengths."""
    rows = [np.unique(r[r < SEG]).astype(np.uint32)
            for r in g["l3"].reshape(len(g["l2"]), g["f"])]
    pa = max(8, 1 << (max(len(r) for r in rows) - 1).bit_length())
    A = np.full((len(rows), pa), U32, np.uint32)
    LA = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        A[i, : len(r)], LA[i] = r, len(r)
    return A, LA


def _giant_b(g, n_min=1 << 22, seed=11):
    """A sorted u32 operand of at least n_min uids: every third pool uid
    of the low segment and random others."""
    rng = np.random.default_rng(seed)
    low = g["pool"][g["pool"] < SEG][::3].astype(np.uint32)
    b = np.unique(np.concatenate([low, rng.integers(0, U32, n_min + (n_min >> 4),
                                                    dtype=np.uint32)]))
    if len(b) < n_min:
        raise AssertionError(f"giant operand of {len(b)} uids")
    return b


def _timed(on_card, fn, reps=5):
    return _events_ms(fn, reps) if on_card else None


def mesh_functions(device, g, V, Q, exact, X, log=print):
    """(13b), the mesh functions on MESH_SHARDS shards of `device`, each
    against its plain version (the same function on one device, without
    the mesh) and the one-device mesh's answer, with times, the byte (or
    operation) bound and the library call's time on the card. Returns
    {function: result}."""
    import torch

    from dgraph_tpu_torch.ops import setops, vector_topk
    from dgraph_tpu_torch.parallel import mesh as pmesh

    on_card = torch.device(device).type == "cuda"
    mesh = pmesh.make_mesh(device=device)
    one = pmesh.make_mesh(1, device=device)
    dev = mesh.devices[0]
    res = {}

    def row(name, route, shape, nbytes, ops=0, **kw):
        b, by = _bound(nbytes, ops)
        res[name] = {"route": route, "shape": shape, "bound_ms": b, "bound_by": by, **kw}
        log(f"{name} {shape} [{route}]: " + ", ".join(
            f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in res[name].items() if k not in ("route", "shape")))

    # membership: (b)'s level-3 rows against a giant operand
    A, LA = _mesh_rows(g)
    b = _giant_b(g)
    tile = -(-len(b) // mesh.size)
    pb = mesh.size * max(8, 1 << (tile - 1).bit_length())
    Bd = setops.to_device(setops.pad_sorted(b, pb), dev)
    Ad, LAd = setops.to_device(A, dev), torch.from_numpy(LA).to(dev)
    Bs = pmesh.shard(mesh, Bd)
    got = pmesh.sharded_rows_membership(mesh, Ad, LAd, Bs, len(b))
    plain = lambda: setops.membership(Ad, LAd, Bd, len(b))  # noqa: E731
    want = np.isin(A, b) & (np.arange(A.shape[1])[None, :] < LA[:, None])
    for what, m in (("plain", plain()), ("one device",
                                        pmesh.sharded_rows_membership(one, Ad, LAd, Bd, len(b)))):
        if not torch.equal(got, m):
            raise AssertionError(f"sharded_rows_membership != {what}")
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("sharded_rows_membership != numpy")
    row("sharded_rows_membership", "setops.membership (plain torch) a shard, psum > 0",
        [list(A.shape), len(b), pb], Ad.numel() * 8 + LAd.numel() * 4 + pb * 8 + A.size,
        hits=int(want.sum()), max_abs_err=0.0,
        ms=_timed(on_card, lambda: pmesh.sharded_rows_membership(mesh, Ad, LAd, Bs, len(b))),
        plain_ms=_timed(on_card, plain),
        library_ms=_timed(on_card, lambda: torch.isin(Ad, Bd[: len(b)])), launches=0)

    a = np.unique(A[A != U32])
    pa = mesh.size * max(8, 1 << (-(-len(a) // mesh.size) - 1).bit_length())
    ad = setops.to_device(setops.pad_sorted(a, pa), dev)
    got = pmesh.sharded_membership(mesh, ad, len(a), Bd, len(b))
    plain = lambda: setops.membership(ad, len(a), Bd, len(b))  # noqa: E731
    if not (torch.equal(got, plain())
            and torch.equal(got, pmesh.sharded_membership(one, ad, len(a), Bd, len(b)))
            and np.array_equal(got.cpu().numpy()[: len(a)], np.isin(a, b))):
        raise AssertionError("sharded_membership != plain, one device or numpy")
    row("sharded_membership", "setops.membership (plain torch) a shard, all_gather",
        [pa, len(b)], pa * 8 + pb * 8 + pa, hits=int(got.sum()), max_abs_err=0.0,
        ms=_timed(on_card, lambda: pmesh.sharded_membership(mesh, ad, len(a), Bd, len(b))),
        plain_ms=_timed(on_card, plain),
        library_ms=_timed(on_card, lambda: torch.isin(ad, Bd[: len(b)])), launches=0)
    cnt = int(pmesh.sharded_intersect_count(mesh, ad, len(a), Bd, len(b)))
    if cnt != int(np.isin(a, b).sum()) or cnt != int(
            pmesh.sharded_intersect_count(one, ad, len(a), Bd, len(b))):
        raise AssertionError("sharded_intersect_count != numpy or one device")
    row("sharded_intersect_count", "setops.membership (plain torch) a shard, psum",
        [pa, len(b)], pa * 8 + pb * 8 + 4, count=cnt, max_abs_err=0.0,
        ms=_timed(on_card, lambda: pmesh.sharded_intersect_count(mesh, ad, len(a), Bd, len(b))),
        plain_ms=_timed(on_card, lambda: plain().sum()),
        library_ms=_timed(on_card, lambda: torch.isin(ad, Bd[: len(b)]).sum()), launches=0)
    del Bd, Bs, Ad, LAd, ad

    # top-k: the corpus row-sharded, one query at a time
    k = 10
    Vd = torch.from_numpy(V).to(dev)
    valid = torch.ones(len(V), dtype=torch.bool, device=dev)
    Vs, valids = pmesh.shard(mesh, Vd), pmesh.shard(mesh, valid)
    Qd = torch.from_numpy(Q).to(dev)
    l0 = vector_topk.LAUNCHES
    with _VecCapture() as cap:
        rows = [pmesh.sharded_topk(mesh, Vs, valids, q, k) for q in Qd]
    launches = vector_topk.LAUNCHES - l0

    def plain_topk(q):
        d2 = ((Vd - q[None, :]) ** 2).sum(dim=1)
        return vector_topk.topk_plain(d2[None, :], k, "distance", valid=valid)

    ids = np.stack([r[1].cpu().numpy() for r in rows])
    err = 0.0
    for q, (d, i) in zip(Qd, rows):
        d1, i1 = pmesh.sharded_topk(one, Vd, valid, q, k)
        pd, pi = plain_topk(q)
        for what, (wd, wi) in (("one device", (d1, i1)), ("plain", (pd[0], pi[0]))):
            if not torch.equal(i.long(), wi.long()):
                log(f"sharded_topk ids != {what} (a near-tie?): {i.tolist()} {wi.tolist()}")
            err = max(err, float((d - wd).abs().max()))
    if not near_equal(V, Q, ids, exact[1][: len(Q)]):
        raise AssertionError("sharded_topk != the exact top-k outside near-ties")
    same = int(sum(np.array_equal(i, e) for i, e in zip(ids, exact[0][: len(Q)])))
    q0 = Qd[0]
    row("sharded_topk", "KV1 (vector_topk.cu) a shard on the finished distance, all_gather, KV1",
        [list(V.shape), len(Q), k], V.nbytes + len(V) + Q.shape[1] * 4 + k * 8,
        3 * V.size, exact_id_lists=same, max_abs_err=err,
        ms=_timed(on_card, lambda: pmesh.sharded_topk(mesh, Vs, valids, q0, k)),
        plain_ms=_timed(on_card, lambda: plain_topk(q0)),
        library_ms=_timed(on_card, lambda: torch.topk(torch.cdist(q0[None, :], Vd), k,
                                                      largest=False)),
        launches=launches)
    del Vd, valid, Vs, valids
    captured = (cap.topk, cap.slabs)

    # k-means: one Lloyd step of X from the corpus's own centers (no
    # near-tie in the assignment, so the sums alone differ in their order)
    C = torch.from_numpy(corpus_centers(X.shape[1])).to(dev)
    Xd = torch.from_numpy(X).to(dev)
    vx = torch.ones(len(X), dtype=torch.bool, device=dev)
    Xs, vxs = pmesh.shard(mesh, Xd), pmesh.shard(mesh, vx)
    got = pmesh.sharded_kmeans_step(mesh, Xs, vxs, C)
    want = pmesh.sharded_kmeans_step(one, Xd, vx, C)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"sharded_kmeans_step != one device: {err}")
    row("sharded_kmeans_step", "torch.matmul (f32) + index_add_ a shard, psum",
        [list(X.shape), list(C.shape)], X.nbytes + len(X) + 2 * C.numel() * 4,
        2 * X.shape[0] * C.shape[0] * X.shape[1], max_abs_err=err,
        ms=_timed(on_card, lambda: pmesh.sharded_kmeans_step(mesh, Xs, vxs, C)),
        plain_ms=_timed(on_card, lambda: pmesh.sharded_kmeans_step(one, Xd, vx, C)),
        library_ms=None, launches=0)
    return res, captured


def mesh_main_path(device, g, answers, texts, small_V, Q, min_b=MESH_MIN_B, log=print):
    """(13b), the branches that use the mesh, on MESH_SHARDS shards of
    `device` with the counts zeroed just before: `Server.query` (b) with
    the giant-operand gate at `min_b` uids, first over phase 4's graph
    (its uids span two hi-32 segments, so `_run_rows_sharded` hands the
    rows back to the single-device path; the answer must equal phase 4's)
    and then over the same graph with the pool below 2^32 (the mesh
    answers, equal to the one-device answer and numpy); then
    `similar_to` on a fresh `emb_small` index with `SHARD_VECTORS=1`,
    equal to the exact top-10. Returns the counts and the captured KV1
    inputs."""
    import tempfile

    import torch

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader
    from dgraph_tpu_torch.ops import member_sweep, vector_topk
    from dgraph_tpu_torch.parallel import mesh as pmesh
    from dgraph_tpu_torch.query import dispatch

    def graph_server(texts):
        srv = Server(device=device)
        srv.slow_query_ms = float("inf")
        srv.alter("child: [uid] .\ntag: string @index(exact) .")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
            ParallelBulkLoader(srv, workdir=d).load_texts(texts)
        return srv

    t0 = time.perf_counter()
    g_low = make_graph(g["f"], len(g["pool"]), roots=len(g["l1"]), low=True)
    servers = {"phase 4's graph": (graph_server(texts), g),
               "one segment": (graph_server(list(nquad_chunks(g_low))), g_low)}
    out = {"load_s": time.perf_counter() - t0}
    log(f"two graph servers bulk-loaded in {out['load_s']:.3f}s")
    routed = []
    real = dispatch.SetOpDispatcher._run_rows_sharded

    def run_rows_sharded(self, *a):
        got = real(self, *a)
        routed.append(got is not None)
        return got

    dispatch.SetOpDispatcher._run_rows_sharded = run_rows_sharded
    saved = dispatch._SHARD_MIN_B
    try:
        with forced_device():
            member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
            vector_topk.LAUNCHES = vector_topk.PLAIN_CALLS = 0
            for what, (srv, gg) in servers.items():
                # the two stores hold the same keys, perhaps at the same
                # timestamps: the operand cache must not serve one the
                # other's operand (ROADMAP Queue 3)
                dispatch.DISPATCHER.device_cache.clear()
                dispatch._SHARD_MIN_B = min_b
                del routed[:]
                t = time.perf_counter()
                got = _run_query(srv, QUERIES["b"])
                ms = (time.perf_counter() - t) * 1e3
                entered, took = len(routed), sum(routed)
                dispatch._SHARD_MIN_B = saved
                one = _run_query(srv, QUERIES["b"])
                if extract("b", json.loads(got)) != expected(gg, "b") or got != one:
                    raise AssertionError(f"(b) on {what} through the mesh != the single-device "
                                         "answer or numpy")
                if gg is g and got != answers["b"]:
                    raise AssertionError("(b) through the mesh != phase 4's answer")
                out[what] = {"ms": ms, "entered": entered, "mesh_answered": took}
                log(f"(b) on {what}: {ms:.3f} ms; _run_rows_sharded entered {entered}, "
                    f"answered {took}; equal to the single-device answer, numpy"
                    + (" and phase 4's" if gg is g else ""))
            if out["phase 4's graph"]["mesh_answered"] or not out["phase 4's graph"]["entered"]:
                raise AssertionError("phase 4's (b) should enter the mesh branch and fall through")
            if not out["one segment"]["mesh_answered"]:
                raise AssertionError("the one-segment (b) did not take the mesh")
            del servers
            # similar_to over a row-sharded emb_small
            with knobs(SHARD_VECTORS="1"):
                srv = Server(device=device)
                srv.slow_query_ms = float("inf")
                srv.alter(SMALL_SCHEMA)
                idx = srv.vector_indexes["emb_small"]
                idx.bulk_load(np.arange(1, len(small_V) + 1, dtype=np.uint64), small_V)
                with _VecCapture() as cap:
                    rows = []
                    t = time.perf_counter()
                    for q in Q:
                        data = json.loads(_run_query(
                            srv, '{ v(func: similar_to(emb_small, 10, "%s")) { uid } }'
                            % _vec_text(q)))
                        rows.append(sorted(int(o["uid"], 16) - 1 for o in data["v"]))
                    out["similar_ms"] = (time.perf_counter() - t) * 1e3 / len(Q)
                if idx._mesh is None or idx._mesh.size != MESH_SHARDS:
                    raise AssertionError("the emb_small index did not take the mesh")
            ex_i, ex_d = exact_topk(small_V, Q, 10)
            if not near_equal(small_V, Q, rows, ex_d):
                raise AssertionError("similar_to over the mesh != the exact top-10")
            out["similar_exact"] = int(sum(r == sorted(e) for r, e in zip(rows, ex_i.tolist())))
            out["launches"] = {"member_sweep": member_sweep.LAUNCHES if device != "cpu"
                               else member_sweep.PLAIN_CALLS,
                               "vector_topk": vector_topk.LAUNCHES if device != "cpu"
                               else vector_topk.PLAIN_CALLS}
            log(f"similar_to(emb_small) x {len(Q)} over {MESH_SHARDS} shards: "
                f"{out['similar_ms']:.3f} ms a read, {out['similar_exact']} of {len(Q)} id "
                f"lists exact (any other within near-ties); launches {out['launches']}")
    finally:
        dispatch.SetOpDispatcher._run_rows_sharded = real
        dispatch._SHARD_MIN_B = saved
        dispatch.DISPATCHER.device_cache.clear()  # nor a later phase's stores
    return out, (cap.topk, cap.slabs)


def mesh_data(device="cuda", fanout=100, pool=200_000, log=print):
    """`--mesh-only`'s graph and phase 4's answers to it: the graph
    through the native bulk loader, (a)-(d) answered on the forced device
    path, each held to numpy."""
    import tempfile

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader

    g = make_graph(fanout, pool)
    srv = Server(device=device)
    srv.slow_query_ms = float("inf")
    srv.alter("child: [uid] .\ntag: string @index(exact) .")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        ParallelBulkLoader(srv, workdir=d).load_texts(list(nquad_chunks(g)))
    with forced_device():
        answers = {name: _run_query(srv, q) for name, q in QUERIES.items()}
    for name, got in answers.items():
        if extract(name, json.loads(got)) != expected(g, "a" if name == "a" else "b"):
            raise AssertionError(f"query {name}: != numpy reference")
    log("graph bulk-loaded and (a)-(d) answered, equal to numpy")
    return g, answers


def cli_and_mesh_phase(g, answers, V, Q, exact, small_V, card, t_start):
    """Phase 13 on the card: (13a) the command line, (13b) the mesh."""
    import tempfile

    from dgraph_tpu_torch.parallel import mesh as pmesh

    log = lambda m: print("    " + m, flush=True)  # noqa: E731
    t13 = time.perf_counter()
    print("[13] the command line on the card: bulk, then alpha over HTTP and gRPC; at "
          + card, flush=True)
    texts = list(nquad_chunks(g))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        cli = serve_cli("cuda", d, g, answers, texts, log=log)
    for key, ms in cli["ms"].items():
        log(f"({key.split()[1]}) over {key.split()[0]}: cold {ms['cold']:.3f} ms, warm "
            f"{ms['warm']:.3f} ms; equal to phase 4's answer byte for byte")
    log("[13a] " + json.dumps(cli))
    print(f"[13b] the device mesh on {MESH_SHARDS} shards of cuda:0; at " + card, flush=True)
    pmesh.DEVICES = ["cuda:0"] * MESH_SHARDS
    try:
        fns, cap_fns = mesh_functions("cuda", g, V, Q[:16], exact, small_V, log=log)
        path, cap_path = mesh_main_path("cuda", g, answers, texts, small_V, Q[:16], log=log)
    finally:
        pmesh.DEVICES = None
    served = {}
    for cap in (cap_fns, cap_path):
        for site, r in served_kernels(cap).items():
            served[site] = r
            log(f"{site} (phase 13 inputs): equal to plain; {_fmt(r)}")
    out = {"cli": cli, "mesh": fns, "path": path, "launches": path["launches"],
           "served": served, "s": time.perf_counter() - t13}
    print("    [13] " + json.dumps({"mesh": fns, "path": path}), flush=True)
    print(f"    phase 13 {out['s']:.3f}s; total {time.perf_counter() - t_start:.3f}s",
          flush=True)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="", metavar="QUERIES",
                    help="also profile these queries on the device path, e.g. bcefghi")
    ap.add_argument("--crossover", action="store_true",
                    help="after the build, time KV1's two regimes against its switch, "
                         "and stop")
    ap.add_argument("--ops-only", action="store_true",
                    help="after the build, run phase 10 alone (on rows made anew), and stop")
    ap.add_argument("--graphql-only", action="store_true",
                    help="after the build, bulk-load the graph and the vectors and run "
                         "phase 12 alone, and stop")
    ap.add_argument("--cluster-only", action="store_true",
                    help="after the build, run phase 11 alone on the full graph (on rows "
                         "made anew), and stop")
    ap.add_argument("--mesh-only", action="store_true",
                    help="after the build, run phase 13 alone (the graph, its answers and "
                         "the corpus made anew), and stop")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    from dgraph_tpu_torch.ops import cuda_build, setop_rows
    from dgraph_tpu_torch.x import config

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    secs = cuda_build.build()
    print(f"[2] built {sorted(secs)} in {time.perf_counter() - t0:.3f}s "
          f"(per source {secs})", flush=True)
    if opts.crossover:
        print("[crossover] KV1 device times in ms at " + card + "; 'rule' is the built "
              "kernel", flush=True)
        topk_crossover()
        return 0
    if opts.ops_only:
        V, Q = make_corpus()
        data_in_and_out(V[:100_000].copy(), Q, None, card, t_start)
        return 0
    if opts.graphql_only:
        print("[12] data: the graph through the native bulk loader, the vectors as in "
              "phase 7", flush=True)
        data = graphql_data(log=lambda m: print("    " + m, flush=True))
        graphql_phase(*data.values(), (), card, t_start)
        return 0
    if opts.cluster_only:
        V, Q = make_corpus()
        cluster_phase(V[:1_000].copy(), Q, card, t_start, full=True)
        return 0
    if opts.mesh_only:
        g, answers = mesh_data("cuda", log=lambda m: print("    " + m, flush=True))
        V, Q = make_corpus()
        cli_and_mesh_phase(g, answers, V, Q, exact_topk(V, Q[:16], 10), V[:100_000].copy(),
                           card, t_start)
        return 0

    print("[3] member sweep vs plain (exact), times in ms at " + card, flush=True)
    sweep_edge_cases()
    sweep_grid()
    t0 = time.perf_counter()
    print("[3b] setop_rows (K2 + K3) vs plain (exact), times in ms at " + card, flush=True)
    setop_grid(log=lambda m: print("    " + m, flush=True))
    print(f"    [3b] {time.perf_counter() - t0:.3f}s", flush=True)

    print("[4] serving the fan-out graph on the card", flush=True)
    s = serve("cuda", log=lambda m: print("    " + m, flush=True),
              profile=tuple(c for c in opts.profile if c in QUERIES), keep=True)
    for name, r in s["queries"].items():
        print(f"    query ({name}): device path {r['device_ms']:.3f} ms, host path "
              f"{r['host_ms']:.3f} ms (warm medians), {r['bytes']} bytes; "
              "device == host == numpy", flush=True)
    print(f"    setop_rows launches per query {s['setop_per_query']}, calls by wrapper at "
          f"(m, N, nB, ranges) or (n, pa[, pb]) {s['setop_calls']}, tiles that searched b "
          f"in global memory {s['global_tiles']}; member sweep launches per query "
          f"{s['sweep_per_query']}; dispatcher copies (to the card, back) in bytes "
          f"{s['copies']}", flush=True)
    print(f"    device memory peak {s['peak_bytes']} bytes; DeviceCache "
          f"{s['device_cache']}", flush=True)
    b_calls = s["setop_calls"]["b"]
    if s["setop_per_query"]["b"] != 1 or list(b_calls) != ["intersect_ragged"] \
            or s["sweep_per_query"]["b"]:
        raise AssertionError(f"(b)'s filtered level: want one setop_rows launch (ragged) and "
                             f"no K1, got {s['setop_per_query']['b']} ({b_calls}) and "
                             f"K1 {s['sweep_per_query']['b']}")
    if min(s["setop_per_query"][q] for q in "cd") < 1:
        raise AssertionError(f"setop_rows did not launch in (c) and (d): {s['setop_per_query']}")
    if len(s["setop_calls"]["d"].get("difference_ragged", ())) != 1:
        raise AssertionError(f"(d)'s difference not in one launch: {s['setop_calls']['d']}")
    # a warm (b): the rows go up with their sub-row table (offsets and range
    # ids), b comes from the DeviceCache, and only the kept words come back
    m_b = b_calls["intersect_ragged"][0][0]
    up, down = s["copies"]["b"]["warm"]
    if down > 500_000 or up > 4_087_068 + 4 * (2 * m_b + 1):
        raise AssertionError(f"(b) warm: {up} bytes up (at most {4_087_068 + 4 * (2 * m_b + 1)}),"
                             f" {down} back (at most 500,000)")
    print(f"    (b) warm: {up} bytes up ({m_b} sub-rows), {down} back in reads of "
          f"{s['copies']['b']['fetch_ms']} ms (host clock: the offsets, waiting on the kernel, "
          "then the kept words); (d)'s difference in one launch", flush=True)
    # setop_rows launches of each later path, its count zeroed just before,
    # and the shapes at which it was held against its plain version
    setop_paths, setop_checked = {"4": s["setop_launches"]}, {}
    # the plain-torch programs' (K4-K7, K11) calls of each path and their
    # largest input over all paths
    plain_paths, plain_largest = {"4": s["plain_ops"][0]}, dict(s["plain_ops"][1])

    def setop_counted(path, fn, *a, **kw):
        setop_rows.LAUNCHES = launches = 0
        try:
            with _Capture(setop_rows, SETOP_WRAPPERS) as scap, _PlainOps() as pops:
                got = fn(*a, **kw)
        finally:
            launches = setop_rows.LAUNCHES
            setop_paths[path] = setop_paths.get(path, 0) + launches
        plain_paths[path] = pops.calls
        for name, got_in in pops.largest.items():
            if got_in[0] > plain_largest.get(name, (-1,))[0]:
                plain_largest[name] = got_in
        by_shape = scap.by_shape
        bad = {k: n for k, n in setop_shapes_equal(by_shape).items() if n}
        if bad:
            raise AssertionError(f"({path}) setop_rows != plain at {bad}")
        setop_checked[path] = setop_checked.get(path, 0) + len(by_shape)
        print(f"    ({path}) {fn.__name__}: setop_rows launches {launches}, equal to plain "
              f"at every shape it took: {len(by_shape)} shapes", flush=True)
        del scap, by_shape
        return got
    k1 = setop_counted("4 K1 read", k1_read, "cuda",
                       log=lambda m: print("    " + m, flush=True))

    print("[5] member sweep on the main path's inputs (K1's read)", flush=True)
    A, LA, B, LB = k1["captured"]
    check_sorted(A, LA, B, LB)
    main = measure_sweep(A, LA, B, LB)
    if main["mismatches"]:
        raise AssertionError(f"main-path inputs: kernel != plain: {main}")
    print(f"    {_shape_key((A, LA, B, LB))}: rows sorted as "
          f"uint32; equal; {_fmt(main)}; all-of-B byte time "
          f"{all_of_b_ms(A, LA, B, LB):.6f}; rows {main['regimes']}", flush=True)
    # the dispatcher's route for these rows against setop_rows' fused kernel
    route = k1_route_against_setop_rows(A, LA, B, LB)
    print(f"    routes at {route['shape']}, equal: K1 and its compaction "
          f"{route['k1_compact']['ms']:.6f} ms (device {route['k1_compact']['device_ms']:.6f}); "
          f"setop_rows {route['setop_rows']['ms']:.6f} ms (device "
          f"{route['setop_rows']['device_ms']:.6f})", flush=True)
    del k1["captured"], A, LA, B, LB
    captured4 = s.pop("setop_captured")
    setop_main = setop_served(captured4, log=lambda m: print("    " + m, flush=True))
    setop_checked["4"] = len(captured4)
    del captured4

    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    print("[6] vector kernels vs plain (KV1 bitwise, KV2 within tolerance), times in "
          "ms at " + card, flush=True)
    vector_grid()
    print(f"    total {time.perf_counter() - t_start:.3f}s; traces that came back "
          f"short (kernel, calls traced, calls made, lost launches): {TRACE_SHORT}",
          flush=True)

    n_short6 = len(TRACE_SHORT)
    print("[7] serving similar_to over 1000000 x 768 float32 on the card", flush=True)
    v = serve_vectors("cuda", log=lambda m: print("    " + m, flush=True),
                      profile=tuple(c for c in opts.profile if c in "efghi"), keep=True)
    for name, what in (("e", "similar_to(emb) IVF"), ("f", "similar_to(emb, ef: 64) IVF"),
                       ("g", "similar_to(emb_small) brute"),
                       ("h", "search_batch of 64 on emb, brute"),
                       ("i", "similar_to(emb_small) filtered to far uids, brute, widened")):
        print(f"    query ({name}) {what}: {v['queries'][name]:.3f} ms (warm median)", flush=True)
    print(f"    launches in the counted run {v['launches']}, KV1 per read "
          f"{v['topk_per_read']}, (i) at k {v['filtered_ks']}; device memory peak "
          f"{v['peak_bytes']} bytes", flush=True)
    if min(v["launches"].values()) < 1:
        raise AssertionError(f"a vector kernel did not launch on the main path: {v['launches']}")
    served = served_kernels(v.pop("captured"))
    for site, r in served.items():
        print(f"    {site} (served inputs): equal to plain; {_fmt(r)}", flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    print("[8] the write path on the card: JSON load, upserts, group commit, restart; "
          "at " + card, flush=True)
    small_V, all_Q = v.pop("small")
    writes = {}
    for arm in ("mem", "lsm"):
        config.set_env("STORAGE", arm)
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
                # (u1) and (u3) at half their default depth, and the lsm
                # arm with a quarter of the vectors (its 16 reads after the
                # restart as on the WAL store), to leave phases 10 and 11
                # room within the limit
                arm_V = small_V if arm == "mem" else small_V[:LSM_VECTORS]
                print(f"    [{arm}] DGRAPH_TPU_STORAGE={arm}, data_dir {d}, {len(arm_V)} "
                      "vectors", flush=True)
                writes[arm] = setop_counted(f"8 {arm}", serve_writes, "cuda", d, arm_V, all_Q,
                                            upserts_per_thread=250, transfers_per_thread=125,
                                            log=lambda m: print("      " + m, flush=True))
        finally:
            config.unset_env("STORAGE")
    for arm, w in writes.items():
        print(f"    [{arm}] " + json.dumps({
            "load_edges_per_s": w["load"]["per_s"], "vectors_s": w["load"]["vectors_s"],
            "upserts_per_s": w["u1"]["per_s"], "upsert_p50_ms": w["u1"]["p50_ms"],
            "upsert_p99_ms": w["u1"]["p99_ms"], "transfers_per_s": w["u3"]["per_s"],
            "abort_share": w["u3"]["abort_share"], "batch_mean": w["batch_mean"],
            "vectors": w["load"]["vectors"], "disk_bytes": w["disk_bytes"],
            "recover_s": w["recover"], "read_ms_after_restart": w["read_ms"]}), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    print("[9] the serving front on the card: plan cache, result cache, query_rdf on "
          "phase 4's server; coalesced similar_to, admission, ACL and audit on phase 7's; "
          "at " + card, flush=True)
    # phase 12 serves both servers again after phase 9
    gserver, graph, vserver = s.pop("server"), s.pop("graph"), v.pop("server")
    front = {"graph": setop_counted("9", front_graph, gserver, graph,
                                    log=lambda m: print("    " + m, flush=True))}
    bad = {k: n for k, n in sweep_shapes_equal(front["graph"]["sweep_shapes"]).items() if n}
    if bad:
        raise AssertionError(f"(9) K1 != plain at shapes (n, pa, pb): {bad}")
    print(f"    K1 launches {front['graph']['sweeps']}, equal to plain at every shape "
          f"(n, pa, pb) it took: {sorted(front['graph'].pop('sweep_shapes'))}", flush=True)
    # (9a) at 32 reads a client (64 before phase 11), for the time limit
    front["vectors"] = setop_counted("9", front_vectors, vserver, all_Q, named=v["named"],
                                     per_client=32,
                                     log=lambda m: print("    " + m, flush=True))
    launches9 = front["vectors"]["launches"]
    if min(launches9.values()) < 1:
        raise AssertionError(f"(9) a vector kernel did not launch: {launches9}")
    served9 = served_kernels(front["vectors"].pop("captured"))
    for site, r in served9.items():
        print(f"    {site} ((9a), (9e), (9f) inputs): equal to plain; {_fmt(r)}", flush=True)
    print("    [9] " + json.dumps({"launches": {"member_sweep": front["graph"]["sweeps"],
                                               **launches9}, **front}), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    edge = [tuple(int(u, 16) for u in front["graph"]["result_cache"]["edge"])]
    exact = v.pop("exact")
    gq = setop_counted("12", graphql_phase, gserver, graph, vserver, small_V, all_Q, v["named"],
                       exact, edge, card, t_start)
    del gserver, vserver
    p13 = setop_counted("13", cli_and_mesh_phase, graph, s.pop("answers"), v.pop("V"), all_Q,
                        exact, small_V, card, t_start)
    del graph

    ops = setop_counted("10", data_in_and_out, small_V[:OPS_VECTORS].copy(), all_Q,
                        writes["mem"]["load"]["per_s"], card, t_start)
    cl = setop_counted("11", cluster_phase, small_V[:CLUSTER_VECTORS].copy(), all_Q, card,
                       t_start)
    del small_V, all_Q

    print("[plain ops] K4-K7, K11 (plain torch in the port): calls by path "
          f"{plain_paths}; ms (events) and byte bound at " + card, flush=True)
    for name in PLAIN_OPS:
        size, got_in = plain_largest.get(name, (None, None))
        where = (f"its largest served input, {size} words or uids" if got_in is not None
                 else "no served call: `plain_op_input`'s input at (b)'s scale")
        r = plain_op_measure(name, got_in if got_in is not None else plain_op_input(name))
        print(f"    {name} ({where}): {r['ms']:.6f} ms, bound {r['bound_ms']:.6f} "
              f"({r['bound_by']})", flush=True)
    del plain_largest
    print(f"    traces short after phase 6 (kernel, calls traced, calls made, lost "
          f"launches): {TRACE_SHORT[n_short6:]}; traces without the kernel (kernels, "
          f"calls, lost launches): {TRACE_EMPTY}", flush=True)

    # the kernels' rows: each at the served shape that moves most bytes
    def heaviest(prefix):
        return max((r for site, r in served.items() if site.startswith(prefix)),
                   key=lambda r: r["bound_ms"])

    sweep_paths = {"4": s["launches"], "4 K1 read": k1["launches"], **{
        f"8 {arm} restart": w["after_restart_launches"]["member_sweep"]
        for arm, w in writes.items()},
        "9": front["graph"]["sweeps"], "10": ops["launches"]["member_sweep"],
        "11": cl["launches"]["member_sweep"], "12": gq["launches"]["member_sweep"],
        "13": p13["launches"]["member_sweep"]}
    rows = [{
        "name": "member_sweep",
        "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/member_sweep.cu",
        "replaces": "dgraph_tpu/ops/pallas_setops.py:53",
        "launches": sum(sweep_paths.values()),
        "launches_by_path": sweep_paths,
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }]
    for name, src, ref, prefix in (
        ("vector_topk", "vector_topk.cu", "dgraph_tpu/models/vector.py:194", "KV1"),
        ("ivf_slab_scan", "ivf_slab_scan.cu", "dgraph_tpu/models/vector.py:232", "KV2"),
    ):
        r = heaviest(prefix)
        by_path = {"7": v["launches"][name]}
        if name == "vector_topk":
            by_path.update({f"8 {arm} restart": w["after_restart_launches"]["vector_topk"]
                            for arm, w in writes.items()})
        by_path["9"] = launches9[name]
        for phase, got in (("10", ops["launches"]), ("11", cl["launches"]),
                           ("12", gq["launches"]), ("13", p13["launches"])):
            if name in got:
                by_path[phase] = got[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"dgraph_tpu_torch/csrc/{src}",
            "replaces": ref, "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        })
    heavy = max(setop_main.values(), key=lambda r: r["bound_ms"])
    rows.append({
        "name": "setop_rows", "route": "cuda", "source": "dgraph_tpu_torch/csrc/setop_rows.cu",
        "replaces": "dgraph_tpu/ops/setops.py:87", "launches": sum(setop_paths.values()),
        "launches_by_path": setop_paths, "shapes_checked_by_path": setop_checked,
        **{key: heavy[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
    })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
