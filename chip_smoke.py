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
     where the regimes cross);
  4. the main path: an embedded `Server(device="cuda")` loads a 3-level
     fan-out graph (1 -> 100 -> 10k -> 1M edges, the level-3 pool split
     across the 2^32 uid segment boundary, a 1%-hot `tag` on every level-3
     node) through its own mutations and answers four DQL reads with the
     device path forced and the member sweep on. Every answer must equal
     the port's host path and an independent numpy reference, and the
     member sweep must have launched during query (b);
  5. K1 once more, on the inputs the main path gave it, after checking
     that they meet its precondition (rows sorted as uint32);
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
     graph and phase 7's 100,000 `emb_small` rows (the lsm arm the first
     25,000) through `mutate_json` (the answers must equal numpy), then
     runs (u1) 8 threads x 500
     email upserts (Dgraph's Upsert Block example; each email must end
     with one uid), (u2) an upsert whose query block is query (b)'s
     filtered level 3 (K1 must launch; `has(hot_seen)` must equal numpy)
     and (u3) the bank in JSON, 8 threads x 250 transfers with a reader
     checking the total at every snapshot. It closes the store, opens it
     again in a new Server, times the recovery, and every answer of
     before, 16 `similar_to` reads among them, must come back byte for
     byte (K1 and KV1 must launch), with a fresh blank node above every
     recovered uid.

`--profile` adds, for the named queries (a-d of phase 4, e-i of phase
7), where one warm run's time goes: host functions by own time
(cProfile) and the card's busy share (torch.profiler). `--crossover`
runs phases 1-2 and then, in place of the others, measures where KV1's
radix regime starts to beat its one-pass regime (`topk_crossover`).

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
    # level-3 filter: rows straddle 2^32, so the filter intersect goes
    # through the bucketed pair path and the member sweep
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


def make_graph(fanout=100, pool=200_000, seed=7, hot_every=100):
    """The fan-out graph of bench.py (level-3 targets drawn from a pool
    with `np.random.default_rng(seed)`), with half of the pool at or
    above 2^32 and every `hot_every`-th pool node tagged hot."""
    f = fanout
    rng = np.random.default_rng(seed)
    half = pool // 2
    pool_uids = np.concatenate(
        [0x1000000 + np.arange(half), SEG + np.arange(pool - half)]
    ).astype(np.uint64)
    return {
        "f": f,
        "l1": (0x100 + np.arange(f)).astype(np.uint64),
        "l2": (0x10000 + np.arange(f * f)).astype(np.uint64),
        "l3": pool_uids[rng.integers(0, pool, size=f * f * f)],
        "pool": pool_uids,
        "hot": pool_uids[::hot_every],
    }


def nquad_chunks(g, chunk=50_000):
    """RDF text in commits of about `chunk` N-Quads: the edges level by
    level, then one tag per pool node."""
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
    for s in range(0, len(g["pool"]), chunk):
        yield "\n".join(
            f'<{hex(u)}> <tag> "{"hot" if u in hot else "cold"}" .'
            for u in g["pool"][s : s + chunk].tolist()
        )


def load_graph(server, g, chunk=50_000) -> int:
    """Schema plus every N-Quad through the server's own mutations."""
    server.alter("child: [uid] .\ntag: string @index(exact) .")
    n = 0
    for text in nquad_chunks(g, chunk):
        server.new_txn().mutate_rdf(set_rdf=text, commit_now=True)
        n += text.count("\n") + 1
    return n


def expected(g, name):
    """What query `name` must answer, from the edge arrays alone."""
    f = g["f"]
    rows = [np.unique(g["l3"][i * f : (i + 1) * f]) for i in range(len(g["l2"]))]
    if name == "a":
        return [len(r) for r in rows]
    return {
        int(u): np.intersect1d(r, g["hot"]).tolist()
        for u, r in zip(g["l2"], rows)
    }


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


class _Capture:
    """Keeps the largest set of member-sweep inputs the main path hands
    the wrapper (cloned), delegating every call unchanged."""

    def __init__(self, member_sweep):
        self.ms = member_sweep
        self.real = member_sweep.membership_batch
        self.args = None
        self.shapes = []

    def __call__(self, A, LA, B, LB):
        self.shapes.append((int(A.shape[0]), int(A.shape[1]), int(B.shape[1])))
        if self.args is None or A.numel() + B.numel() > sum(
            t.numel() for t in self.args[::2]
        ):
            self.args = tuple(t.clone() for t in (A, LA, B, LB))
        return self.real(A, LA, B, LB)

    def __enter__(self):
        self.ms.membership_batch = self
        return self

    def __exit__(self, *exc):
        self.ms.membership_batch = self.real


def _run_query(server, q):
    return server.query(q, want="raw")["data"].raw


def profile_query(server, q, log=print, top=12, reps=5):
    """Where one warm query's time goes: the host functions by own time
    (cProfile), and the card's busy share (torch.profiler: the sum of
    device kernel and copy time over the query's wall time, over `reps`
    calls). `q` is a DQL string, or a callable that runs the work."""
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def serve(device="cuda", fanout=100, pool=200_000, reps=3, log=print, profile=()):
    """Load the fan-out graph into a port Server on `device` and answer
    QUERIES on the forced device path (member sweep on) and on the host
    path; every answer is held to the numpy reference. Returns the
    measurements, the kernel counts of the counted run and the captured
    member-sweep inputs. Queries named in `profile` are profiled on the
    device path afterwards (card only)."""
    import torch

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.ops import member_sweep
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

    saved = (dispatch._FORCE_DEVICE, dispatch._USE_PALLAS, dispatch._DEVICE_MIN_TOTAL)

    def device_path():
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS = True, True
        dispatch._DEVICE_MIN_TOTAL = saved[2]

    def host_path():
        # no set op on the card: every size stays on the host loops
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS = False, False
        dispatch._DEVICE_MIN_TOTAL = 1 << 62

    def count():
        return member_sweep.LAUNCHES if on_card else member_sweep.PLAIN_CALLS

    out = {"load_s": load_s, "n_quads": nq, "queries": {}}
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the counted run: each query once, counts zeroed just before
        device_path()
        member_sweep.LAUNCHES = member_sweep.PLAIN_CALLS = 0
        answers = {}
        per_query = {}
        with _Capture(member_sweep) as cap:
            for name, q in QUERIES.items():
                c0 = count()
                answers[name] = _run_query(server, q)
                per_query[name] = count() - c0
        out["launches"] = member_sweep.LAUNCHES
        out["plain_calls"] = member_sweep.PLAIN_CALLS
        out["sweep_per_query"] = per_query
        out["sweep_shapes"] = sorted(set(cap.shapes))
        out["captured"] = cap.args
        if on_card:
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["device_cache"] = dispatch.DISPATCHER.device_cache.stats()
        for name, q in QUERIES.items():
            ms_dev = []
            for _ in range(reps):
                t = time.perf_counter()
                again = _run_query(server, q)
                ms_dev.append((time.perf_counter() - t) * 1e3)
                if again != answers[name]:
                    raise AssertionError(f"query {name}: device path not stable")
            host_path()
            ms_host = []
            for _ in range(reps):
                t = time.perf_counter()
                host = _run_query(server, q)
                ms_host.append((time.perf_counter() - t) * 1e3)
            device_path()
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
    finally:
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS, dispatch._DEVICE_MIN_TOTAL = saved
    return out


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
    launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = {name: 1} if isinstance(name, str) else dict(name)
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):  # a trace now and then comes back without a kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = {}
        for e in prof.key_averages():
            for n in per_call:
                if e.count and n in e.key:
                    t, c = got.get(n, (0.0, 0))
                    got[n] = (t + e.self_device_time_total, c + e.count)
        if set(got) == {n for n, c in per_call.items() if c}:
            for n, (_, c) in got.items():
                if c != reps * per_call[n]:
                    TRACE_SHORT.append((n, c, reps * per_call[n]))
            return sum(t / c * per_call[n] for n, (t, c) in got.items()) / 1e3
        seen = [e.key[:60] for e in prof.key_averages()]
    raise AssertionError(f"no device time traced for {sorted(per_call)} in 3 traces; "
                         f"saw {seen}")


TRACE_SHORT = []  # (kernel, calls traced, calls made) where they differ


def _to_i64(x):
    import torch

    return x.to(torch.int64) & U32


def sorted_keys(B, LB):
    """B's rows as int64 u32 values with 2^32 past LB: sorted over the full
    width whatever the padding, for torch.searchsorted."""
    import torch

    cols = torch.arange(B.shape[1], device=B.device)
    return torch.where(cols < LB.unsqueeze(1), _to_i64(B), 1 << 32)


def library_membership(A64, LA, Bkey, LB):
    """One batched torch.searchsorted + gather-compare: the yardstick,
    timed here and called nowhere in the port. Bkey from sorted_keys."""
    import torch

    idx = torch.searchsorted(Bkey, A64)
    pb = Bkey.shape[1]
    hit = (idx < LB.unsqueeze(1)) & (
        torch.gather(Bkey, 1, idx.clamp(max=pb - 1)) == A64
    )
    return hit & (torch.arange(A64.shape[1], device=A64.device) < LA.unsqueeze(1))


def sweep_bound_ms(A, LA, B, LB):
    """Least time any correct method could take on these sorted rows, in
    ms, and what bounds it. Bytes: A's valid elements, 8 per row for LA
    and LB, the n * pa mask, and every distinct 32-byte sector of B that
    holds, for a valid query, its equal element or, where B has none, its
    neighbours in the valid prefix (no method can answer the query without
    them), all at the card's memory rate. Compares are left out: the
    fewest any method needs, about LA * log2(LB / LA + 1) per row, at most
    32 per query, take less time at 67 T/s than the query's own 4 bytes of
    A take at 3.35 TB/s. So the bound is always the bytes."""
    import torch

    n, pa = A.shape
    pb = B.shape[1]
    la = LA.to(torch.int64)
    nbytes = 4 * int(la.sum()) + 8 * n + n * pa
    if pb and n:
        lb = LB.to(torch.int64).unsqueeze(1)
        key = sorted_keys(B, LB)
        q = _to_i64(A)
        p = torch.searchsorted(key, q)
        eq = (p < lb) & (torch.gather(key, 1, p.clamp(max=pb - 1)) == q)
        valid = torch.arange(pa, device=A.device) < la.unsqueeze(1)
        row0 = torch.arange(n, device=A.device).unsqueeze(1) * pb
        at = torch.where(valid & (eq | (p < lb)), row0 + p, -1)  # equal or next
        before = torch.where(valid & ~eq & (p > 0), row0 + p - 1, -1)
        elems = torch.cat([at[at >= 0], before[before >= 0]])
        nbytes += 32 * int(torch.unique(elems // 8).numel())  # B 32-byte aligned
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


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
        print(f"    {kind} n={m}{cut} pa={pa} pb={pb}: equal; kernel {r['ms']:.6f} "
              f"(device {r['device_ms']:.6f}) plain {r['plain_ms']:.6f} "
              f"library {r['library_ms']:.6f} bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}); rows {r['regimes']}", flush=True)
        del rows


def check_sorted(A, LA, B, LB):
    """The kernel's precondition: every row sorted ascending as uint32
    within its length. Raises on the first row that is not."""
    import torch

    for name, X, L in (("A", A, LA), ("B", B, LB)):
        if X.shape[1] < 2:
            continue
        x = _to_i64(X)
        inside = torch.arange(1, X.shape[1], device=X.device) < L.unsqueeze(1)
        bad = ((x[:, 1:] < x[:, :-1]) & inside).any(1)
        if bool(bad.any()):
            raise AssertionError(f"main-path {name} row {int(bad.nonzero()[0, 0])} "
                                 "is not sorted as uint32")


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
        "plain_ms": _events_ms(lambda: ivf_scan.slab_distances_plain(*args), 3),
        "library_ms": _events_ms(library_slabs(*args), reps),
        "bound_ms": bound,
        "bound_by": bound_by,
    }


def _fmt(r):
    return (f"kernel {r['ms']:.6f} (device {r['device_ms']:.6f}) plain {r['plain_ms']:.6f} "
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


def serve_vectors(device="cuda", n=1_000_000, d=768, n_named=10_000, n_small=100_000,
                  nq=64, k=10, reps=3, min_recall=0.90, ivf_threshold=None,
                  n_allow=20, log=print, profile=()):
    """Phase 7: load the corpus into a port Server on `device`, serve the
    five vector reads, check them (exact top-k, recall, the CPU float
    path, the kernels' launches) and time them. Returns the measurements,
    the kernel counts of the counted run and the captured kernel inputs.
    `ivf_threshold` overrides the index's (a rehearsal at a small n).
    Read (i) filters `emb_small` to the `n_allow` uids farthest from the
    query, so its pool widens 4x a step up to the whole live set."""
    import os

    import torch

    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.ops import ivf_scan, vector_topk

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    V, Qs = make_corpus(n, d)
    Q = Qs[:nq]
    log(f"corpus: {n} x {d} float32 (256 gaussians, default_rng(1)) and {nq} queries "
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
    member-sweep calls `count()` saw during the upsert."""
    c0 = count()
    t0 = time.perf_counter()
    server.new_txn().upsert(query=HOT_UPSERT[0], set_rdf=HOT_UPSERT[1])
    took = time.perf_counter() - t0
    sweeps = count() - c0
    want = sorted({u for row in expected(g, "b").values() for u in row})
    got = sorted(int(o["uid"], 16)
                 for o in json.loads(_run_query(server, STATE_READS["hot_seen"]))["q"])
    if got != want:
        raise AssertionError(f"(u2): has(hot_seen) holds {len(got)} uids, numpy {len(want)}")
    return {"s": took, "sweeps": sweeps, "marked": len(got)}


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
        with _Capture(member_sweep) as cap:
            out["u2"] = upsert_hot(server, g, sweeps)
        if out["u2"]["sweeps"] < 1:
            raise AssertionError("(u2): the member sweep did not launch during the upsert")
        if on_card:
            A, LA, B, LB = cap.args
            check_sorted(A, LA, B, LB)
            got = member_sweep.membership_batch(A, LA, B, LB)
            if not torch.equal(got, member_sweep.membership_batch_plain(A, LA, B, LB)):
                raise AssertionError("(u2): K1 != plain on the upsert's inputs")
            out["u2"]["sweep_shape"] = tuple(A.shape) + (B.shape[1],)
        log(f"(u2) fan-out upsert in {out['u2']['s']:.3f}s marked {out['u2']['marked']} "
            f"hot nodes (== numpy), member sweep {out['u2']['sweeps']} launches, equal to "
            f"plain on its inputs {out['u2'].get('sweep_shape')}")
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
            c0 = sweeps()
            t = time.perf_counter()
            again[name] = _run_query(server, q)
            cold[name] = (time.perf_counter() - t) * 1e3
            per[name] = sweeps() - c0
        for name, q in STATE_READS.items():
            again[name] = _run_query(server, q)
        out["after_restart_launches"] = {"member_sweep": sweeps(), "vector_topk": topks()}
        if per["b"] < 1 or per["similar_to"] < n_reads:
            raise AssertionError(f"after the restart: K1 {per['b']} in (b), KV1 "
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
            f"emails, hot_seen and balances equal to before; K1 {per['b']} launches in (b), "
            f"KV1 {per['similar_to']} in the similar_to reads; fresh blank node "
            f"{hex(fresh)} > {hex(known_top)}; read ms {out['read_ms']}")
        server.kv.close()
    finally:
        dispatch._FORCE_DEVICE, dispatch._USE_PALLAS = saved
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
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    from dgraph_tpu_torch.ops import cuda_build
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

    print("[3] member sweep vs plain (exact), times in ms at " + card, flush=True)
    sweep_edge_cases()
    sweep_grid()

    print("[4] serving the fan-out graph on the card", flush=True)
    s = serve("cuda", log=lambda m: print("    " + m, flush=True),
              profile=tuple(c for c in opts.profile if c in QUERIES))
    for name, r in s["queries"].items():
        print(f"    query ({name}): device path {r['device_ms']:.3f} ms, host path "
              f"{r['host_ms']:.3f} ms (warm medians), {r['bytes']} bytes; "
              "device == host == numpy", flush=True)
    print(f"    member sweep launches per query {s['sweep_per_query']}, shapes "
          f"(n, pa, pb) {s['sweep_shapes']}", flush=True)
    print(f"    device memory peak {s['peak_bytes']} bytes; DeviceCache "
          f"{s['device_cache']}", flush=True)
    if s["sweep_per_query"]["b"] < 1:
        raise AssertionError("the member sweep did not launch during query (b)")

    print("[5] member sweep on the main path's inputs", flush=True)
    A, LA, B, LB = s["captured"]
    check_sorted(A, LA, B, LB)
    main = measure_sweep(A, LA, B, LB)
    if main["mismatches"]:
        raise AssertionError(f"main-path inputs: kernel != plain: {main}")
    print(f"    n={A.shape[0]} pa={A.shape[1]} pb={B.shape[1]}: rows sorted as "
          f"uint32; equal; kernel {main['ms']:.6f} (device {main['device_ms']:.6f}) "
          f"plain {main['plain_ms']:.6f} library {main['library_ms']:.6f} "
          f"bound {main['bound_ms']:.6f} ({main['bound_by']}); all-of-B byte time "
          f"{all_of_b_ms(A, LA, B, LB):.6f}; rows {main['regimes']}", flush=True)
    del s["captured"], A, LA, B, LB
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    print("[6] vector kernels vs plain (KV1 bitwise, KV2 within tolerance), times in "
          "ms at " + card, flush=True)
    vector_grid()
    print(f"    total {time.perf_counter() - t_start:.3f}s; traces that came back "
          f"short (kernel, calls traced, calls made): {TRACE_SHORT}", flush=True)

    print("[7] serving similar_to over 1000000 x 768 float32 on the card", flush=True)
    v = serve_vectors("cuda", log=lambda m: print("    " + m, flush=True),
                      profile=tuple(c for c in opts.profile if c in "efghi"))
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
    small_V, small_Q = v.pop("small")
    writes = {}
    for arm in ("mem", "lsm"):
        config.set_env("STORAGE", arm)
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
                print(f"    [{arm}] DGRAPH_TPU_STORAGE={arm}, data_dir {d}, {len(small_V)} "
                      "vectors", flush=True)
                writes[arm] = serve_writes("cuda", d, small_V, small_Q,
                                           log=lambda m: print("      " + m, flush=True))
        finally:
            config.unset_env("STORAGE")
    del small_V, small_Q
    for arm, w in writes.items():
        print(f"    [{arm}] " + json.dumps({
            "load_edges_per_s": w["load"]["per_s"], "vectors_s": w["load"]["vectors_s"],
            "upserts_per_s": w["u1"]["per_s"], "upsert_p50_ms": w["u1"]["p50_ms"],
            "upsert_p99_ms": w["u1"]["p99_ms"], "transfers_per_s": w["u3"]["per_s"],
            "abort_share": w["u3"]["abort_share"], "batch_mean": w["batch_mean"],
            "vectors": w["load"]["vectors"], "disk_bytes": w["disk_bytes"],
            "recover_s": w["recover"], "read_ms_after_restart": w["read_ms"]}), flush=True)
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    # the kernels' rows: each at the served shape that moves most bytes
    def heaviest(prefix):
        return max((r for site, r in served.items() if site.startswith(prefix)),
                   key=lambda r: r["bound_ms"])

    rows = [{
        "name": "member_sweep",
        "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/member_sweep.cu",
        "replaces": "dgraph_tpu/ops/pallas_setops.py:53",
        "launches": s["launches"] + sum(w["u2"]["sweeps"] + w["after_restart_launches"][
            "member_sweep"] for w in writes.values()),
        "launches_by_path": {"4": s["launches"], **{
            f"8 {arm} {step}": n for arm, w in writes.items() for step, n in (
                ("u2", w["u2"]["sweeps"]),
                ("restart", w["after_restart_launches"]["member_sweep"]))}},
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
        rows.append({
            "name": name, "route": "cuda", "source": f"dgraph_tpu_torch/csrc/{src}",
            "replaces": ref, "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
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
