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
     that they meet its precondition (rows sorted as uint32).

`--profile` adds, for the named queries, where one warm run's time goes:
host functions by own time (cProfile) and the card's busy share
(torch.profiler).

The second-to-last lines are the kernel table (JSON) and the card; the
last line is `{"ok": true, "device": {...}}`. Without a CUDA card the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEG = 1 << 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
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


def profile_query(server, q, log=print, top=12):
    """Where one warm query's time goes: the host functions by own time
    (cProfile), and the card's busy share (torch.profiler: the sum of
    device kernel and copy time over the query's wall time)."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    pr = cProfile.Profile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pr.enable()
    _run_query(server, q)
    pr.disable()
    wall_ms = (time.perf_counter() - t) * 1e3
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(top)
    log(f"host profile ({wall_ms:.3f} ms under cProfile), top {top} by own time:")
    for line in buf.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            log("      " + line.strip())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _run_query(server, q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.4f}); by kernel:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5} {e.key[:90]}")


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
    """Device time of one launch of the kernel `name` in ms, from the
    card's own trace (torch.profiler, CUPTI): the kernel alone, without
    the host's time between launches that CUDA events around back-to-back
    calls also take in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):  # a trace now and then comes back without the kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if name in e.key and e.count]
        if ev:
            return ev[0].self_device_time_total / ev[0].count / 1e3
        seen = [e.key[:60] for e in prof.key_averages()]
    raise AssertionError(f"no device time traced for {name} in 3 traces; saw {seen}")


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
    A64, Bkey = _to_i64(A), sorted_keys(B, LB)
    lib = library_membership(A64, LA, Bkey, LB)
    lib_agrees = bool(torch.equal(lib, want))
    bound, bound_by = sweep_bound_ms(A, LA, B, LB)
    return {
        "mismatches": err,
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default="", metavar="QUERIES",
                    help="also profile these queries on the device path, e.g. bc")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    from dgraph_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    secs = cuda_build.build()
    print(f"[2] built {sorted(secs)} in {time.perf_counter() - t0:.3f}s "
          f"(per source {secs})", flush=True)

    print("[3] member sweep vs plain (exact), times in ms at " + card, flush=True)
    sweep_edge_cases()
    sweep_grid()

    print("[4] serving the fan-out graph on the card", flush=True)
    s = serve("cuda", log=lambda m: print("    " + m, flush=True),
              profile=tuple(opts.profile))
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
    print(f"    total {time.perf_counter() - t_start:.3f}s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "member_sweep",
        "route": "cuda",
        "source": "dgraph_tpu_torch/csrc/member_sweep.cu",
        "replaces": "dgraph_tpu/ops/pallas_setops.py:53",
        "launches": s["launches"],
        "max_abs_err": main["mismatches"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
