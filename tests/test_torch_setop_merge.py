"""setop_merge (K4, K5, K6) against the XLA set ops it replaces.

`dgraph_tpu_torch/ops/setop_merge.py` holds the hand-written CUDA kernels'
wrappers (`union_ragged`: the union of list pairs; `merge_sorted`: the
k-way union, every round of the pair union in one cooperative launch;
`intersect_many`: the k-way intersection) over lists back to back in one buffer, and beside them their
plain PyTorch versions, which CPU tensors take. Here the plain versions
run against the reference's `dgraph_tpu.ops.setops.union` (vmapped over
the pairs), `merge_sorted` and `intersect_many` on jax-CPU, on the same
seeded lists (`chip_smoke.merge_lists_case`: every kind of
`chip_smoke.MERGE_KINDS`); words and counts must be equal exactly. Then
the dispatcher on the forced device path, through a Server of each
package, answers the reads that reach the kernels ((c), (e) and (f) of
chip_smoke's phase 4c) byte for byte alike and as numpy does, on graphs
over two hi-32 segments and over one. The kernels themselves run only on
an NVIDIA card: those tests are marked `cuda` and skip without one:

    python -m pytest --noconftest tests/test_torch_setop_merge.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.ops import member_sweep, setop_merge, setop_rows
from dgraph_tpu_torch.query import dispatch

U32 = 0xFFFFFFFF
SEG = 1 << 32
# (id, list lengths, merge_lists_case options); "window-8193": list 0's
# window in list 1 one word wider than the k-way intersection stages whole
PAIR_SHAPES = [("3-and-5", [3, 5], {}), ("20-pairs", list(range(0, 80, 2)), {}),
               ("across-tiles", [3000, 5000, 2500, 10], {}), ("lopsided", [1, 3000, 3000, 1], {})]
LIST_SHAPES = [("k2", [300, 500], {}), ("k3", [200, 4000, 300], {}),
               ("k256", list(np.random.default_rng(0).integers(0, 20, 256)), {}),
               ("window-8193", [2000, 9216, 3000], {"window": 8193})]


def _t(arrays, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in arrays]


def _lists(X, offs):
    x = X.view(np.uint32)
    return [x[offs[i] : offs[i + 1]] for i in range(len(offs) - 1)]


def _pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _padded(lists):
    M = np.full((len(lists), _pow2(max([len(x) for x in lists] + [1]))), U32, np.uint32)
    for i, x in enumerate(lists):
        M[i, : len(x)] = x
    return M, np.array([len(x) for x in lists], np.int32)


def _reference(name, X, offs):
    """The reference's set op on the same lists, as (kept words, offsets):
    union vmapped over the (a, b) pairs, each padded to a power of two as
    the reference pads; merge_sorted and intersect_many over the (k, pow2)
    padded lists."""
    import jax
    import jax.numpy as jnp

    from dgraph_tpu.ops import setops as ref

    lists = _lists(X, offs)
    if name == "union_ragged":
        A, LA = _padded(lists[0::2])
        B, LB = _padded(lists[1::2])
        out, cnt = jax.vmap(ref.union)(jnp.asarray(A), jnp.asarray(LA), jnp.asarray(B),
                                       jnp.asarray(LB))
        out, cnt = np.asarray(out), np.asarray(cnt)
    else:
        M, L = _padded(lists)
        out, cnt = getattr(ref, name)(jnp.asarray(M), jnp.asarray(L))
        out, cnt = np.asarray(out)[None], np.asarray(cnt).reshape(1)
    off = np.zeros(len(cnt) + 1, np.int64)
    np.cumsum(cnt, out=off[1:])
    return np.concatenate([out[i, : cnt[i]] for i in range(len(cnt))]), off


@pytest.mark.parametrize("kind", chip_smoke.MERGE_KINDS)
@pytest.mark.parametrize(
    "name,shape",
    [("union_ragged", s) for s in PAIR_SHAPES]
    + [(n, s) for n in ("merge_sorted", "intersect_many") for s in LIST_SHAPES],
    ids=lambda v: v if isinstance(v, str) else v[0],
)
def test_plain_matches_reference(name, shape, kind):
    X, offs = chip_smoke.merge_lists_case(shape[1], seed=len(shape[1]), kind=kind, **shape[2])
    want_words, want_off = _reference(name, X, offs)
    calls = setop_merge.PLAIN_CALLS[name]
    out, head = getattr(setop_merge, name)(*_t([X, offs]))
    assert setop_merge.PLAIN_CALLS[name] == calls + 1
    assert out.dtype == head.dtype == torch.int32
    off, words = chip_smoke.merge_words(name, (out, head))
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)


@pytest.mark.parametrize(
    "lists,want",
    [
        ([[1, U32], [U32]], [1, U32]),  # the sentinel is a legal uid
        ([[], [5, 5, 6]], [5, 6]),  # equal words inside one list count once
        ([[2, 2], []], [2]),
        ([[], []], []),
        ([[0, 1 << 31], [(1 << 31) - 1, 1 << 31]], [0, (1 << 31) - 1, 1 << 31]),  # unsigned
    ],
)
def test_single_pairs(lists, want):
    X = np.array([x for lst in lists for x in lst], np.uint32).view(np.int32)
    offs = np.array([0, len(lists[0]), len(lists[0]) + len(lists[1])], np.int32)
    out, head = setop_merge.union_ragged(*_t([X, offs]))
    assert head.tolist() == [0, len(want)]
    assert out.numpy().view(np.uint32).tolist() == want
    out, head = setop_merge.merge_sorted(*_t([X, offs]))
    assert out.numpy().view(np.uint32).tolist() == want
    # k-way intersection: list 0's words that list 1 holds, duplicates kept
    out, head = setop_merge.intersect_many(*_t([X, offs]))
    kept = [x for x in lists[0] if x in lists[1]]
    assert out.numpy().view(np.uint32).tolist() == kept and head.tolist() == [0, len(kept)]


def test_intersect_many_keeps_list_zeros_duplicates():
    """The reference's count form: every copy of a word of list 0 that the
    others hold survives, where a smallest-first fold would keep one."""
    lists = [[3, 3, 7, 9, 9, 9], [3, 9], [1, 3, 9, 12]]
    X = np.array([x for lst in lists for x in lst], np.uint32).view(np.int32)
    offs = np.array([0, 6, 8, 12], np.int32)
    out, head = setop_merge.intersect_many(*_t([X, offs]))
    assert out.numpy().view(np.uint32).tolist() == [3, 3, 9, 9, 9]
    np.testing.assert_array_equal(_reference("intersect_many", X, offs)[0], [3, 3, 9, 9, 9])


@pytest.mark.parametrize(
    "bad",
    [
        lambda X, o: (X.to(torch.int64), o),  # dtype
        lambda X, o: (X, o.to(torch.int64)),
        lambda X, o: (X.reshape(1, -1), o),  # X not flat
        lambda X, o: (X, o[:1]),  # no list
    ],
)
@pytest.mark.parametrize("name", chip_smoke.MERGE_WRAPPERS)
def test_wrappers_reject_bad_inputs(name, bad):
    args = _t(chip_smoke.merge_lists_case([3, 4], seed=1))
    with pytest.raises((TypeError, ValueError)):
        getattr(setop_merge, name)(*bad(*args))


def test_union_needs_pairs():
    X, offs = _t(chip_smoke.merge_lists_case([3, 4, 5], seed=1))
    with pytest.raises(ValueError):
        setop_merge.union_ragged(X, offs)


def test_rounds_of_the_k_way_merge():
    """The rounds of a k-way merge all run in one launch of its own kernel."""
    assert [setop_merge.rounds(k) for k in (1, 2, 3, 4, 5, 256, 257)] == [1, 1, 2, 2, 3, 8, 9]
    assert setop_merge.kernel_names("merge_sorted") == {setop_merge.MERGE_KERNEL: 1}
    assert setop_merge.kernel_names("union_ragged") == {setop_merge.UNION_KERNEL: 1}


@pytest.mark.parametrize("k,cap", [(1, 0), (1, 5000), (2, 4096), (3, 4097), (4, 100), (5, 7),
                                   (256, 256000), (257, 1), (1000, 30088)])
def test_merge_layout(k, cap):
    """merge_sorted's buffer: each round's status words (2 a tile of cap),
    the barrier's count and a pad word, the offsets of even and of odd
    rounds, zeroed; then the words of even and odd rounds; the answer in
    the last round's, even for an odd count of rounds, odd for an even."""
    at = setop_merge.merge_layout(k, cap)
    n_rounds, jobs = setop_merge.rounds(k), (k + 1) // 2
    tiles = -(-cap // setop_merge.TILE)
    off0 = 2 * tiles * n_rounds + 2
    assert off0 % 2 == 0  # the status words stay 8-byte aligned, the offsets after them
    assert at["zeroed"] == off0 + 2 * (jobs + 1)
    assert at["words"] == at["zeroed"] + cap * (2 if n_rounds > 1 else 1)
    if n_rounds % 2:  # rounds 0, 2, ..: the first buffers
        assert (at["out"], at["head"]) == (at["zeroed"], off0)
    else:
        assert (at["out"], at["head"]) == (at["zeroed"] + cap, off0 + jobs + 1)
    assert at["out"] + cap <= at["words"] and at["head"] + 2 <= at["zeroed"]


def _numpy_answer(name, X, offs):
    """What a wrapper must answer, by numpy: (offsets, kept words)."""
    lists = _lists(X, offs)
    if name == "union_ragged":
        rows = [np.union1d(a, b) for a, b in zip(lists[0::2], lists[1::2])]
    elif name == "merge_sorted":
        rows = [np.unique(np.concatenate(lists))]
    else:
        keep = np.ones(len(lists[0]), bool)
        for other in lists[1:]:
            keep &= np.isin(lists[0], other)
        rows = [lists[0][keep]]
    off = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=off[1:])
    return off, np.concatenate(rows).astype(np.uint32) if rows else np.zeros(0, np.uint32)


@pytest.mark.parametrize(
    "case,kind",
    [(c, kind) for c in chip_smoke.merge_cases() for kind in chip_smoke.merge_case_kinds(c)],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}-{v[1]}",
)
def test_plain_matches_numpy_at_merge_cases(case, kind):
    """The plain versions, which phase 3c and the card tests hold the
    kernels to, answer as numpy at every case of merge_cases (lists of
    2^20 at LONG_KINDS, as phase 3c checks them): tile edges inside a job,
    empty lists between full ones, k of 1 to 10 rounds, windows of list 1
    too wide for the intersection to stage."""
    name = case[0]
    X, offs = chip_smoke.merge_case_lists(case, kind)
    off, words = chip_smoke.merge_words(name, setop_merge.PLAIN[name](*_t([X, offs])))
    want_off, want_words = _numpy_answer(name, X, offs)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want_words)


# ---------------------------------------------------------------------------
# The dispatcher's routes to the kernels, on the forced device path
# ---------------------------------------------------------------------------


@pytest.fixture
def device_path(monkeypatch):
    from dgraph_tpu.query import dispatch as ref

    for mod in (ref, dispatch):
        monkeypatch.setattr(mod, "_FORCE_DEVICE", True)
        monkeypatch.setattr(mod, "_USE_PALLAS", True)


def _straddle(rng, n, width=4000):
    return np.union1d(rng.integers(SEG - width, SEG, size=n // 2, dtype=np.uint64),
                      rng.integers(SEG, SEG + width, size=n - n // 2, dtype=np.uint64))


def test_union_sub_jobs_run_in_one_ragged_launch(device_path, monkeypatch):
    """Union pairs over two segments, of sizes that pad to several pow2
    buckets, run in one setop_merge call (its plain version here) with a
    and b adjacent lists of one upload; no bucket, no setop_rows, no K1;
    the answers equal the reference's and numpy's."""
    from dgraph_tpu.query import dispatch as ref

    rng = np.random.default_rng(21)
    pairs = [(_straddle(rng, int(n)), _straddle(rng, int(m)))
             for n, m in ((10, 3000), (300, 20), (2000, 2000), (1, 70))]
    pairs.append((np.unique(rng.integers(5, 90, size=7, dtype=np.uint64)), _straddle(rng, 40)))
    staged = []
    real_stage = dispatch._stage
    monkeypatch.setattr(dispatch, "_stage", lambda dev, parts: staged.append(len(parts))
                        or real_stage(dev, parts))
    monkeypatch.setattr(dispatch.SetOpDispatcher, "_run_bucket", None)  # never called
    calls = dict(setop_merge.PLAIN_CALLS)
    other = (setop_rows.PLAIN_CALLS, member_sweep.PLAIN_CALLS)
    got = dispatch.SetOpDispatcher(device="cpu").run_pairs("union", [(a, np.unique(b))
                                                                     for a, b in pairs])
    assert setop_merge.PLAIN_CALLS["union_ragged"] == calls["union_ragged"] + 1
    assert (setop_rows.PLAIN_CALLS, member_sweep.PLAIN_CALLS) == other
    assert staged == [2]  # the lists and their offsets, in one copy
    want = ref.SetOpDispatcher().run_pairs("union", [(a, np.unique(b)) for a, b in pairs])
    for g, w, (a, b) in zip(got, want, pairs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(w, np.union1d(a, b))


@pytest.mark.parametrize("op", ["intersect", "union"])
@pytest.mark.parametrize("k", [2, 3, 256])
def test_one_segment_chain_runs_one_launch(device_path, monkeypatch, op, k):
    """A chain on one segment stages its k lists back to back in one copy
    and runs one k-way kernel (merge or intersection); the answer equals
    the reference dispatcher's and numpy's."""
    from dgraph_tpu.query import dispatch as ref

    rng = np.random.default_rng(k)
    common = rng.integers(10, 9000, size=40, dtype=np.uint64)
    parts = [np.union1d(common, rng.integers(10, 9000, size=int(rng.integers(1, 200)),
                                             dtype=np.uint64)) for _ in range(k)]
    staged = []
    real_stage = dispatch._stage
    monkeypatch.setattr(dispatch, "_stage", lambda dev, p: staged.append(len(p))
                        or real_stage(dev, p))
    name = "intersect_many" if op == "intersect" else "merge_sorted"
    calls = setop_merge.PLAIN_CALLS[name]
    got = dispatch.SetOpDispatcher(device="cpu").run_chain(op, parts)
    assert setop_merge.PLAIN_CALLS[name] == calls + 1 and staged == [2]
    want = ref.SetOpDispatcher().run_chain(op, parts)
    np.testing.assert_array_equal(got, want)
    fold = parts[0]
    for p in parts[1:]:
        fold = np.intersect1d(fold, p) if op == "intersect" else np.union1d(fold, p)
    np.testing.assert_array_equal(want, fold)


def _servers(g):
    from dgraph_tpu.api.server import Server as RefServer
    from dgraph_tpu_torch.api.server import Server

    out = []
    for srv in (RefServer(), Server(device="cpu")):
        chip_smoke.load_graph(srv, g)
        out.append(srv)
    return out


GRAPHS = {"two-segments": dict(fanout=6, pool=400), "one-segment": dict(fanout=6, pool=400,
                                                                           low=True)}
# the setop_merge wrappers each read must reach on each graph
ROUTES = {
    "two-segments": {"c": set(), "e": {"union_ragged"}, "f": {"union_ragged", "merge_sorted"}},
    "one-segment": {"c": {"intersect_many"}, "e": {"merge_sorted"}, "f": {"merge_sorted"}},
}


@pytest.fixture(scope="module")
def graph_servers():
    return {name: (chip_smoke.make_graph(**kw), _servers(chip_smoke.make_graph(**kw)))
            for name, kw in GRAPHS.items()}


@pytest.mark.parametrize("graph,read", [(g, r) for g, reads in ROUTES.items() for r in reads])
def test_reads_match_reference(graph_servers, device_path, graph, read):
    """(c), (e) and (f) on the forced device path: the port's answer equals
    the reference's byte for byte and numpy's, and reaches the kernels
    the read needs (their plain versions here), and setops' plain
    programs only through them."""
    from dgraph_tpu_torch.query import dispatch as port

    g, (ref, port_srv) = graph_servers[graph]
    q = chip_smoke.MERGE_QUERIES.get(read) or chip_smoke.QUERIES[read]
    port.DISPATCHER.device_cache.clear()
    calls = dict(setop_merge.PLAIN_CALLS)
    with chip_smoke._PlainOps() as pops:
        got = chip_smoke._run_query(port_srv, q)
    reached = {w for w in calls if setop_merge.PLAIN_CALLS[w] > calls[w]}
    assert reached == ROUTES[graph][read]
    # setops' plain programs ran as the wrappers' plain versions, no more
    assert sum(pops.calls.get(n, 0) for n in chip_smoke.PLAIN_OPS[:3]) == sum(
        setop_merge.PLAIN_CALLS[w] - calls[w] for w in calls)
    assert got == ref.query(q, want="raw")["data"].raw
    data = json.loads(got)
    if read == "f":
        assert chip_smoke.extract_recurse(data) == chip_smoke.expected_recurse(g)
    else:
        assert chip_smoke.extract(read, data) == chip_smoke.expected(
            g, "b", hot=g["pool"] if read == "e" else None)


def test_merge_phase_on_cpu(monkeypatch):
    """chip_smoke's phase 4c at a tiny size on the CPU: (e) and (f) on
    phase 4's server, (c), (e) and (f) on a bulk-loaded one-segment
    server, every answer equal to the host path and numpy, every kernel
    reached (its plain version here)."""
    quiet = lambda m: None  # noqa: E731
    s = chip_smoke.serve("cpu", fanout=6, pool=400, reps=1, log=quiet, keep=True)
    out = chip_smoke.merge_phase(s["server"], s["graph"], device="cpu", log=quiet)
    assert out["launches"]["4c"]["union_ragged"] >= 1
    low = out["launches"]["4c one segment"]
    assert low["merge_sorted"] >= 1 and low["intersect_many"] >= 1


@pytest.mark.parametrize(
    "lists,want",
    [
        # list 1: the sector of 5 and 9, and of 4000's lower neighbour;
        # list 2: the sector of 5, searched for 5 and 9 alone
        ([[5, 9, 4000], list(range(1000)), [5]], 96),
        ([[7], [1, 2], [8]], 32),  # nothing of list 0 left for list 2
        ([[], [1, 2], [3]], 0),
    ],
)
def test_many_sector_bytes(lists, want):
    """K6's byte bound counts, of lists 1 .. k - 1, only the 32-byte
    sectors a membership of list 0's surviving words needs."""
    X = np.array([x for lst in lists for x in lst], np.uint32).view(np.int32)
    offs = np.cumsum([0] + [len(lst) for lst in lists]).astype(np.int32)
    assert chip_smoke.many_sector_bytes(*_t([X, offs])) == want


def test_probe_copy_of_the_kernel():
    """setop_merge_probe.py stamps each phase of a union tile and of an
    intersect tile: every edit finds its place in the kernel's source,
    once."""
    import os

    import setop_merge_probe
    from dgraph_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC, "setop_merge.cu")) as f:
        src = f.read()
    probed = setop_merge_probe.probe_source(src)
    # PROBE(3)-(7) in the union tile; (7), (8) in the intersect tile
    assert [probed.count(f"PROBE({n})") for n in range(3, 9)] == [1, 1, 1, 1, 2, 1]
    # the intersect tile's bounds, staging and searches, summed over its lists
    for stamp in ("c_bounds += clock64() - c0;", "c_stage += c2 - c1;",
                  "c_search += clock64() - c2;", "g_probe[slot][11] = c_lists;"):
        assert probed.count(stamp) == 1
    assert "extern \"C\" int probe_read" in probed
    with pytest.raises(ValueError):
        setop_merge_probe.probe_source(src.replace("sm.first, sm.sums);", "sm.first);"))
    with pytest.raises(ValueError):
        setop_merge_probe.probe_source(src.replace("  // the round's windows", ""))


def test_plain_calls_apart_from_launches():
    args = _t(chip_smoke.merge_lists_case([5, 6, 7, 8], seed=2))
    launches = dict(setop_merge.LAUNCHES)
    for name in chip_smoke.MERGE_WRAPPERS:
        getattr(setop_merge, name)(*args)
    assert setop_merge.LAUNCHES == launches


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions, exactly
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", chip_smoke.MERGE_KINDS)
@pytest.mark.parametrize("case", chip_smoke.merge_cases(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_kernel_matches_plain_on_card(card, case, kind):
    """Kernel == plain exactly, the call made twice back to back (each
    call's look-back state is its own); one launch counted a call."""
    name = case[0]
    args = _t(chip_smoke.merge_case_lists(case, kind), card)
    launches = setop_merge.LAUNCHES[name]
    r = chip_smoke.measure_merge(name, args, timed=False)
    assert setop_merge.LAUNCHES[name] == launches + 2
    assert r["mismatches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[1000] * 256, list(np.random.default_rng(5).integers(0, 3000, 256))],
                         ids=["256-of-1000", "256-ragged"])
def test_k_way_merge_all_twice_back_to_back(card, lens):
    """Kind `all` at k = 256 (each list holds list 0 or its neighbour, so
    every round rewrites both scratch buffers with words equal to ones an
    SM read two rounds before): K5 twice back to back, between two pair
    unions over the same words, each equal to plain; one launch a call."""
    args = _t(chip_smoke.merge_lists_case(lens, seed=256, kind="all"), card)
    want = chip_smoke.merge_words("merge_sorted", setop_merge.merge_sorted_plain(*args))
    pairs = _t(chip_smoke.merge_lists_case(lens, seed=257, kind="all"), card)
    launches = setop_merge.LAUNCHES["merge_sorted"]
    got = []
    for _ in range(2):
        setop_merge.union_ragged(*pairs)
        got.append(chip_smoke.merge_words("merge_sorted", setop_merge.merge_sorted(*args)))
    torch.cuda.synchronize()
    assert setop_merge.LAUNCHES["merge_sorted"] == launches + 2
    for off, words in got:
        assert torch.equal(off, want[0]) and torch.equal(words, want[1])


@pytest.mark.cuda
def test_kernels_from_threads_on_two_streams(card):
    assert chip_smoke.merge_from_threads(card, threads=4, calls=10) == []


@pytest.mark.cuda
def test_dispatcher_chain_and_union_on_card(card):
    """The forced device path's union pairs across 2^32 and one-segment
    chains on the card, equal to numpy; the kernels launched."""
    d = dispatch.SetOpDispatcher(device=card)
    rng = np.random.default_rng(3)
    launches = dict(setop_merge.LAUNCHES)
    with chip_smoke.forced_device():
        pairs = [(_straddle(rng, 3000), _straddle(rng, 20000)) for _ in range(3)]
        for (a, b), got in zip(pairs, d.run_pairs("union", pairs)):
            np.testing.assert_array_equal(got, np.union1d(a, b))
        parts = [np.unique(rng.integers(10, 90000, size=5000, dtype=np.uint64)) for _ in range(3)]
        np.testing.assert_array_equal(d.run_chain("union", parts),
                                      np.union1d(np.union1d(parts[0], parts[1]), parts[2]))
        np.testing.assert_array_equal(
            d.run_chain("intersect", parts),
            np.intersect1d(np.intersect1d(parts[0], parts[1]), parts[2]))
    assert all(setop_merge.LAUNCHES[w] > launches[w] for w in launches)
