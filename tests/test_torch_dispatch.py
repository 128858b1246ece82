"""The port's set-op dispatcher against the JAX reference dispatcher.

Each public entry point (`run_pairs`, `run_rows_vs_one`,
`run_rows_vs_one_ragged`, `run_chain`) runs the same seeded operands
through `dgraph_tpu.query.dispatch.SetOpDispatcher` (jax on the CPU) and
`dgraph_tpu_torch.query.dispatch.SetOpDispatcher(device="cpu")`, with the
FORCE_DEVICE and PALLAS knobs patched the same way in both modules (the
knobs are module globals read at import). Operands straddle the 2^32
segment boundary and include compressed (packed) posting lists. Results
must be equal exactly, and equal to numpy's set ops. The forced device
path uploads a shared operand once, whole, never splits rows one by one,
runs each entry's intersect or difference in one setop_rows call, and
caches its uploads under tokens that a commit drops.
Last, the reference's own tests of these paths (tests/
test_shortest_recurse.py, and test_dispatch_cache.py's chain and cache
cases) run on both packages through the runner of
tests/test_torch_graphql.py, the port's side on the forced device path.
"""

import numpy as np
import pytest

import torch
from test_torch_graphql import cases, run_both, runner  # noqa: F401 - fixture

from dgraph_tpu.codec import uidpack as ref_uidpack
from dgraph_tpu.query import dispatch as ref
from dgraph_tpu_torch.codec import uidpack as port_uidpack
from dgraph_tpu_torch.ops import member_sweep, setop_rows
from dgraph_tpu_torch.posting.memlayer import MemoryLayer
from dgraph_tpu_torch.query import dispatch as port

SEG = 1 << 32
# (FORCE_DEVICE, PALLAS): the host path, the device path, the device
# path with the member sweep for small-side intersect buckets
MODES = [(False, False), (True, False), (True, True)]
MODE_IDS = ["host", "device", "device-sweep"]

NP_OPS = {
    "intersect": lambda a, b: np.intersect1d(a, b, assume_unique=True),
    "difference": lambda a, b: np.setdiff1d(a, b, assume_unique=True),
    "union": np.union1d,
}


@pytest.fixture
def pair(request, monkeypatch):
    force, pallas = request.param
    for mod in (ref, port):
        monkeypatch.setattr(mod, "_FORCE_DEVICE", force)
        monkeypatch.setattr(mod, "_USE_PALLAS", pallas)
    return ref.SetOpDispatcher(), port.SetOpDispatcher(device="cpu")


def _set(rng, n, lo, hi):
    return np.unique(rng.integers(lo, hi, size=n, dtype=np.uint64))


def _straddle(rng, n, width=4000):
    """A sorted set with members on both sides of 2^32."""
    return np.union1d(
        _set(rng, n // 2, SEG - width, SEG), _set(rng, n - n // 2, SEG, SEG + width)
    )


def _assert_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.uint64), np.asarray(w, np.uint64))


def _pairs(seed):
    rng = np.random.default_rng(seed)
    big = _straddle(rng, 3000)
    return [
        (_straddle(rng, 100), big),  # small side <= 128 per segment: sweep
        (_straddle(rng, 60), _straddle(rng, 40)),
        (_straddle(rng, 900), big),  # small side > 128: plain batched op
        (_set(rng, 50, 10, 5000), big),  # segments of one side only
        (np.zeros((0,), np.uint64), big),
    ]


@pytest.mark.parametrize("pair", MODES, ids=MODE_IDS, indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference", "union"])
def test_run_pairs(pair, op):
    r, p = pair
    pairs = _pairs(1)
    want = r.run_pairs(op, pairs)
    _assert_lists(p.run_pairs(op, pairs), want)
    _assert_lists(want, [NP_OPS[op](a, b) for a, b in pairs])


@pytest.mark.parametrize("pair", MODES, ids=MODE_IDS, indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference", "union"])
@pytest.mark.parametrize("segments", [1, 2])
def test_run_rows_vs_one(pair, op, segments):
    r, p = pair
    rng = np.random.default_rng(2 + segments)
    def mk(n):
        return _set(rng, n, 100, 9000) if segments == 1 else _straddle(rng, n)

    rows = [mk(int(n)) for n in rng.integers(0, 120, size=9)]
    b = mk(2500)
    want = r.run_rows_vs_one(op, rows, b)
    _assert_lists(p.run_rows_vs_one(op, rows, b), want)
    _assert_lists(want, [NP_OPS[op](x, b) for x in rows])


@pytest.mark.parametrize("pair", MODES, ids=MODE_IDS, indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_run_rows_vs_one_ragged(pair, op):
    r, p = pair
    rng = np.random.default_rng(4)
    rows = [_straddle(rng, int(n)) for n in rng.integers(0, 100, size=12)]
    flat = np.concatenate(rows).astype(np.uint64)
    offs = np.zeros((len(rows) + 1,), np.int64)
    np.cumsum([len(x) for x in rows], out=offs[1:])
    b = _straddle(rng, 1500)
    wf, wo = r.run_rows_vs_one_ragged(op, flat, offs, b)
    gf, go = p.run_rows_vs_one_ragged(op, flat, offs, b)
    np.testing.assert_array_equal(go, wo)
    np.testing.assert_array_equal(np.asarray(gf, np.uint64), np.asarray(wf, np.uint64))
    want = np.concatenate([NP_OPS[op](x, b) for x in rows])
    np.testing.assert_array_equal(np.asarray(wf, np.uint64), want)


@pytest.mark.parametrize("pair", MODES, ids=MODE_IDS, indirect=True)
@pytest.mark.parametrize("op", ["intersect", "union"])
@pytest.mark.parametrize("segments", [1, 2])
def test_run_chain(pair, op, segments):
    r, p = pair
    rng = np.random.default_rng(5 + segments)
    if segments == 1:
        parts = [_set(rng, 2000, 1, 6000) for _ in range(3)]
    else:
        parts = [_straddle(rng, 2000) for _ in range(3)]
    want = r.run_chain(op, parts)
    np.testing.assert_array_equal(p.run_chain(op, parts), want)
    fold = parts[0]
    for x in parts[1:]:
        fold = NP_OPS[op](fold, x)
    np.testing.assert_array_equal(want, fold)


def _packed(mod, uidpack, uids):
    return mod.PackedOperand(uidpack.encode(uids))


@pytest.mark.parametrize("pair", MODES, ids=MODE_IDS, indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_packed_operands(pair, op):
    """Compressed posting lists on either side of a pair and in a chain."""
    r, p = pair
    rng = np.random.default_rng(9)
    big = _straddle(rng, 20000, width=60000)
    small = _straddle(rng, 40, width=60000)
    mid = _straddle(rng, 3000, width=60000)

    def pairs(mod, up):
        return [
            (small, _packed(mod, up, big)),
            (_packed(mod, up, mid), _packed(mod, up, big)),
            (mid, _packed(mod, up, small)),
        ]

    want = r.run_pairs(op, pairs(ref, ref_uidpack))
    _assert_lists(p.run_pairs(op, pairs(port, port_uidpack)), want)
    _assert_lists(want, [NP_OPS[op](a, b) for a, b in [(small, big), (mid, big), (mid, small)]])
    if op == "intersect":
        wc = r.run_chain(op, [small, _packed(ref, ref_uidpack, big), mid])
        gc = p.run_chain(op, [small, _packed(port, port_uidpack, big), mid])
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("pair", [(True, True)], ids=["device-sweep"], indirect=True)
def test_small_intersect_buckets_take_the_sweep(pair):
    _, p = pair
    calls = member_sweep.PLAIN_CALLS
    p.run_pairs("intersect", _pairs(3)[:1])
    assert member_sweep.PLAIN_CALLS > calls
    calls = member_sweep.PLAIN_CALLS
    p.run_pairs("difference", _pairs(3)[:1])
    assert member_sweep.PLAIN_CALLS == calls


def test_device_cache_reuse_and_commit_invalidation(monkeypatch):
    """Cached uploads are reused by token, and the port's MemoryLayer
    clears the port's device cache on commit invalidation."""
    monkeypatch.setattr(port, "_FORCE_DEVICE", True)
    d = port.DISPATCHER
    d.bind("cpu")
    d.device_cache.clear()
    rng = np.random.default_rng(10)
    rows = [_set(rng, 100, 1, 5000) for _ in range(6)]
    toks = [(b"row%d" % i, 3) for i in range(6)]
    b = _set(rng, 1000, 1, 5000)
    first = d.run_rows_vs_one("intersect", rows, b, row_tokens=toks, b_token=(b"big", 3))
    hits = d.device_cache.hits
    again = d.run_rows_vs_one("intersect", rows, b, row_tokens=toks, b_token=(b"big", 3))
    assert d.device_cache.hits >= hits + 2
    _assert_lists(again, first)
    mem = MemoryLayer()
    mem.invalidate([b"big"])
    assert d.device_cache.stats()["entries"] == 1  # the stacked rows remain
    mem.invalidate_prefix([b"row"])
    assert d.device_cache.stats()["entries"] == 0


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port.resolve_device("cuda")
    d = port.SetOpDispatcher(device="cpu")
    with pytest.raises(RuntimeError):
        d.bind("cuda")
    assert d.device.type == "cpu"


def _ragged(rows):
    flat = np.concatenate(rows).astype(np.uint64)
    offs = np.zeros((len(rows) + 1,), np.int64)
    np.cumsum([len(x) for x in rows], out=offs[1:])
    return flat, offs


@pytest.mark.parametrize("op", ["intersect", "difference"])
@pytest.mark.parametrize("width", [60, 400], ids=["sweep", "setop_rows"])
def test_shared_operand_uploads_once_per_segment(op, width, monkeypatch):
    """Rows across 2^32 against one b on the forced device path, rows the
    member sweep takes on the pair path (60) and wider ones (400): b's lo
    words go up once, whole, its segments as ranges of one table, and come
    from the DeviceCache after; no segment goes up alone and no row is
    split alone; each call is one setop_rows launch and no K1; the
    answers equal the reference dispatcher's and numpy's."""
    monkeypatch.setattr(port, "_FORCE_DEVICE", True)
    monkeypatch.setattr(port, "_USE_PALLAS", True)
    monkeypatch.setattr(ref, "_FORCE_DEVICE", True)
    staged, splits = [], []
    real_stage, real_split = port._stage, port.split_segments
    monkeypatch.setattr(port, "_stage", lambda dev, parts: staged.extend(parts) or real_stage(dev, parts))
    monkeypatch.setattr(port, "split_segments", lambda u: splits.append(len(u)) or real_split(u))
    rng = np.random.default_rng(12)
    rows = [_straddle(rng, int(n)) for n in rng.integers(0, 2 * width, size=40)]
    b = _straddle(rng, 2000)
    segs = real_split(b)
    assert len(segs) == 2
    b_lo = (b & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def uploads():
        """(uploads of b's lo words whole, of each segment's alone)"""
        def n(x):
            return sum(p.size == x.size and np.array_equal(p.view(np.uint32), x) for p in staged)
        return n(b_lo), [n(s32) for s32 in segs.values()]

    d = port.SetOpDispatcher(device="cpu")
    flat, offs = _ragged(rows)
    wf, wo = ref.SetOpDispatcher().run_rows_vs_one_ragged(op, flat, offs, b)
    for call in range(2):
        staged.clear()
        calls, sweeps = setop_rows.PLAIN_CALLS, member_sweep.PLAIN_CALLS
        gf, go = d.run_rows_vs_one_ragged(op, flat, offs, b, b_token=(b"b", 1))
        assert (setop_rows.PLAIN_CALLS - calls, member_sweep.PLAIN_CALLS - sweeps) == (1, 0)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gf, wf)
        assert uploads() == ((1, [0, 0]) if call == 0 else (0, [0, 0]))  # then the cache
    np_op = np.intersect1d if op == "intersect" else np.setdiff1d
    np.testing.assert_array_equal(wf, np.concatenate([np_op(r, b) for r in rows]))
    staged.clear()
    for g, w in zip(d.run_rows_vs_one(op, rows, b), ref.SetOpDispatcher().run_rows_vs_one(op, rows, b)):
        np.testing.assert_array_equal(g, w)
    assert uploads() == (1, [0, 0])
    assert splits == []


@pytest.mark.parametrize("pair", MODES[1:], ids=MODE_IDS[1:], indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_shared_operand_in_other_segments(pair, op):
    """Rows whose segments the shared operand lacks, wholly or in part:
    empty for intersect, whole for difference."""
    r, p = pair
    rng = np.random.default_rng(15)
    rows = [_set(rng, int(k), 10, 5000) for k in (0, 30, 200)] + [_straddle(rng, 90)]
    for b in (_set(rng, 400, 3 * SEG, 3 * SEG + 9000), _set(rng, 400, SEG, SEG + 4000)):
        flat, offs = _ragged(rows)
        wf, wo = r.run_rows_vs_one_ragged(op, flat, offs, b)
        gf, go = p.run_rows_vs_one_ragged(op, flat, offs, b)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(gf, wf)
        _assert_lists(p.run_rows_vs_one(op, rows, b), r.run_rows_vs_one(op, rows, b))
        _assert_lists(r.run_rows_vs_one(op, rows, b), [NP_OPS[op](x, b) for x in rows])


def test_segment_cache_entries_dropped_by_a_commit(monkeypatch):
    """The one ("b", token, len(b)) entry of a shared operand over two
    segments (its lo words and its table of segment ranges) is reused and
    goes when the port's MemoryLayer invalidates its key. Rows over two
    segments are not cached by their tokens, as in the reference, whose
    tokens name no store: rows of another store under the same tokens are
    read as they are."""
    monkeypatch.setattr(port, "_FORCE_DEVICE", True)
    d = port.DISPATCHER
    d.bind("cpu")
    d.device_cache.clear()
    rng = np.random.default_rng(13)
    rows = [_straddle(rng, 300) for _ in range(5)]
    toks = [(b"seg-row%d" % i, 2) for i in range(5)]
    b = _straddle(rng, 3000)
    first = d.run_rows_vs_one("difference", rows, b, row_tokens=toks, b_token=(b"seg-b", 2))
    assert set(d.device_cache._entries) == {("b", (b"seg-b", 2), len(b))}
    B, ranges = d.device_cache.get(("b", (b"seg-b", 2), len(b)))
    np.testing.assert_array_equal(B.numpy().view(np.uint32), (b & np.uint64(0xFFFFFFFF)))
    seg = port.split_segments(b)
    assert ranges.tolist() == [[0, len(seg[min(seg)])], [len(seg[min(seg)]), len(seg[max(seg)])],
                               [0, 0]]  # the last range: empty, for segments b lacks
    hits = d.device_cache.hits
    _assert_lists(d.run_rows_vs_one("difference", rows, b, row_tokens=toks, b_token=(b"seg-b", 2)),
                  first)
    assert d.device_cache.hits == hits + 1
    other = [_straddle(rng, 300) for _ in range(5)]
    _assert_lists(d.run_rows_vs_one("difference", other, b, row_tokens=toks),
                  [NP_OPS["difference"](x, b) for x in other])
    MemoryLayer().invalidate([b"seg-b"])
    assert d.device_cache.stats()["entries"] == 0


def test_kernels_serve_the_device_path(monkeypatch):
    """On the forced device path intersect and difference reach setop_rows
    (its plain version on the CPU) in one call an entry, whatever the
    segments; K1 with its compaction takes intersect pairs of <= 128 a
    segment, and only on the pair path, as the reference's Pallas branch."""
    monkeypatch.setattr(port, "_FORCE_DEVICE", True)
    monkeypatch.setattr(port, "_USE_PALLAS", True)
    d = port.SetOpDispatcher(device="cpu")
    rng = np.random.default_rng(14)
    rows = [_straddle(rng, 500) for _ in range(4)]
    b = _straddle(rng, 2000)
    for op in ("intersect", "difference"):
        calls = setop_rows.PLAIN_CALLS
        d.run_rows_vs_one_ragged(op, *_ragged(rows), b)
        d.run_rows_vs_one(op, rows, b)
        d.run_pairs(op, [(r, b) for r in rows])
        assert setop_rows.PLAIN_CALLS == calls + 3  # two segments each, one launch an entry
    sweeps = member_sweep.PLAIN_CALLS
    small = _straddle(rng, 100)
    d.run_rows_vs_one("intersect", [small], b)
    assert member_sweep.PLAIN_CALLS == sweeps  # not on the shared path
    d.run_pairs("intersect", [(small, b)])
    assert member_sweep.PLAIN_CALLS == sweeps + 1  # both segments pad to one bucket


def _edge_rows(rng):
    """Rows over three segments (b holds two of them), empty rows, and
    uids whose lo word is UINT32_MAX, against b."""
    top = np.array([SEG - 1, 2 * SEG - 1], np.uint64)  # lo word 0xFFFFFFFF
    rows = [np.zeros(0, np.uint64)]
    for n in rng.integers(0, 150, size=20):
        r = np.union1d(_straddle(rng, int(n)), rng.choice(top, size=int(n) % 3))
        if n % 3 == 0:
            r = np.union1d(r, 3 * SEG + rng.integers(0, 50, size=4).astype(np.uint64))
        rows.append(r)
    rows.append(np.zeros(0, np.uint64))
    return rows, np.union1d(_straddle(rng, 2500), top)


@pytest.mark.parametrize("pair", MODES[1:], ids=MODE_IDS[1:], indirect=True)
@pytest.mark.parametrize("op", ["intersect", "difference"])
@pytest.mark.parametrize("entry", ["ragged", "list", "pairs"])
def test_ragged_route_matches_reference(pair, op, entry):
    """The ragged route (one setop_rows call over every sub-row) against
    the reference dispatcher and numpy, over empty rows, rows in a segment
    b lacks and UINT32_MAX lo words."""
    r, p = pair
    rows, b = _edge_rows(np.random.default_rng(16))
    want = [NP_OPS[op](x, b) for x in rows]
    if entry == "ragged":
        flat, offs = _ragged(rows)
        wf, wo = r.run_rows_vs_one_ragged(op, flat, offs, b)
        gf, go = p.run_rows_vs_one_ragged(op, flat, offs, b)
        np.testing.assert_array_equal(go, wo)
        np.testing.assert_array_equal(np.asarray(gf, np.uint64), np.asarray(wf, np.uint64))
        np.testing.assert_array_equal(np.asarray(wf, np.uint64), np.concatenate(want))
    elif entry == "list":
        _assert_lists(p.run_rows_vs_one(op, rows, b), r.run_rows_vs_one(op, rows, b))
        _assert_lists(r.run_rows_vs_one(op, rows, b), want)
    else:
        pairs = [(x, b) for x in rows] + [(b, x) for x in rows[::4]]
        _assert_lists(p.run_pairs(op, pairs), r.run_pairs(op, pairs))
        _assert_lists(r.run_pairs(op, pairs), [NP_OPS[op](x, y) for x, y in pairs])


# ---------------------------------------------------------------------------
# The reference's tests of the rewritten paths, on both packages
# ---------------------------------------------------------------------------

REF_CASES = cases("test_shortest_recurse") + cases(
    "test_dispatch_cache",
    only=["test_run_chain_intersect_matches_numpy", "test_run_chain_union_matches_numpy",
          "test_run_chain_small_host_path", "test_device_cache_hit_and_invalidate",
          "test_device_cache_lru_bound"],
)


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_cases_on_both_packages(case, runner, tmp_path, request, monkeypatch):  # noqa: F811
    """The reference case passes on both packages with equal answers, the
    port's dispatchers (the module's and any it builds) on the CPU."""
    init = port.SetOpDispatcher.__init__
    monkeypatch.setattr(port.SetOpDispatcher, "__init__",
                        lambda self, device="cpu": init(self, device))
    monkeypatch.setattr(port.DISPATCHER, "device", torch.device("cpu"))
    run_both(runner, case, tmp_path, request)


# the reference's test of K11, the executor's device top-k of a `first:`
# ordering over a value variable (ROADMAP Queue 3 B), and cases of the
# top-k itself on both packages (`_k11_case`)
K11_CASES = cases("test_sort_paths", only=["test_device_topk_val_var_first"])
K11_KINDS = ["signed_zeros", "nan", "inf", "ties", "past_one_pass", "offset_near_end",
             "missing"]
K11_EXTRA = [pytest.param(("k11", kind), id=f"k11::{kind}") for kind in K11_KINDS]


def _one_pass_max_k():
    """KV1's largest one-pass k, read from its source (the library that
    answers `vector_topk.onepass_max_k` is built only on a card)."""
    import os
    import re

    from dgraph_tpu_torch.ops import cuda_build

    src = open(os.path.join(cuda_build.CSRC, "vector_topk.cu")).read()
    return int(re.search(r"constexpr int kOnePassMaxK = (\d+);", src).group(1))


def _k11_values(kind, rng):
    """(values by uid index, None where missing; desc; first; offset) of
    one K11 case over at least 4,096 uids."""
    n = 6000
    vals = list(rng.integers(-50, 50, n).astype(float))
    desc, first, offset = True, 10, 0
    nan = float("nan")
    if kind == "signed_zeros":  # 0.0 above -0.0 in lax.top_k's order, either way
        vals = [0.0 if i % 3 else -0.0 for i in range(n)]
        vals[:40] = [0] * 40  # ints: -0.0 once negated for orderasc
        desc, first = False, 200
    elif kind == "nan":  # the sign of a negated NaN is what KV1's order reads
        for i in rng.choice(n, 30, replace=False):
            vals[i] = nan
        vals[7] = -nan
        desc, first = False, 50
    elif kind == "inf":
        for i in rng.choice(n, 20, replace=False):
            vals[i] = float(rng.choice([np.inf, -np.inf]))
        first = 40
    elif kind == "ties":
        vals = list(rng.integers(0, 3, n).astype(float))
        first, offset = 100, 17
    elif kind == "past_one_pass":  # KV1's radix regime
        first = _one_pass_max_k() + 1000
    elif kind == "offset_near_end":
        first, offset = 7, n - 10
    elif kind == "missing":  # missing values rank last
        vals = [v if i % 4 else None for i, v in enumerate(vals)]
        desc, first = False, 3000
    return vals, desc, first, offset


def _k11_case(kind):
    """`Executor._order_uids_topk` of both packages on the same uids and
    values: the answers equal, and their window equal to numpy's order
    (the float32 scores by the IEEE total order, descending, ties to the
    lower index); the port's through KV1's wrapper (here its plain
    version)."""
    from types import SimpleNamespace

    from dgraph_tpu.query import subgraph as ref_subgraph
    from dgraph_tpu_torch.ops import vector_topk
    from dgraph_tpu_torch.query import subgraph

    rng = np.random.default_rng(K11_KINDS.index(kind))
    vals, desc, first, offset = _k11_values(kind, rng)
    uids = np.unique(rng.integers(1, 1 << 40, 2 * len(vals), dtype=np.uint64))[: len(vals)]
    var = {int(u): SimpleNamespace(value=v) for u, v in zip(uids, vals) if v is not None}
    this = SimpleNamespace(val_vars={"v": var})
    gq = SimpleNamespace(first=first, offset=offset, after=None)
    o = SimpleNamespace(val_var="v", desc=desc)
    want = ref_subgraph.Executor._order_uids_topk(this, gq, o, uids)
    before = vector_topk.PLAIN_CALLS
    got = subgraph.Executor._order_uids_topk(this, gq, o, uids)
    assert vector_topk.PLAIN_CALLS - before == 1
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    present = np.array([v is not None for v in vals])
    sc = np.where(present, np.array([0.0 if v is None else v for v in vals]), 0.0)
    sc = np.where(present, sc if desc else -sc, -np.inf).astype(np.float32)
    bits = sc.view(np.uint32).astype(np.int64)
    key = np.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | (1 << 31))  # total order
    order = np.lexsort((np.arange(len(sc)), -key))
    k = min(offset + first, int(present.sum()))
    np.testing.assert_array_equal(got[:k], uids[order[:k]])


@pytest.mark.parametrize("case", K11_CASES + K11_EXTRA)
def test_device_topk_on_both_packages(case, runner, tmp_path, request, monkeypatch):  # noqa: F811
    """The reference's `test_device_topk_val_var_first` passes on both
    packages with equal answers, the port's on the forced device path,
    where `Executor._order_uids_topk` (K11, `REPAIRED`) takes its device
    top-k: 6,000 uids, above its 4,096 threshold. The `k11::` cases call
    the top-k of both packages on the same values (`_k11_case`): -0.0
    against 0.0, NaN of either sign, +-inf, heavy ties, a k past KV1's
    one-pass limit, an offset near the end and missing values."""
    from dgraph_tpu_torch.query import subgraph

    monkeypatch.setattr(port.DISPATCHER, "device", torch.device("cpu"))
    if case[0] == "k11":
        _k11_case(case[1])
        return
    taken = []
    real = subgraph.Executor._order_uids_topk

    def order_uids_topk(self, *a):
        got = real(self, *a)
        taken.append(got is not None)
        return got

    monkeypatch.setattr(subgraph.Executor, "_order_uids_topk", order_uids_topk)
    init = port.SetOpDispatcher.__init__
    monkeypatch.setattr(port.SetOpDispatcher, "__init__",
                        lambda self, device="cpu": init(self, device))
    monkeypatch.setattr(port.DISPATCHER, "device", torch.device("cpu"))
    run_both(runner, case, tmp_path, request)
    assert taken and all(taken)


def test_order_reads_phase_on_cpu():
    """chip_smoke's K11 reads (o) and (o2) (`order_reads`) on a host
    Server over a graph of 4,160 level-2 nodes: each answer on the forced
    device path equals the host path's and numpy's order, the executor
    takes its top-k, and KV1's wrapper runs once a read at K11's shape,
    (1, uids) with k = offset + first."""
    from dgraph_tpu_torch.api.server import Server

    import chip_smoke

    g = chip_smoke.make_graph(fanout=8, pool=2000, roots=520)
    server = Server(device="cpu")
    server.slow_query_ms = float("inf")
    chip_smoke.load_graph(server, g)
    out = chip_smoke.order_reads(server, g, reps=1, log=lambda m: None)
    assert out["launches"] == 2
    assert sorted(out["captured"][0]) == [((1, 4160), 15, "distance", False),
                                          ((1, 4160), 60, "distance", False)]
    assert [len(chip_smoke.expected_order(g, n)) for n in ("o", "o2")] == [10, 20]
