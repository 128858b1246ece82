"""The port's serving front against the JAX reference's, on the CPU.

Every case runs once on the reference (`dgraph_tpu.api.server.Server`,
jax on the CPU) and once on the port (`Server(device="cpu")`, with every
set op forced onto the device path and the member sweep on, so the plain
versions of its kernels run), on the same inputs. The port's answers
must equal the reference's byte for byte; each side must also meet the
reference test's own contract. The reference runs on its default
dispatch path (forcing it would compile a jax program per shape).

Cases, by the reference test they come from:

- tests/test_serving_front.py: the golden smoke subset at batch windows
  0 and 200, solo and from four threads at once; the off switch; demux
  slices equal to solo reads; the batcher's snapshot token; the plan
  cache's hit, reuse safety, epoch invalidation, correctness under
  concurrent mutation and LRU bound; admission's shed, admit-one and
  degrade (the HTTP 429 case waits for the HTTP server's port);
- tests/test_planner.py: the result cache on the golden smoke subset
  (the populating miss and the hit), its LRU/TTL/key unit case, never
  stale after a mutation nor under a concurrent writer (group commit
  on), pinned read timestamps and fresh dict hits;
- tests/test_rdf_output.py: `query_rdf` (all but the gRPC and HTTP
  surfaces, not ported yet);
- tests/test_vector_quant.py: concurrent `similar_to` coalesced by the
  micro-batcher into one `search_batch`, each row equal to its solo
  search, on the port's index and through the port's Server.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu.models import vector as ref_vector
from dgraph_tpu.posting.lists import LocalCache as RefLocalCache
from dgraph_tpu.query import subgraph as ref_subgraph
from dgraph_tpu.serving import TooManyRequestsError as RefTooMany
from dgraph_tpu.serving.front import ServingFront as RefFront
from dgraph_tpu.serving.microbatch import MicroBatcher as RefBatcher
from dgraph_tpu.serving.plancache import PlanCache as RefPlanCache
from dgraph_tpu.serving.plancache import normalize as ref_normalize
from dgraph_tpu.serving.resultcache import ResultCache as RefResultCache
from dgraph_tpu.utils import observe as ref_observe
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.models import vector
from dgraph_tpu_torch.ops import ivf_scan, member_sweep, setop_rows, vector_topk
from dgraph_tpu_torch.posting.lists import LocalCache
from dgraph_tpu_torch.query import dispatch, subgraph
from dgraph_tpu_torch.serving import TooManyRequestsError
from dgraph_tpu_torch.serving.front import ServingFront
from dgraph_tpu_torch.serving.microbatch import MicroBatcher
from dgraph_tpu_torch.serving.plancache import PlanCache, normalize
from dgraph_tpu_torch.serving.resultcache import ResultCache
from dgraph_tpu_torch.utils import observe

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ref_golden")
CASES = json.load(open(os.path.join(HERE, "cases.json")))
SMOKE_CASES = CASES[::9]
SIDES = ["ref", "port"]

M = {
    "ref": SimpleNamespace(
        Server=RefServer, METRICS=ref_observe.METRICS, TRACER=ref_observe.TRACER,
        parse_traceparent=ref_observe.parse_traceparent, LocalCache=RefLocalCache,
        MicroBatcher=RefBatcher, ServingFront=RefFront, PlanCache=RefPlanCache,
        normalize=ref_normalize, ResultCache=RefResultCache,
        TooManyRequestsError=RefTooMany, subgraph=ref_subgraph,
        VectorIndex=ref_vector.VectorIndex,
    ),
    "port": SimpleNamespace(
        Server=lambda **kw: Server(device="cpu", **kw), METRICS=observe.METRICS,
        TRACER=observe.TRACER, parse_traceparent=observe.parse_traceparent,
        LocalCache=LocalCache, MicroBatcher=MicroBatcher, ServingFront=ServingFront,
        PlanCache=PlanCache, normalize=normalize, ResultCache=ResultCache,
        TooManyRequestsError=TooManyRequestsError, subgraph=subgraph,
        VectorIndex=lambda *a, **kw: vector.VectorIndex(*a, device="cpu", **kw),
    ),
}


@pytest.fixture(autouse=True)
def forced(monkeypatch):
    """The port's set ops on the device path with the member sweep on."""
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    monkeypatch.setattr(dispatch, "_USE_PALLAS", True)


def _read(name):
    with open(os.path.join(HERE, name)) as f:
        return f.read()


def _load_golden(server):
    server.alter(_read("schema.txt"))
    for rdf in ("triples.rdf", "triples_facets.rdf"):
        server.new_txn().mutate_rdf(set_rdf=_read(rdf), commit_now=True)
    return server


@pytest.fixture(scope="module")
def golden():
    return {side: _load_golden(M[side].Server()) for side in SIDES}


def _data_bytes(server, q):
    """The response's `data` wire bytes, or the error it raised (both
    sides must fail alike too)."""
    try:
        data = server.query(q, want="raw")["data"]
    except Exception as exc:
        return f"{type(exc).__name__}: {exc}"
    raw = getattr(data, "raw", None)
    if raw is not None:
        return bytes(raw)
    return json.dumps(data, sort_keys=True).encode()  # schema blocks


_REF_BYTES = {}


def _reference(golden, q):
    """The reference's bytes for q at window 0, caches off."""
    if q not in _REF_BYTES:
        _REF_BYTES[q] = _data_bytes(golden["ref"], q)
    return _REF_BYTES[q]


def _threads(n, work):
    ths = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()


# ---------------------------------------------------------------------------
# Micro-batcher (tests/test_serving_front.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", SMOKE_CASES, ids=[c["id"] for c in SMOKE_CASES])
def test_batch_window_smoke_equals_reference(golden, side, case, monkeypatch):
    want = _reference(golden, case["query"])
    for window in ("0", "200"):
        monkeypatch.setenv("DGRAPH_TPU_BATCH_WINDOW_US", window)
        assert _data_bytes(golden[side], case["query"]) == want


@pytest.mark.parametrize("side", SIDES)
def test_smoke_subset_from_four_threads_equals_solo(golden, side, monkeypatch):
    """Every smoke query, asked by four threads at once at window 200 with
    the level reads slowed (so same-key reads pile up behind the running
    dispatch), answers as the reference does alone."""
    s = golden[side]
    want = {c["query"]: _reference(golden, c["query"]) for c in SMOKE_CASES}
    real = s.mem.read_many

    def slow(kv, keys_list, read_ts):
        time.sleep(0.001)
        return real(kv, keys_list, read_ts)

    monkeypatch.setattr(s.mem, "read_many", slow)
    monkeypatch.setenv("DGRAPH_TPU_BATCH_WINDOW_US", "200")
    bad = []
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        for c in SMOKE_CASES[i::2] + SMOKE_CASES[(i + 1) % 2 :: 2]:
            if _data_bytes(s, c["query"]) != want[c["query"]]:
                bad.append(c["id"])

    _threads(4, client)
    assert not bad


@pytest.mark.parametrize("side", SIDES)
def test_window_zero_is_a_true_off_switch(golden, side, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("batcher engaged at BATCH_WINDOW_US=0")

    monkeypatch.setattr(M[side].MicroBatcher, "read_uids", boom)
    monkeypatch.setattr(M[side].MicroBatcher, "read_values", boom)
    monkeypatch.setattr(M[side].MicroBatcher, "read_similar", boom)
    monkeypatch.delenv("DGRAPH_TPU_BATCH_WINDOW_US", raising=False)
    q = SMOKE_CASES[0]["query"]
    assert _data_bytes(golden[side], q) == _reference(golden, q)


MICHONNE = """{ me(func: eq(name, "Michonne")) {
    name
    friend { name friend { name } }
    school { name }
} }"""


@pytest.mark.parametrize("side", SIDES)
def test_concurrent_queries_coalesce_and_equal_reference(golden, side, monkeypatch):
    s, metrics = golden[side], M[side].METRICS
    base = _reference(golden, MICHONNE)
    assert _data_bytes(s, MICHONNE) == base
    real = s.mem.read_many

    def slow(kv, keys_list, read_ts):
        time.sleep(0.002)
        return real(kv, keys_list, read_ts)

    monkeypatch.setattr(s.mem, "read_many", slow)
    monkeypatch.setenv("DGRAPH_TPU_BATCH_WINDOW_US", "20000")
    before = metrics.value("batch_coalesced_total")
    results = []
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        for _ in range(20):
            results.append(_data_bytes(s, MICHONNE))

    _threads(4, client)
    assert len(results) == 80 and all(r == base for r in results)
    assert metrics.value("batch_coalesced_total") > before


class _StubCache:
    """A cache whose first uids_many blocks until released (the running
    dispatch the next batch forms behind)."""

    kv = object()
    mem = object()
    read_ts = 3

    def __init__(self):
        self.calls = 0
        self.first_started = threading.Event()
        self.release = threading.Event()

    def uids_many(self, keys_list):
        self.calls += 1
        if self.calls == 1:
            self.first_started.set()
            self.release.wait(5)
        rows = [np.arange(int(k), dtype=np.uint64) for k in keys_list]
        offs = np.zeros(len(rows) + 1, dtype=np.int64)
        offs[1:] = np.cumsum([len(r) for r in rows])
        flat = np.concatenate(rows) if rows else np.zeros(0, np.uint64)
        return flat, offs, [("tok", int(k)) for k in keys_list]


def _run_behind_runner(batcher, member, first, later, monkeypatch, release):
    """`first` dispatches and blocks; each of `later` starts while it
    runs, so they form the next batch; then the runner is released."""
    monkeypatch.setenv("DGRAPH_TPU_BATCH_WINDOW_US", "1000000")
    ths = [threading.Thread(target=member, args=first)]
    ths[0].start()
    release[0].wait(5)
    try:
        for args in later:
            th = threading.Thread(target=member, args=args)
            th.start()
            ths.append(th)
            time.sleep(0.05)
    finally:
        release[1].set()
    for th in ths:
        th.join(10)


@pytest.mark.parametrize("side", SIDES)
def test_batcher_demux_slices_match_solo_reads(side, monkeypatch):
    metrics = M[side].METRICS
    cache = _StubCache()
    b = M[side].MicroBatcher(inflight_fn=lambda: 4)
    out = {}

    def member(name, keys):
        out[name] = b.read_uids("p", cache, keys)

    before = metrics.value("batch_coalesced_total")
    _run_behind_runner(b, member, ("z", [1]), [("a", [3, 1]), ("b", [2, 3])],
                       monkeypatch, (cache.first_started, cache.release))
    assert metrics.value("batch_coalesced_total") == before + 2
    for name, keys in (("z", [1]), ("a", [3, 1]), ("b", [2, 3])):
        flat, offs, toks = out[name]
        solo_flat, solo_offs, solo_toks = cache.uids_many(keys)
        assert np.array_equal(flat, solo_flat)
        assert np.array_equal(offs, solo_offs)
        assert list(toks) == list(solo_toks)


@pytest.mark.parametrize("side", SIDES)
def test_batcher_snapshot_token_respects_commits(side):
    s = _one_value_server(side, "name", "n")
    b = s.serving.batcher
    c1 = M[side].LocalCache(s.kv, s.zero.read_ts(), mem=s.mem)
    t1 = b._snapshot_token(c1)
    s.new_txn().mutate_rdf(set_rdf='<0x9999> <name> "snapshot-probe" .', commit_now=True)
    c2 = M[side].LocalCache(s.kv, s.zero.read_ts(), mem=s.mem)
    t2 = b._snapshot_token(c2)
    assert t1 != t2
    assert b._snapshot_token(c1) != t2


# ---------------------------------------------------------------------------
# Plan cache (tests/test_serving_front.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_normalize_strips_values_and_whitespace(side):
    norm = M[side].normalize
    a = norm('{ q(func: eq(name, "Alice"), first: 5) { name } }')
    b = norm('{  q(func: eq(name,   "Bob"), first: 17) {\n name }\n }')
    c = norm('{ q(func: eq(age, 3)) { name } }')
    assert a is not None and b is not None and c is not None
    assert a[0] == b[0] and a[1] != b[1] and a[0] != c[0]
    assert (a, b, c) == (ref_normalize('{ q(func: eq(name, "Alice"), first: 5) { name } }'),
                         ref_normalize('{  q(func: eq(name,   "Bob"), first: 17) {\n name }\n }'),
                         ref_normalize('{ q(func: eq(age, 3)) { name } }'))


@pytest.mark.parametrize("side", SIDES)
def test_plan_cache_hit_and_variant_semantics(golden, side):
    s, metrics = golden[side], M[side].METRICS
    q1 = '{ q(func: eq(name, "Michonne")) { name } }'
    q2 = '{ q(func: eq(name, "Rick Grimes")) { name } }'
    h0 = metrics.value("plan_cache_hit_total")
    r1a, r1b = _data_bytes(s, q1), _data_bytes(s, q1)
    assert r1a == r1b == _reference(golden, q1)
    assert metrics.value("plan_cache_hit_total") > h0
    r2 = _data_bytes(s, q2)
    assert b"Rick" in r2 and r2 != r1a and r2 == _reference(golden, q2)
    st = s.serving.plan_cache.stats()
    assert st["shapes"] >= 1 and st["hits"] >= 1


@pytest.mark.parametrize("side", SIDES)
def test_plan_cache_reuse_is_execution_safe(golden, side):
    for q in (
        '{ q(func: eq(name, "Michonne")) { expand(_all_) } }',
        '{ q(func: eq(name, "Michonne")) @recurse(depth: 3) { name friend } }',
        '{ q(func: eq(name, "Michonne")) { name friend @facets (first: 2) { name } } }',
    ):
        first = _data_bytes(golden[side], q)
        assert first == _reference(golden, q)
        for _ in range(3):
            assert _data_bytes(golden[side], q) == first


def _one_value_server(side, pred, value):
    s = M[side].Server()
    s.alter(f"{pred}: string @index(exact) .")
    s.new_txn().mutate_rdf(set_rdf=f'<0x1> <{pred}> "{value}" .', commit_now=True)
    return s


@pytest.mark.parametrize("side", SIDES)
def test_plan_cache_epoch_invalidation_no_stale_plans(side):
    s = _one_value_server(side, "pname", "v0")
    q = "{ q(func: has(pname)) { pname } }"
    assert s.query(q)["data"]["q"][0]["pname"] == "v0"
    e0 = s.serving.plan_cache.epoch
    s.new_txn().mutate_rdf(set_rdf='<0x1> <pname> "v1" .', commit_now=True)
    assert s.serving.plan_cache.epoch > e0
    assert s.query(q)["data"]["q"][0]["pname"] == "v1"


@pytest.mark.parametrize("side", SIDES)
def test_plan_cache_correct_under_concurrent_mutation(side):
    """Readers racing a writer through group commit see only committed
    values, and the last read the last value."""
    s = _one_value_server(side, "cname", "w0")
    q = "{ q(func: has(cname)) { cname } }"
    stop = threading.Event()
    versions = ["w0"]
    errs = []

    def mutator():
        for i in range(1, 25):
            versions.append(f"w{i}")  # legal before its commit lands
            s.new_txn().mutate_rdf(set_rdf=f'<0x1> <cname> "w{i}" .', commit_now=True)
            time.sleep(0.001)
        stop.set()

    def reader():
        while not stop.is_set():
            try:
                val = s.query(q)["data"]["q"][0]["cname"]
                if val not in versions:
                    errs.append(val)
            except Exception as exc:
                errs.append(repr(exc))

    ths = [threading.Thread(target=mutator)] + [threading.Thread(target=reader) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    assert not errs, errs
    assert s.query(q)["data"]["q"][0]["cname"] == "w24"


@pytest.mark.parametrize("side", SIDES)
def test_plan_cache_lru_bound(side):
    pc = M[side].PlanCache(size=4)
    for i in range(10):
        pc.put(f"shape{i}", ("x",), [i])
    assert pc.stats()["shapes"] <= 4
    assert pc.get("shape9", ("x",)) == [9]
    assert pc.get("shape0", ("x",)) is None


# ---------------------------------------------------------------------------
# Admission (tests/test_serving_front.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_admission_sheds_over_budget_and_is_retryable(side, monkeypatch):
    m = M[side]
    monkeypatch.setenv("DGRAPH_TPU_ADMISSION", "1")
    monkeypatch.setenv("DGRAPH_TPU_MAX_INFLIGHT", "2")
    front = m.ServingFront()
    t1, t2 = front.admit(None), front.admit(None)
    shed0 = m.METRICS.value("admission_shed_total")
    with pytest.raises(m.TooManyRequestsError) as exc:
        front.admit(None)
    assert exc.value.retryable and exc.value.code == "too_many_requests"
    assert m.METRICS.value("admission_shed_total") == shed0 + 1
    front.finish(t1, None, 1.0)
    t3 = front.admit(None)
    front.finish(t2, None, 1.0)
    front.finish(t3, None, 1.0)
    assert front.admission.inflight == 0


@pytest.mark.parametrize("side", SIDES)
def test_admission_sheds_a_server_query_retryably(side, monkeypatch):
    """The same gate in front of Server.query: with the budget held, a
    query raises the retryable error before it leases a timestamp; once
    released, it answers as the reference does."""
    monkeypatch.setenv("DGRAPH_TPU_ADMISSION", "1")
    monkeypatch.setenv("DGRAPH_TPU_MAX_INFLIGHT", "1")
    s = _one_value_server(side, "hname", "h")
    q = "{ q(func: has(hname)) { hname } }"
    held = s.serving.admit(None)
    leased = s.zero.max_assigned
    with pytest.raises(M[side].TooManyRequestsError) as exc:
        s.query(q)
    assert exc.value.retryable and s.zero.max_assigned == leased
    s.serving.finish(held, None, 1.0)
    assert s.query(q, want="raw")["data"].raw == b'{"q":[{"hname":"h"}]}'


@pytest.mark.parametrize("side", SIDES)
def test_admission_idle_server_always_admits_one(side, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_ADMISSION", "1")
    monkeypatch.setenv("DGRAPH_TPU_MAX_INFLIGHT", "1")
    front = M[side].ServingFront()
    front.plan_cache.observe_cost("big", 10000.0)
    t = front.admit("big")
    assert t.cost > 1.0
    front.finish(t, "big", 5.0)


@pytest.mark.parametrize("side", SIDES)
def test_admission_degrades_when_slow_query_signal_fires(side, monkeypatch):
    m = M[side]
    monkeypatch.setenv("DGRAPH_TPU_ADMISSION", "1")
    monkeypatch.setenv("DGRAPH_TPU_MAX_INFLIGHT", "64")
    front = m.ServingFront()
    d0 = m.METRICS.value("admission_degraded_total")
    for _ in range(6):
        front.admission.note_slow()
    t = front.admit(None)
    assert t.degrade
    assert m.METRICS.value("admission_degraded_total") == d0 + 1
    front.finish(t, None, 1.0)


@pytest.mark.parametrize("side", SIDES)
def test_pool_bounded_submit_and_gauge(side, monkeypatch):
    sg = M[side].subgraph
    monkeypatch.setattr(sg, "_POOL_QUEUED", 8)
    pool = sg._expand_pool(2)
    assert sg._submit_bounded(pool, 2, lambda: None) is None
    monkeypatch.setattr(sg, "_POOL_QUEUED", 0)
    fut = sg._submit_bounded(pool, 2, lambda: 41)
    assert fut is not None and fut.result() == 41
    assert sg.pool_backpressure()[0] == 0


# ---------------------------------------------------------------------------
# Result cache (tests/test_planner.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", SMOKE_CASES, ids=[c["id"] for c in SMOKE_CASES])
def test_golden_result_cache_equals_reference(golden, side, case, monkeypatch):
    q = case["query"]
    want = _reference(golden, q)
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "0")
    assert _data_bytes(golden[side], q) == want
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "4096")
    assert _data_bytes(golden[side], q) == want  # the populating miss
    assert _data_bytes(golden[side], q) == want  # the hit: never stale


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_lru_and_ttl_unit(side):
    RC = M[side].ResultCache
    rc = RC(size=2, ttl_s=0.0)
    k1, k2, k3 = (rc.key("s", (x,), None, 0, 7, epoch=1) for x in "abc")
    rc.put(k1, b"1")
    rc.put(k2, b"2")
    assert rc.get(k1) == b"1"
    rc.put(k3, b"3")  # evicts k2 (k1 was refreshed by the get)
    assert rc.get(k2) is None
    assert rc.get(k1) == b"1" and rc.get(k3) == b"3"
    rcb = RC(size=100, ttl_s=0.0, max_bytes=10)
    rcb.put(k1, b"aaaa")
    rcb.put(k2, b"bbbb")
    rcb.put(k3, b"cccc")
    assert rcb.get(k1) is None
    assert rcb.get(k2) == b"bbbb" and rcb.get(k3) == b"cccc"
    assert rcb.stats()["bytes"] == 8
    rcb.put(rc.key("s", ("d",), None, 0, 7, 1), b"x" * 64)
    assert rcb.get(k2) == b"bbbb"
    rc2 = RC(size=8, ttl_s=1e-9)
    rc2.put(k1, b"1")
    time.sleep(0.01)
    assert rc2.get(k1) is None
    assert rc.key("s", ("a",), None, 0, 7, 1) != rc.key("s", ("a",), None, 0, 8, 1)
    assert rc.key("s", ("a",), None, 0, 7, 1) != rc.key("s", ("a",), None, 0, 7, 2)
    assert rc.key("s", ("a",), None, 1, 7, 1) != rc.key("s", ("a",), None, 0, 7, 1)
    assert rc.key("s", ("a",), {"$x": "1"}, 0, 7, 1) != rc.key("s", ("a",), {"$x": "2"}, 0, 7, 1)


def _counter_server(side):
    s = M[side].Server()
    s.alter("v: int .\nname: string @index(exact) .")
    s.new_txn().mutate_rdf(
        set_rdf='<0x1> <name> "c" .\n<0x1> <v> "0"^^<xs:int> .', commit_now=True
    )
    return s


COUNTER_Q = '{ q(func: eq(name, "c")) { v } }'


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_never_stale_after_mutation(side, monkeypatch):
    metrics = M[side].METRICS
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "64")
    s = _counter_server(side)
    assert s.query(COUNTER_Q)["data"]["q"] == [{"v": 0}]
    h0 = metrics.value("result_cache_hit_total")
    assert s.query(COUNTER_Q)["data"]["q"] == [{"v": 0}]
    assert metrics.value("result_cache_hit_total") == h0 + 1
    for i in range(1, 6):
        s.new_txn().mutate_rdf(set_rdf=f'<0x1> <v> "{i}"^^<xs:int> .', commit_now=True)
        assert s.query(COUNTER_Q)["data"]["q"] == [{"v": i}]


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_invalidation_under_concurrent_mutation(side, monkeypatch):
    """A writer (group commit on) advances a counter while two cached
    readers read it: each reader's values never decrease, and the last
    read sees the last commit."""
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "256")
    monkeypatch.setenv("DGRAPH_TPU_GROUP_COMMIT", "1")
    s = _counter_server(side)
    n = 60
    seen = [[], []]
    stop = threading.Event()

    def reader(i):
        while not stop.is_set():
            got = s.query(COUNTER_Q)["data"]["q"]
            if got:
                seen[i].append(got[0]["v"])

    ths = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for th in ths:
        th.start()
    for i in range(1, n + 1):
        s.new_txn().mutate_rdf(set_rdf=f'<0x1> <v> "{i}"^^<xs:int> .', commit_now=True)
    stop.set()
    for th in ths:
        th.join()
    assert s.query(COUNTER_Q)["data"]["q"] == [{"v": n}]
    for mine in seen:
        assert all(a <= b for a, b in zip(mine, mine[1:]))
        assert all(0 <= v <= n for v in mine)


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_pinned_read_ts_never_caches(side, monkeypatch):
    metrics = M[side].METRICS
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "64")
    s = _one_value_server(side, "name", "a")
    q = '{ q(func: eq(name, "a")) { name } }'
    ts = s.zero.read_ts()
    m0 = metrics.value("result_cache_miss_total")
    h0 = metrics.value("result_cache_hit_total")
    s.query(q, read_ts=ts)
    s.query(q, read_ts=ts)
    assert metrics.value("result_cache_miss_total") == m0
    assert metrics.value("result_cache_hit_total") == h0


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_dict_hits_are_fresh_objects(side, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "64")
    s = _one_value_server(side, "name", "a")
    q = '{ q(func: eq(name, "a")) { name } }'
    first = s.query(q)["data"]
    second = s.query(q)["data"]
    second["q"][0]["name"] = "MUTATED"
    assert s.query(q)["data"]["q"] == [{"name": "a"}]
    assert first["q"] == [{"name": "a"}]


@pytest.mark.parametrize("side", SIDES)
def test_result_cache_hit_bytes_and_extensions(side, monkeypatch):
    """A hit serves the miss's bytes and says so in the plan's
    result-cache tier; a commit makes the next read a miss."""
    monkeypatch.setenv("DGRAPH_TPU_RESULT_CACHE_SIZE", "64")
    s = _counter_server(side)
    miss = s.query(COUNTER_Q, want="raw")
    hit = s.query(COUNTER_Q, want="raw", debug=True)
    assert hit["data"].raw == miss["data"].raw == b'{"q":[{"v":0}]}'
    assert hit["extensions"]["plan"]["result_cache"]["would_hit"] is True
    s.new_txn().mutate_rdf(set_rdf='<0x1> <v> "1"^^<xs:int> .', commit_now=True)
    after = s.query(COUNTER_Q, want="raw", debug=True)
    assert after["extensions"]["plan"]["result_cache"]["would_hit"] is False
    assert after["data"].raw == b'{"q":[{"v":1}]}'


# ---------------------------------------------------------------------------
# RDF output (tests/test_rdf_output.py)
# ---------------------------------------------------------------------------

RDF_SCHEMA = "name: string @index(exact) .\nfriend: [uid] .\nage: int .\nalive: bool ."
RDF_DATA = (
    '<0x1> <name> "Alice" .\n<0x1> <age> "30"^^<xs:int> .\n'
    '<0x1> <alive> "true"^^<xs:boolean> .\n<0x1> <friend> <0x2> .\n'
    '<0x2> <name> "Bob" .'
)
RDF_Q = '{ q(func: eq(name, "Alice")) { name age alive friend { name } } }'


@pytest.fixture(scope="module")
def rdf_servers():
    out = {}
    for side in SIDES:
        s = M[side].Server()
        s.alter(RDF_SCHEMA)
        s.new_txn().mutate_rdf(set_rdf=RDF_DATA, commit_now=True)
        out[side] = s
    return out


@pytest.mark.parametrize("side", SIDES)
def test_query_rdf_triples_equal_reference(rdf_servers, side):
    rdf = rdf_servers[side].query_rdf(RDF_Q)
    assert rdf == rdf_servers["ref"].query_rdf(RDF_Q)
    lines = set(rdf.strip().splitlines())
    for line in ('<0x1> <name> "Alice" .', '<0x1> <age> "30"^^<xs:int> .',
                 '<0x1> <alive> "true"^^<xs:boolean> .', "<0x1> <friend> <0x2> .",
                 '<0x2> <name> "Bob" .'):
        assert line in lines


@pytest.mark.parametrize("side", SIDES)
def test_rdf_round_trips_through_loader(rdf_servers, side):
    rdf = rdf_servers[side].query_rdf('{ q(func: eq(name, "Alice")) { name age friend { name } } }')
    s2 = M[side].Server()
    s2.alter("name: string @index(exact) .\nfriend: [uid] .\nage: int .")
    s2.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
    q = s2.query('{ q(func: eq(name, "Alice")) { age friend { name } } }')["data"]["q"][0]
    assert q["age"] == 30 and q["friend"][0]["name"] == "Bob"


@pytest.mark.parametrize("side", SIDES)
def test_rdf_shares_json_value_formats(side):
    s = M[side].Server()
    s.alter(RDF_SCHEMA)
    s.new_txn().mutate_rdf(
        set_rdf='<0x7> <name> "Tick" .\n'
        '<0x7> <when> "1980-05-01T10:30:00Z"^^<xs:dateTime> .\n'
        '<0x7> <score> "2.5"^^<xs:float> .',
        commit_now=True,
    )
    lines = set(s.query_rdf('{ q(func: eq(name, "Tick")) { name when score } }').strip().splitlines())
    assert '<0x7> <when> "1980-05-01T10:30:00Z"^^<xs:dateTime> .' in lines
    assert '<0x7> <score> "2.5"^^<xs:float> .' in lines
    raw = s.query('{ q(func: eq(name, "Tick")) { when score } }')["data"].raw
    assert b'"when":"1980-05-01T10:30:00Z"' in raw and b'"score":2.5' in raw


@pytest.mark.parametrize("name", ["a", "b"])
def test_query_rdf_on_the_fanout_graph_counts_the_json_answer(name):
    """chip_smoke phase 9's RDF check at a small size: on the forced
    device path (setop_rows runs for (b)) the port's N-Quads equal
    its host path's and the reference's, with one triple per uid edge of
    the JSON answer (neither query asks for a value)."""
    g = chip_smoke.make_graph(fanout=6, pool=400, hot_every=10)
    ref, port = RefServer(), Server(device="cpu")
    chip_smoke.load_graph(ref, g)
    chip_smoke.load_graph(port, g)
    q = chip_smoke.QUERIES[name]
    calls = setop_rows.PLAIN_CALLS
    rdf = port.query_rdf(q)
    assert (setop_rows.PLAIN_CALLS > calls) == (name == "b")
    assert rdf == ref.query_rdf(q)
    assert len(rdf.splitlines()) == chip_smoke.json_edges(
        json.loads(port.query(q, want="raw")["data"].raw))
    dispatch._FORCE_DEVICE = dispatch._USE_PALLAS = False
    assert port.query_rdf(q) == rdf


# ---------------------------------------------------------------------------
# Coalesced similar_to (tests/test_vector_quant.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_read_similar_coalesces_and_demuxes_identically(side, monkeypatch):
    """Members 1 and 2 arrive while member 0's search runs: they become
    ONE search_batch of 2 rows, each row equal to the member's solo
    search (and to the reference's), with the batch_dispatch span linking
    both members' traces."""
    m = M[side]
    rng = np.random.default_rng(11)
    n, d, k = 4000, 16, 6
    V = rng.standard_normal((n, d)).astype(np.float32)
    idx = m.VectorIndex("emb", ivf_threshold=1 << 62)
    idx.bulk_load(np.arange(1, n + 1, dtype=np.uint64), V)
    started, release = threading.Event(), threading.Event()
    calls = []
    real = idx.search_batch

    def gated(Q, kk):
        calls.append(len(Q))
        if len(calls) == 1:
            started.set()
            release.wait(5)
        return real(Q, kk)

    monkeypatch.setattr(idx, "search_batch", gated)
    b = m.MicroBatcher(inflight_fn=lambda: 3)
    queries = rng.standard_normal((3, d)).astype(np.float32)
    solo = [real(q.reshape(1, -1), k)[0] for q in queries]
    results, trace_ids = {}, {}

    class Cache:
        kv = object()
        mem = object()
        read_ts = 11

    def member(i):
        with m.TRACER.span("query") as root:
            trace_ids[i] = root.trace_id
            results[i] = b.read_similar("emb", Cache, idx, queries[i], k)

    before = m.METRICS.value("batch_coalesced_total")
    _run_behind_runner(b, member, (0,), [(1,), (2,)], monkeypatch, (started, release))
    assert sorted(calls) == [1, 2], calls
    assert m.METRICS.value("batch_coalesced_total") == before + 2
    ref_idx = ref_vector.VectorIndex("emb", ivf_threshold=1 << 62)
    ref_idx.bulk_load(np.arange(1, n + 1, dtype=np.uint64), V)
    for i in range(3):
        np.testing.assert_array_equal(results[i], solo[i])
        np.testing.assert_array_equal(results[i], ref_idx.search_one(queries[i], k))
    links = [
        m.parse_traceparent(v).trace_id
        for s in m.TRACER.recent(50) if s["name"] == "batch_dispatch"
        for a, v in s["attrs"].items() if a.startswith("link.")
    ]
    assert {trace_ids[1], trace_ids[2]} <= set(links)


def _vector_server(side, n=300, d=8, seed=12):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, d)).astype(np.float32)
    s = M[side].Server()
    s.alter('emb: float32vector @index(hnsw(metric:"euclidean")) .\nname: string @index(exact) .')
    s.new_txn().mutate_json(
        set_obj=[{"uid": f"0x{i + 1:x}", "name": f"v{i + 1}", "emb": V[i].tolist()}
                 for i in range(n)],
        commit_now=True,
    )
    return s, V


@pytest.mark.parametrize("side", SIDES)
def test_similar_to_coalesced_through_the_server(side, monkeypatch):
    """Four clients' plain similar_to reads coalesce through the Server's
    micro-batcher and answer as each read alone on the reference; with
    VEC_COALESCE=0 the batcher is never asked."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    s, V = _vector_server(side)
    ref_s, _ = _vector_server("ref")
    qs = ['{ q(func: similar_to(emb, 3, "%s")) { name } }'
          % ("[" + ", ".join(f"{x:.6f}" for x in V[i]) + "]") for i in range(6)]
    base = [_data_bytes(ref_s, q) for q in qs]
    assert [_data_bytes(s, q) for q in qs] == base
    idx = s.vector_indexes["emb"]
    real = idx.search_batch

    def slow(Q, kk):
        time.sleep(0.002)
        return real(Q, kk)

    monkeypatch.setattr(idx, "search_batch", slow)
    monkeypatch.setenv("DGRAPH_TPU_BATCH_WINDOW_US", "20000")
    metrics = M[side].METRICS
    before = metrics.value("batch_coalesced_total")
    bad = []
    barrier = threading.Barrier(4)

    def client(w):
        barrier.wait()
        for r in range(10):
            qi = (w + r) % len(qs)
            if _data_bytes(s, qs[qi]) != base[qi]:
                bad.append(qi)

    _threads(4, client)
    assert not bad
    assert metrics.value("batch_coalesced_total") > before

    def boom(*a, **kw):
        raise AssertionError("read_similar engaged at VEC_COALESCE=0")

    monkeypatch.setenv("DGRAPH_TPU_VEC_COALESCE", "0")
    monkeypatch.setattr(M[side].MicroBatcher, "read_similar", boom)
    assert _data_bytes(s, qs[0]) == base[0]


def test_front_phase_on_cpu(monkeypatch):
    """chip_smoke's phase 9, rehearsed at a small size on the CPU: the
    plain versions run, no kernel launches. The index's batch search is
    slowed, as in the reference's coalescing tests, so that the clients
    reliably pile up behind a running search, and eight clients hold more
    than (9e)'s MAX_INFLIGHT=4 in flight."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    quiet = lambda m: None  # noqa: E731
    s = chip_smoke.serve("cpu", fanout=6, pool=400, reps=1, log=quiet, keep=True)
    gf = chip_smoke.front_graph(s["server"], s["graph"], log=quiet)
    # 6 roots: within the plan cache's 16 bindings per shape, so both
    # orders hit on their second asking
    assert [gf["plan"][f"512 {how}"]["hit_rate"] for how in ("cycle", "repeat")] == [0.5, 0.5]
    assert gf["plan"]["0 cycle"]["hits"] == gf["plan"]["0 repeat"]["hits"] == 0
    # (b)'s level goes through setop_rows (its plain version), not K1
    assert gf["plan"]["512 cycle"]["setops"] >= 1 and gf["rdf"]["b"]["setops"] >= 1
    assert gf["rdf"]["b"]["triples"] > gf["rdf"]["a"]["triples"] == 6 + 36
    assert gf["result_cache"]["hits"] == len(chip_smoke.QUERIES)
    v = chip_smoke.serve_vectors("cpu", n=6000, d=16, n_named=500, n_small=1000, nq=16,
                                 ivf_threshold=2000, reps=1, log=quiet, keep=True)
    for pred in ("emb", "emb_small"):
        idx = v["server"].vector_indexes[pred]
        real = idx.search_batch

        def slow(Q, kk, real=real):
            time.sleep(0.002)
            return real(Q, kk)

        monkeypatch.setattr(idx, "search_batch", slow)
    vf = chip_smoke.front_vectors(v["server"], v["small"][1], named=v["named"], clients=8,
                                  per_client=8, log=quiet)
    assert min(vf["launches"].values()) >= 1  # the plain versions' calls
    assert vector_topk.LAUNCHES == ivf_scan.LAUNCHES == member_sweep.LAUNCHES == 0
    assert vf["arms"]["emb 200"]["coalesced_batches"] >= 1
    assert vf["arms"]["emb 0"]["batch_coalesced_total"] == 0
    assert vf["admission"]["shed"] >= 1 and vf["acl"]["audit_lines"] >= 3
    topk_sites, slab_sites = vf["captured"]
    assert {shape[0] for shape, _, _, _ in topk_sites} >= {1, 2}
    assert slab_sites
