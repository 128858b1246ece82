"""The port's GraphQL layer against the JAX reference's, on the CPU.

The cases are the reference's own tests, run twice: once as written
(`dgraph_tpu`, jax on the CPU) and once with `dgraph_tpu` rebound to
`dgraph_tpu_torch` in their source (and in the helper modules they
import: `ref_golden_graphql/mutation_support.py`, the golden file
`test_ref_golden_graphql.py`), so each side meets the reference test's
own assertions. On the port's side every `Server`, `DistributedCluster`
and `ProcCluster` is built with `device="cpu"` (a ProcCluster without a
`data_dir` gets one under the test's `tmp_path`), and the set ops run on
the device path with the member sweep on, so the plain versions of its
kernels run. The reference runs on its default dispatch path.

Every answer an entry point gives is recorded on both sides and the
port's must equal the reference's:

- `GraphQLServer.execute`: the result's JSON bytes;
- the HTTP front: each response's status, content type and body. A JSON
  body is compared as its JSON value, key order included, with the
  top-level `extensions` (latencies, trace ids, transaction timestamps),
  every JWT (they carry the clock) and `/health`'s `uptime` masked; the
  `/debug/*` and metrics routes, whose bodies are process counters and
  clocks, by status and content type; other bodies byte for byte;
- the websocket: every frame the server pushes, byte for byte;
- `Server.query` and the cluster entry points on the test's main thread
  (the `data` bytes).

A case the reference marks `xfail` stays `xfail`: it passes only when
both packages fail it with the same answers up to the failure. In a case
that retries a request until a timer fires (`RETRIED`), an answer
repeated in a row counts once.

Files (this module): tests/test_graphql.py, test_graphql_auth.py,
test_graphql_custom.py and test_graphql_lambda.py (its websocket case
included), then phase 12 of `chip_smoke.py` rehearsed at a tiny size and
the GraphQL findings shown in both packages. The golden files run in
tests/test_torch_graphql_golden.py, the HTTP files and the HTTP cases of
the other reference files in tests/test_torch_http.py, the card's cases
in tests/test_torch_graphql_cuda.py. The gRPC, MCP and CLI cases of
those files are left out: the gRPC server, the MCP server and the CLI
are not ported yet.
"""

import ast
import inspect
import itertools
import json
import os
import pathlib
import re
import sys
import tempfile
import threading
import types

import numpy as np
import pytest

import chip_smoke
from dgraph_tpu_torch.ops import member_sweep, vector_topk
from dgraph_tpu_torch.query import dispatch

TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(TESTS, "ref_golden_graphql")
PKG = {"ref": "dgraph_tpu", "port": "dgraph_tpu_torch"}
SIDES = ("ref", "port")

# ---------------------------------------------------------------------------
# The reference's test modules, on either package
# ---------------------------------------------------------------------------

_MODULES = {}


def _exec(path, name, side):
    src = open(path).read()
    if side == "port":
        src = re.sub(r"\bdgraph_tpu\b", "dgraph_tpu_torch", src)
    mod = types.ModuleType(name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def load(fname, side):
    """The reference test module (or helper) `fname`, its source rebound
    to the side's package."""
    if (fname, side) not in _MODULES:
        path = os.path.join(TESTS, fname + ".py")
        if not os.path.exists(path):
            path = os.path.join(GOLDEN, fname + ".py")
        with _helpers(side):
            _MODULES[fname, side] = _exec(path, f"_{fname}_{side}", side)
    return _MODULES[fname, side]


# modules the reference tests import by plain name, served per side
HELPERS = ("mutation_support", "test_ref_golden_graphql")


class _helpers:
    """`import mutation_support` and `from test_ref_golden_graphql import
    ...` resolve to the side's rebound copies while a case runs."""

    def __init__(self, side):
        self.side = side

    def __enter__(self):
        self.saved = {n: sys.modules.get(n) for n in HELPERS}
        for n in HELPERS:
            if (n, self.side) in _MODULES:
                sys.modules[n] = _MODULES[n, self.side]
        return self

    def __exit__(self, *exc):
        for n, m in self.saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


class CaseFailed(Exception):
    """An `xfail` case that both packages failed with equal answers."""


def _product(fn):
    """[(param id, {argname: value}, marks)] of a test function's
    parametrize marks (the cartesian product, as pytest forms it)."""
    axes = []
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        ids = mark.kwargs.get("ids")
        axis = []
        for i, v in enumerate(values):
            marks, pid = (), None
            if isinstance(v, type(pytest.param(0))):
                marks, pid, v = tuple(v.marks), v.id, v.values
            elif len(names) == 1:
                v = (v,)
            if pid is None:
                if callable(ids):
                    pid = str(ids(v[0]))
                elif ids is not None:
                    pid = str(ids[i])
                else:
                    pid = str(i)
            axis.append((pid, dict(zip(names, v)), marks))
        axes.append(axis)
    out = []
    for combo in itertools.product(*axes):
        out.append(("-".join(c[0] for c in combo),
                    {k: v for c in combo for k, v in c[1].items()},
                    tuple(m for c in combo for m in c[2])))
    return out or [("", {}, ())]


def _slow(fn):
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


def cases(fname, only=None, skip=()):
    """pytest params (fname, test, param index) for the reference file's
    non-slow tests, in file order; a case the reference marks xfail is
    xfail here too, raising `CaseFailed` when both packages fail it."""
    mod = load(fname, "ref")
    tree = ast.parse(open(mod.__file__).read())
    names = [n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert set(only or ()) | set(skip) <= set(names), fname
    out = []
    for name in names:
        if (only is not None and name not in only) or name in skip:
            continue
        fn = getattr(mod, name)
        if _slow(fn):
            continue
        for i, (pid, _, marks) in enumerate(_product(fn)):
            xfail = [m for m in marks if m.name == "xfail"]
            kw = {}
            if xfail:
                kw["marks"] = pytest.mark.xfail(
                    strict=True, raises=CaseFailed, reason=xfail[0].kwargs.get("reason", ""))
            out.append(pytest.param((fname, name, i),
                                    id=f"{fname}::{name}" + (f"[{pid}]" if pid else ""), **kw))
    return out


# ---------------------------------------------------------------------------
# Recording the entry points' answers
# ---------------------------------------------------------------------------

_JWT = re.compile(r"eyJ[A-Za-z0-9_-]+\.[A-Za-z0-9_-]+\.[A-Za-z0-9_-]*")


def _mask(v):
    if isinstance(v, dict):
        return {k: ("<uptime>" if k == "uptime" else _mask(x)) for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x) for x in v]
    if isinstance(v, str):
        return _JWT.sub("<jwt>", v)
    return v


def _http_answer(method, path, status, ctype, body):
    route = path.split("?")[0]
    if route.startswith("/debug/") or "metrics" in route:
        return [method, route, status, ctype]
    if "json" in ctype:
        obj = json.loads(body)
        if isinstance(obj, dict):
            obj.pop("extensions", None)
        return [method, path, status, ctype, json.dumps(_mask(obj))]
    return [method, path, status, ctype, _JWT.sub("<jwt>", body.decode("utf-8", "replace"))]


class _Tee:
    """A handler's `wfile` that records each response it writes."""

    def __init__(self, handler, f, sink):
        self.handler, self.f, self.sink = handler, f, sink
        self.head = None

    def write(self, b):
        b = bytes(b)
        if b.startswith(b"HTTP/1."):
            status = int(b.split(b" ", 2)[1])
            m = re.search(rb"(?i)\r\nContent-Type: ([^\r\n]*)", b)
            self.head = (status, m.group(1).decode() if m else "")
        elif self.head is not None:
            h = self.handler
            self.sink(_http_answer(h.command, h.path, *self.head, b))
            self.head = None
        return self.f.write(b)

    def __getattr__(self, name):
        return getattr(self.f, name)


def _query_answer(result):
    data = result.get("data") if isinstance(result, dict) else result
    if hasattr(data, "raw"):
        data = data.raw
    if isinstance(data, (bytes, bytearray)):
        return bytes(data).decode()
    return json.dumps(data, sort_keys=True, default=repr)


class Runner:
    """Runs reference test functions on one side, resolving their
    fixtures (tmp_path, monkeypatch and the module's own; module-scoped
    ones are kept until the side moves to another file), and records
    every answer of the entry points (see the module docstring)."""

    def __init__(self):
        self.module_fixtures = {}  # (side, fname, name) -> (value, finalizer)
        self.current = {}  # side -> fname
        self.answers = []

    def close_module_fixtures(self, side=None):
        for key in list(self.module_fixtures):
            if side is None or key[0] == side:
                _, fin = self.module_fixtures.pop(key)
                if fin is not None:
                    fin()

    def _fixture(self, name, ctx):
        side, fname, fixtures, tmp, mp, finals = ctx
        if name == "tmp_path":
            return pathlib.Path(tmp)
        if name == "monkeypatch":
            return mp
        fn, scope, _ = fixtures[name]
        if scope == "module" and (side, fname, name) in self.module_fixtures:
            return self.module_fixtures[side, fname, name][0]
        got = fn(**{p: self._fixture(p, ctx) for p in inspect.signature(fn).parameters})
        fin = None
        if inspect.isgenerator(got):
            gen, got = got, next(got)

            def fin(gen=gen):
                next(gen, None)
        if scope == "module":
            self.module_fixtures[side, fname, name] = (got, fin)
        elif fin is not None:
            finals.append(fin)
        return got

    def run(self, side, fname, tname, index, tmp):
        """Run one reference case on `side`; returns the recorded answers
        (in `self.answers` too, should the case raise)."""
        if self.current.get(side) != fname:
            self.close_module_fixtures(side)
            self.current[side] = fname
        tmp = str(tmp)
        os.makedirs(tmp, exist_ok=True)
        for name in HELPERS:
            load(name, side)
        mod = load(fname, side)
        fixtures = {}
        for attr, obj in vars(mod).items():
            marker = getattr(obj, "_fixture_function_marker", None)
            if marker is not None:
                fixtures[marker.name or attr] = (
                    obj._get_wrapped_function(), marker.scope, marker.autouse)
        self.answers = answers = []
        mp = pytest.MonkeyPatch()
        finals = []
        ctx = (side, fname, fixtures, tmp, mp, finals)
        try:
            with _helpers(side):
                if side == "port":
                    port_defaults(mp, tmp)
                record(mp, PKG[side], answers)
                for name, (_, _, autouse) in fixtures.items():
                    if autouse:
                        self._fixture(name, ctx)
                fn = getattr(mod, tname)
                _, params, _ = _product(fn)[index]
                fn(**{p: params[p] if p in params else self._fixture(p, ctx)
                      for p in inspect.signature(fn).parameters})
        finally:
            for fin in reversed(finals):
                fin()
            mp.undo()
        return answers


def port_defaults(mp, tmp):
    """The port's entry points on the CPU, on the forced device path with
    the member sweep on; a ProcCluster's configs in a directory of its
    own."""
    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.worker.groups import DistributedCluster
    from dgraph_tpu_torch.worker.harness import ProcCluster

    mp.setattr(dispatch, "_FORCE_DEVICE", True)
    mp.setattr(dispatch, "_USE_PALLAS", True)
    for cls in (Server, DistributedCluster, ProcCluster):
        def init(self, *a, _init=cls.__init__, _proc=cls is ProcCluster, **kw):
            kw.setdefault("device", "cpu")
            if _proc and kw.get("data_dir") is None:
                kw["data_dir"] = tempfile.mkdtemp(prefix="pc_", dir=tmp)
            _init(self, *a, **kw)
        mp.setattr(cls, "__init__", init)


def record(mp, pkg, answers):
    """Patch the side's entry points to append their answers."""
    import importlib

    lock = threading.Lock()

    def add(what, got):
        with lock:
            answers.append([what, got])

    gql = importlib.import_module(f"{pkg}.graphql.resolve").GraphQLServer
    real_execute = gql.execute

    def execute(self, *a, _real=real_execute, **kw):
        out = _real(self, *a, **kw)
        add("graphql", json.dumps(out))
        return out

    mp.setattr(gql, "execute", execute)

    handler = importlib.import_module(f"{pkg}.api.http_server")._Handler
    real_setup = handler.setup

    def setup(self, _real=real_setup):
        _real(self)
        self.wfile = _Tee(self, self.wfile, lambda a: add("http", a))

    mp.setattr(handler, "setup", setup)

    ws = importlib.import_module(f"{pkg}.api.ws")
    real_send = ws.send_frame

    def send_frame(sock, payload, opcode=0x1, _real=real_send):
        add("ws", [opcode, bytes(payload).decode("utf-8", "replace")])
        return _real(sock, payload, opcode)

    mp.setattr(ws, "send_frame", send_frame)

    for mod, cls in (("api.server", "Server"), ("worker.groups", "DistributedCluster"),
                     ("worker.harness", "ProcCluster"), ("worker.facade", "ClusterFacade")):
        klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)

        def query(self, *a, _real=klass.query, **kw):
            out = _real(self, *a, **kw)
            if threading.current_thread() is threading.main_thread():
                add("query", _query_answer(out))
            return out

        mp.setattr(klass, "query", query)


@pytest.fixture(scope="module")
def runner():
    r = Runner()
    yield r
    r.close_module_fixtures()


# cases that retry a request until a timer fires: how many times an
# answer repeats depends on the clock, so repeats in a row count once
RETRIED = {("test_serving_front", "test_http_429_with_retryable_code")}


def _untmp(v, tmp):
    if isinstance(v, str):
        return v.replace(tmp, "<tmp>")
    if isinstance(v, (list, tuple)):
        return [_untmp(x, tmp) for x in v]
    return v


def run_both(runner, case, tmp_path, request):
    """The case on the reference, then on the port: the port's answers
    must equal the reference's. An xfail case raises `CaseFailed` when
    both sides failed it, after the same answers."""
    fname, tname, index = case
    xfail = request.node.get_closest_marker("xfail") is not None
    got, errors = {}, {}
    for side in SIDES:
        try:
            got[side] = runner.run(side, fname, tname, index, tmp_path / side)
        except Exception as e:  # noqa: BLE001 - compared below
            if not xfail:
                raise
            got[side], errors[side] = runner.answers, e
    # a path under the side's own tmp_path (a backup destination, say)
    got = {side: _untmp(got[side], str(tmp_path / side)) for side in SIDES}
    if (fname, tname) in RETRIED:
        got = {side: [a for i, a in enumerate(got[side]) if i == 0 or a != got[side][i - 1]]
               for side in SIDES}
    assert got["port"] == got["ref"]
    if xfail:
        assert set(errors) in (set(), set(SIDES)), f"only {sorted(errors)} failed: {errors}"
        if errors:
            raise CaseFailed(f"both packages fail it: {errors['ref']!r}")
    return got["port"]


# ---------------------------------------------------------------------------
# The reference's GraphQL tests on both packages
# ---------------------------------------------------------------------------

GRAPHQL_CASES = (
    cases("test_graphql") + cases("test_graphql_auth") + cases("test_graphql_custom")
    + cases("test_graphql_lambda")
)


@pytest.mark.parametrize("case", GRAPHQL_CASES)
def test_both_packages(case, runner, tmp_path, request):
    """The reference case passes on both packages, with equal answers."""
    run_both(runner, case, tmp_path, request)


# ---------------------------------------------------------------------------
# Phase 12 of chip_smoke.py, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_graphql_phase_on_cpu(monkeypatch):
    """chip_smoke's phase 12 at a tiny size on the CPU (a graph of 258
    edges with phase 9's extra edge; 6,000 x 16 vectors, the first 500 in
    `emb_small`, with ACL on as phase 9 leaves them; one flip alone and
    one subscribed): every check of `serve_graphql` holds, the plain
    versions of the kernels run and no kernel launches. At 2,000 rows the
    index answers a single query brute (`_ivf_pick`: the probed slabs'
    rows must be under a third of the corpus), so the IVF tier needs
    6,000."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    quiet = lambda m: None  # noqa: E731
    s = chip_smoke.serve("cpu", fanout=6, pool=400, reps=1, log=quiet, keep=True)
    gf = chip_smoke.front_graph(s["server"], s["graph"], log=quiet)
    vserver, V, Qs, _ = chip_smoke.load_vectors("cpu", n=6000, d=16, n_named=500, n_small=500,
                                                ivf_threshold=2000, log=quiet)
    vserver.enable_acl(secret=b"chip-smoke-acl-secret-0123456789")
    edge = [tuple(int(u, 16) for u in gf["result_cache"]["edge"])]
    out = chip_smoke.serve_graphql(s["server"], s["graph"], vserver, V[:500], Qs, len(V),
                                   chip_smoke.exact_topk(V, Qs[:16], 10), edge, n_flips=1,
                                   reps=1, log=quiet)
    # the plain versions' calls: (b)'s level goes through setop_rows, not K1
    assert min(out["launches"][k] for k in ("setop_rows", "vector_topk", "ivf_slab_scan")) >= 1
    assert member_sweep.LAUNCHES == vector_topk.LAUNCHES == 0
    assert out["b_setops"] >= 1 and sum(out["b_entries"].values()) == out["b_setops"]
    assert out["types"]["nodes"] == 1 + 6 + 36 + 400
    assert out["aggregate"]["count"] == 4
    assert out["similar"]["emb_small"]["reads"] == out["similar"]["emb"]["reads"] == 16
    assert out["recall"] >= 0.9
    commits = out["commits"]
    assert len(commits["alone_ms"]) == len(commits["subscribed_ms"]) == 1
    assert commits["setops_per_commit_subscribed"][0] > commits["setops_per_commit_alone"][0] == 0
    # the commit that changed no answer re-ran the subscription, pushed nothing
    assert commits["unchanged"]["setops"] >= 1 and not commits["unchanged"]["pushed"]
    assert out["captured"][0] and out["captured"][1]


def test_graphql_only_data_on_cpu(monkeypatch):
    """`--graphql-only`'s data at a tiny size on the CPU: the graph through
    the native bulk loader and the vectors as phase 7 loads them, then
    phase 12 with one flip alone and one subscribed."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    quiet = lambda m: None  # noqa: E731
    data = chip_smoke.graphql_data("cpu", fanout=6, pool=400, n=6000, d=16, n_named=500,
                                   n_small=500, ivf_threshold=2000, log=quiet)
    assert [int(u) for u in data["g"]["l1"]] and data["named"] == 6000
    out = chip_smoke.serve_graphql(*data.values(), (), n_flips=1, reps=1, log=quiet)
    assert min(out["launches"][k] for k in ("setop_rows", "vector_topk", "ivf_slab_scan")) >= 1
    assert out["b_setops"] >= 1 and out["recall"] >= 0.9
    assert out["similar"]["emb"]["rows_with_distance"] >= 1


# ---------------------------------------------------------------------------
# Findings (ROADMAP Queue 3), shown in both packages
# ---------------------------------------------------------------------------


def _server(pkg):
    import importlib

    server = importlib.import_module(f"{pkg}.api.server").Server
    return server(device="cpu") if pkg == "dgraph_tpu_torch" else server()


@pytest.mark.parametrize("pkg", ["dgraph_tpu", "dgraph_tpu_torch"])
def test_graphql_subscription_pushes_changed_answers_only(pkg):
    """A GraphQL subscription re-runs on every commit that touches its
    types' predicates but calls back only when the answer changed (its
    result carries no `extensions`); a DQL subscription to the same data
    calls back on every such commit, its response's latencies differing
    each time. Phase 12's (12e) shows the GraphQL side on the card."""
    import importlib

    gqls = importlib.import_module(f"{pkg}.graphql").GraphQLServer
    subs = importlib.import_module(f"{pkg}.api.subscriptions").Subscriptions
    s = _server(pkg)
    s.graphql = gqls(s, "type Person { id: ID! name: String @search(by: [exact]) }")
    s.graphql.execute('mutation { addPerson(input: [{name: "a"}]) { numUids } }')
    fired = {"graphql": [], "dql": []}
    sub = subs(s)
    sub.subscribe_graphql("subscription { queryPerson { name } }", fired["graphql"].append)
    sub.subscribe("{ q(func: has(Person.name)) { Person.name } }", fired["dql"].append)
    rerun = []
    real = s.graphql.execute
    s.graphql.execute = lambda *a, **kw: rerun.append(1) or real(*a, **kw)
    for name in ("a", "a", "b"):  # the same value twice, then a change
        s.graphql.execute('mutation { updatePerson(input: {filter: {name: {eq: "%s"}}, '
                          'set: {name: "%s"}}) { numUids } }' % ("a" if name != "b" else "a",
                                                                 name))
    assert [f["data"] for f in fired["graphql"]] == [
        {"queryPerson": [{"name": "a"}]}, {"queryPerson": [{"name": "b"}]}]
    assert len(fired["dql"]) == 1 + 3
    assert len(rerun) == 3 + 3  # the 3 mutations and a re-run after each


@pytest.mark.parametrize("pkg", ["dgraph_tpu", "dgraph_tpu_torch"])
def test_similar_rows_in_uid_order_and_index_only_rows_without_distance(pkg, monkeypatch):
    """`querySimilarDocByEmbedding` lists its hits in uid order, as DQL's
    `similar_to` does (Dgraph orders them by distance), and computes
    `vector_distance` from the stored vector: a row that `VectorIndex.
    bulk_load` put in the index alone (as phase 7 loads most of its
    rows) answers null."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    import importlib

    gqls = importlib.import_module(f"{pkg}.graphql").GraphQLServer
    s = _server(pkg)
    g = gqls(s, 'type Doc { id: ID! name: String @search(by: [exact]) @dgraph(pred: "name") '
                'emb: [Float!] @embedding @search(by: ["hnsw(metric: euclidean)"]) '
                '@dgraph(pred: "emb") }')
    V = np.random.default_rng(5).integers(-6, 7, size=(30, 8)).astype(np.float32)
    # a twin of every row, half a unit off, in the index alone (bulk_load
    # starts the index anew, so it comes first)
    s.vector_indexes["emb"].bulk_load(np.arange(0x1000, 0x1000 + 30, dtype=np.uint64), V + 0.5)
    for i in range(30):
        g.execute('mutation ($v: [Float!]!) { addDoc(input: [{name: "d%d", emb: $v}]) '
                  '{ numUids } }' % i, {"v": V[i].tolist()})
    q = V[3] + 0.25
    rows = g.execute('query ($v: [Float!]!) { querySimilarDocByEmbedding(by: emb, topK: 12, '
                     'vector: $v) { id name vector_distance } }',
                     {"v": q.tolist()})["data"]["querySimilarDocByEmbedding"]
    ids = [int(o["id"], 16) for o in rows]
    assert len(ids) == 12 and ids == sorted(ids)
    stored = [o for o in rows if int(o["id"], 16) < 0x1000]
    index_only = [o for o in rows if int(o["id"], 16) >= 0x1000]
    assert stored and index_only
    assert all(o["vector_distance"] is None and "name" not in o for o in index_only)
    dist = [o["vector_distance"] for o in stored]
    assert all(d is not None for d in dist) and dist != sorted(dist)
