"""The port's cluster against the JAX reference's, on the CPU.

The cluster is Raft (in-process and over TCP), the replicated Zero, the
tablet mover, the follower-read replica picker, the in-process
`DistributedCluster` and the multi-process `ProcCluster`. Its cases are
the reference's own tests, run twice: once as written (`dgraph_tpu`,
jax on the CPU) and once with `dgraph_tpu` rebound to
`dgraph_tpu_torch` in their source, so each side meets the reference
test's own assertions. On the port's side every cluster and Server is
built with `device="cpu"` and a ProcCluster without a `data_dir` gets
one under the test's own `tmp_path` (without one, every ProcCluster of a
package writes its replicas' configs into one shared directory); the
port's set ops run on the device path with the member sweep on, so the
plain versions of its kernels run. The reference runs on its default
dispatch path. Every answer a query entry point (`Server`,
`DistributedCluster`, `ProcCluster`, `ClusterFacade`) gives on the
test's main thread is recorded, and the port's answers must equal the
reference's byte for byte.

Both packages run, from tests/: test_raft.py, test_distributed.py,
test_replicated_zero.py and test_durability.py whole;
test_cluster_facade.py without its HTTP and gRPC cases (the servers are
ROADMAP Queue 1 item 7); test_tablet_move.py without its two ProcCluster
chaos cases (one marked `slow`); test_follower_reads.py without
`test_chaos_soak_sanity_slice`, which drives tools/chaos_soak.py, a
reference tool with no port; the DistributedCluster cases of
test_ops_plane.py; test_loaders_admin.py's
`test_online_restore_into_cluster`.

The port alone runs the ProcCluster cases of test_proc_cluster.py and
test_ops_plane.py (both packages' process clusters at once would double
the process load under which the reference's own ProcCluster tests turn
red). Each query a test_proc_cluster.py case asks its ProcCluster is
asked again of a reference `DistributedCluster` that took the same
schema and mutations, and must answer the same.

Then: `similar_to` over a `DistributedCluster`, the findings recorded in
ROADMAP Queue 3 shown in both packages, phase 11 of `chip_smoke.py`
rehearsed at a tiny size, and phase 8 as phase 11's room left it (its
lsm arm without vectors). The card's cases are in
tests/test_torch_cluster_cuda.py.
"""

import ast
import inspect
import json
import os
import re
import signal
import tempfile
import threading
import types

import numpy as np
import pytest

import chip_smoke
from dgraph_tpu_torch.ops import member_sweep, vector_topk
from dgraph_tpu_torch.query import dispatch

TESTS = os.path.dirname(os.path.abspath(__file__))
PKG = {"ref": "dgraph_tpu", "port": "dgraph_tpu_torch"}

# red in the driver's last whole run of the reference tests: their own
# test functions below say so
RED = {("test_proc_cluster", "test_proc_cluster_with_zero_quorum_processes")}


def _test_names(fname):
    """The reference file's top-level tests, in order, without `slow` ones."""
    tree = ast.parse(open(os.path.join(TESTS, fname + ".py")).read())
    return [
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")
        and "pytest.mark.slow" not in {ast.unparse(d) for d in node.decorator_list}
    ]


def _select(fname, only=None, skip=()):
    names = _test_names(fname)
    assert set(only or ()) | set(skip) <= set(names), fname
    keep = [n for n in names if (n in only if only is not None else n not in skip)]
    return [(fname, n) for n in keep if (fname, n) not in RED]


BOTH_CASES = (
    _select("test_raft") + _select("test_distributed") + _select("test_replicated_zero")
    + _select("test_durability")
    + _select("test_cluster_facade",  # the servers are ROADMAP Queue 1 item 7
              skip=("test_http_over_cluster", "test_grpc_over_cluster"))
    + _select("test_tablet_move",  # ProcCluster chaos cases
              skip=("test_move_chaos_bank_crash_every_phase_and_partition",))
    # drives tools/chaos_soak.py, a reference tool with no port
    + _select("test_follower_reads", skip=("test_chaos_soak_sanity_slice",))
    + _select("test_ops_plane", only=(
        "test_backup_crash_every_boundary_under_bank_and_move",
        "test_backup_waits_out_in_flight_move",
        "test_backup_after_crash_finishes_pending_then_takes_fresh",
        "test_full_backup_recovers_a_broken_chain",
        "test_backup_abort_drops_partials",
        "test_online_restore_idempotent_rerun_and_journal",
        "test_cdc_cluster_sink_crash_failover_replay_apply_equivalence",
    ))
    + _select("test_loaders_admin", only=("test_online_restore_into_cluster",))
)
# cases whose answers count writes made while a clock runs: each side
# meets the reference test's own assertions, the answers may differ
TIMED = {
    ("test_tablet_move", "test_phase1_does_not_block_other_commits"),
    ("test_ops_plane", "test_backup_crash_every_boundary_under_bank_and_move"),
}
# (case, hold each query to a reference DistributedCluster on the same data)
PORT_CASES = [(c, True) for c in _select("test_proc_cluster")] + [
    (c, False) for c in _select(
        "test_ops_plane", only=("test_proc_cluster_online_backup_restore_watermark_and_cdc",))
]


def _load(fname, side):
    """The reference test module, its source rebound to the side's package."""
    path = os.path.join(TESTS, fname + ".py")
    src = open(path).read()
    if side == "port":
        src = re.sub(r"\bdgraph_tpu\b", "dgraph_tpu_torch", src)
    mod = types.ModuleType(f"_{fname}_{side}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _fixtures(mod):
    """name -> (function, scope, autouse) of the module's own fixtures."""
    out = {}
    for attr, obj in vars(mod).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is None:
            continue
        out[marker.name or attr] = (obj._get_wrapped_function(), marker.scope, marker.autouse)
    return out


def _answer(result):
    data = result.get("data") if isinstance(result, dict) else result
    if hasattr(data, "raw"):
        data = data.raw
    if isinstance(data, (bytes, bytearray)):
        return bytes(data).decode()
    return json.dumps(data, sort_keys=True, default=repr)


class Runner:
    """Runs reference test functions on one side, resolving their
    fixtures (tmp_path, monkeypatch and the module's own, module-scoped
    ones kept until the next file), and records every answer a query
    entry point gives on the main thread."""

    def __init__(self):
        self.mods = {}
        self.module_fixtures = {}  # (side, fname, name) -> (value, finalizer)
        self.current = {}  # side -> fname
        self.twins = {}  # id(port ProcCluster) -> reference DistributedCluster
        self.mismatches = []

    def module(self, fname, side):
        if (fname, side) not in self.mods:
            self.mods[fname, side] = _load(fname, side)
        return self.mods[fname, side]

    def close_module_fixtures(self, side=None):
        for key in list(self.module_fixtures):
            if side is None or key[0] == side:
                _, fin = self.module_fixtures.pop(key)
                if fin is not None:
                    fin()

    def close(self):
        self.close_module_fixtures()
        for twin in self.twins.values():
            twin.close()
        self.twins.clear()

    def _fixture(self, name, side, fname, fixtures, tmp, mp, finals):
        if name == "tmp_path":
            return tmp
        if name == "monkeypatch":
            return mp
        fn, scope, _ = fixtures[name]
        if scope == "module" and (side, fname, name) in self.module_fixtures:
            return self.module_fixtures[side, fname, name][0]
        args = {p: self._fixture(p, side, fname, fixtures, tmp, mp, finals)
                for p in inspect.signature(fn).parameters}
        got = fn(**args)
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

    def run(self, side, fname, tname, tmp, twin=False):
        """Run one reference test on `side`; returns the recorded answers."""
        if self.current.get(side) != fname:  # the last file's module fixtures go
            self.close_module_fixtures(side)
            self.current[side] = fname
        os.makedirs(tmp, exist_ok=True)
        mod = self.module(fname, side)
        fixtures = _fixtures(mod)
        answers = []
        mp = pytest.MonkeyPatch()
        finals = []
        try:
            if side == "port":
                self._port_defaults(mp, tmp)
                if twin:
                    self._twin(mp)
            self._record(mp, PKG[side], answers)
            for name, (_, _, autouse) in fixtures.items():
                if autouse:
                    self._fixture(name, side, fname, fixtures, tmp, mp, finals)
            fn = getattr(mod, tname)
            fn(**{p: self._fixture(p, side, fname, fixtures, tmp, mp, finals)
                  for p in inspect.signature(fn).parameters})
        finally:
            for fin in reversed(finals):
                fin()
            mp.undo()
        return answers

    @staticmethod
    def _port_defaults(mp, tmp):
        """The port's entry points on the CPU; a ProcCluster's configs in
        a directory of its own."""
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

    def _twin(self, mp):
        """Every schema, mutation and query of a port ProcCluster goes to
        a reference DistributedCluster too; answers must agree."""
        from dgraph_tpu.worker.groups import DistributedCluster as RefCluster
        from dgraph_tpu_torch.worker.groups import ClusterTxn
        from dgraph_tpu_torch.worker.harness import ProcCluster

        def twin(c):
            if id(c) not in self.twins:
                self.twins[id(c)] = RefCluster(n_groups=len(c.remote_groups), replicas=1)
            return self.twins[id(c)]

        def alter(c, schema_text, _f=ProcCluster.alter):
            out = _f(c, schema_text)
            twin(c).alter(schema_text)
            return out

        def mutate_rdf(t, set_rdf="", del_rdf="", commit_now=False, _f=ClusterTxn.mutate_rdf):
            out = _f(t, set_rdf=set_rdf, del_rdf=del_rdf, commit_now=commit_now)
            if isinstance(t.cluster, ProcCluster):
                assert commit_now, "the twin replays committed mutations only"
                twin(t.cluster).new_txn().mutate_rdf(
                    set_rdf=set_rdf, del_rdf=del_rdf, commit_now=True)
            return out

        def query(c, q, *a, _f=ProcCluster.query, **kw):
            out = _f(c, q, *a, **kw)
            if threading.current_thread() is threading.main_thread():
                want = _answer(twin(c).query(q))
                if _answer(out) != want:
                    self.mismatches.append((q, _answer(out), want))
            return out

        mp.setattr(ProcCluster, "alter", alter)
        mp.setattr(ClusterTxn, "mutate_rdf", mutate_rdf)
        mp.setattr(ProcCluster, "query", query)

    @staticmethod
    def _record(mp, pkg, answers):
        import importlib

        for mod, cls in (("api.server", "Server"), ("worker.groups", "DistributedCluster"),
                         ("worker.harness", "ProcCluster"), ("worker.facade", "ClusterFacade")):
            klass = getattr(importlib.import_module(f"{pkg}.{mod}"), cls)
            real = klass.query

            def query(self, *a, _real=real, **kw):
                out = _real(self, *a, **kw)
                if threading.current_thread() is threading.main_thread():
                    answers.append(_answer(out))
                return out

            mp.setattr(klass, "query", query)


def _children():
    """pids of the replica processes (either package's) this process started."""
    return list(chip_smoke.cluster_children(tuple(
        f"{pkg}.{m}" for pkg in PKG.values()
        for m in ("worker.alpha_process", "zero.zero_process"))))


def _kill_children():
    """SIGKILL every replica process this process started and left."""
    for pid in _children():
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


@pytest.fixture(scope="module")
def runner():
    r = Runner()
    yield r
    try:
        r.close()
    finally:
        _kill_children()


@pytest.mark.parametrize("case", BOTH_CASES, ids=lambda c: "::".join(c))
def test_both_packages(case, runner, tmp_path):
    """The reference case passes on both packages, and the port's
    answers equal the reference's byte for byte (but in `TIMED`)."""
    fname, tname = case
    ref = runner.run("ref", fname, tname, tmp_path / "ref")
    port = runner.run("port", fname, tname, tmp_path / "port")
    if case not in TIMED:
        assert port == ref


@pytest.mark.parametrize("case", PORT_CASES, ids=lambda c: "::".join(c[0]))
def test_port_proc_cluster(case, runner, tmp_path):
    """A ProcCluster case passes on the port; in test_proc_cluster.py each
    query's answer equals a reference DistributedCluster's on the same
    data."""
    (fname, tname), twin = case
    runner.mismatches.clear()
    runner.run("port", fname, tname, tmp_path / "port", twin=twin)
    assert runner.mismatches == []


def test_port_proc_cluster_with_zero_quorum_processes(runner, tmp_path):
    """test_proc_cluster.py::test_proc_cluster_with_zero_quorum_processes
    on the port (alphas and a Zero quorum as processes, the Zero leader
    killed), each query held to a reference DistributedCluster. The
    reference test itself failed in the driver's last whole run of the
    tests (under the parallel load; it passes alone), so this case
    compares against a reference that is red there."""
    runner.mismatches.clear()
    runner.run("port", "test_proc_cluster", "test_proc_cluster_with_zero_quorum_processes",
               tmp_path / "port", twin=True)
    assert runner.mismatches == []


# ---------------------------------------------------------------------------
# similar_to over a cluster
# ---------------------------------------------------------------------------


def test_similar_to_over_distributed_cluster(monkeypatch):
    """Vectors committed through cluster transactions: `similar_to` over a
    DistributedCluster answers as the reference's, through KV1's plain
    version on the port."""
    from dgraph_tpu.worker.groups import DistributedCluster as RefCluster
    from dgraph_tpu_torch.worker.groups import DistributedCluster

    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    rng = np.random.default_rng(3)
    V = rng.integers(-8, 9, size=(200, 16)).astype(np.float32)
    Q = rng.integers(-8, 9, size=(6, 16)).astype(np.float32)
    schema = 'emb: float32vector @index(hnsw(metric:"euclidean")) .\nname: string @index(exact) .'
    rdf = "\n".join(f'<{hex(0x10 + i)}> <emb> "{chip_smoke._vec_text(v)}" .\n'
                    f'<{hex(0x10 + i)}> <name> "n{i}" .' for i, v in enumerate(V))
    qs = [f'{{ q(func: similar_to(emb, 5, "{chip_smoke._vec_text(q)}")) {{ uid name }} }}'
          for q in Q]
    answers = {}
    for side, make in (("ref", lambda: RefCluster(n_groups=2, replicas=3)),
                       ("port", lambda: DistributedCluster(device="cpu", n_groups=2,
                                                           replicas=3))):
        c = make()
        try:
            c.alter(schema)
            lines = rdf.split("\n")
            for part in (lines[: len(lines) // 2], lines[len(lines) // 2 :]):
                c.new_txn().mutate_rdf(set_rdf="\n".join(part), commit_now=True)
            calls = vector_topk.PLAIN_CALLS
            answers[side] = [c.query(q)["data"] for q in qs]
            if side == "port":
                assert vector_topk.PLAIN_CALLS - calls >= len(qs)
                assert str(c.vector_indexes["emb"].device) == "cpu"
        finally:
            c.close()
    assert answers["port"] == answers["ref"]
    d = ((V[None, :, :] - Q[:, None, :]) ** 2).sum(-1)
    for got, row in zip(answers["port"], d):
        uids = sorted(int(o["uid"], 16) - 0x10 for o in got["q"])
        assert sorted(row[uids]) == sorted(np.sort(row)[:5])


# ---------------------------------------------------------------------------
# Findings (ROADMAP Queue 3), shown in both packages
# ---------------------------------------------------------------------------


def _make_store(pkg, friends):
    import importlib

    server = importlib.import_module(f"{pkg}.api.server").Server
    s = server(device="cpu") if pkg == "dgraph_tpu_torch" else server()
    s.alter("name: string @index(exact) .\nfriend: [uid] .")
    rdf = '<0x1> <name> "root" .\n' + "".join(
        f'<{f}> <name> "{n}" .\n<0x1> <friend> <{f}> .\n' for f, n in friends)
    s.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
    return s


@pytest.mark.parametrize("pkg", ["dgraph_tpu", "dgraph_tpu_torch"])
def test_operand_cache_serves_another_stores_operand(pkg, monkeypatch):
    """Two stores in one process meet the same (key, latest_ts) token with
    other contents: the second store's filtered level reads the first
    one's operand from the device cache and answers wrongly; with the
    cache cleared it answers right. Phase 11 of chip_smoke.py clears the
    cache before it builds its clusters for this reason."""
    import importlib

    d = importlib.import_module(f"{pkg}.query.dispatch")
    monkeypatch.setattr(d, "_FORCE_DEVICE", True)
    monkeypatch.setattr(d, "_USE_PALLAS", True)
    q = '{ q(func: uid(0x1)) { friend @filter(eq(name, "b")) { uid } } }'
    d.DISPATCHER.device_cache.clear()
    a = _make_store(pkg, [("0x2", "b"), ("0x3", "c")])
    b = _make_store(pkg, [("0x4", "b"), ("0x5", "c")])
    assert a.query(q)["data"] == {"q": [{"friend": [{"uid": "0x2"}]}]}
    hits = d.DISPATCHER.device_cache.hits
    assert b.query(q)["data"] == {"q": []}  # should be 0x4
    assert d.DISPATCHER.device_cache.hits > hits
    d.DISPATCHER.device_cache.clear()
    assert b.query(q)["data"] == {"q": [{"friend": [{"uid": "0x4"}]}]}
    d.DISPATCHER.device_cache.clear()


def test_proc_clusters_without_data_dir_share_their_config_files(tmp_path):
    """Two ProcClusters whose replicas' configs land in one directory,
    one after the other: the second overwrites the first's
    `alpha_1.json`, as node ids start at 1 in every cluster. Every
    ProcCluster without a `data_dir` writes to one such directory
    (`_spawn`'s `self.data_dir or ...`), so two clusters starting at
    once can hand a replica the other's ports (a possible cause of the
    reference's ProcCluster tests failing only under the parallel run).
    The copy keeps it; the port's tests give every ProcCluster a
    `data_dir` of its own. This test stands one directory under tmp_path
    in for that default path, which other checkouts' clusters share."""
    from dgraph_tpu_torch.worker.harness import ProcCluster

    d = str(tmp_path / "shared")
    path = os.path.join(d, "alpha_1.json")
    # one after the other, so that no two replicas open one store at once
    c1 = ProcCluster(device="cpu", n_groups=1, replicas=1, data_dir=d)
    try:
        first = c1._cfgs[1]
        assert json.load(open(path)) == first
    finally:
        c1.close()
    c2 = ProcCluster(device="cpu", n_groups=1, replicas=1, data_dir=d)
    try:
        got = json.load(open(path))
        assert got == c2._cfgs[1] and got["rpc_addr"] != first["rpc_addr"]
    finally:
        c2.close()


def test_debug_bundle_lock_edges(tmp_path):
    """The reference's debug bundle carries its static lock graph; the
    port's carries its own (its verbatim `analysis/` copies run over
    `dgraph_tpu_torch/`), with no `error` entry, and on the modules both
    packages share verbatim its edges equal the reference's."""
    from dgraph_tpu.worker.harness import ProcCluster as RefProc
    from dgraph_tpu_torch.worker.harness import ProcCluster
    from test_torch_http import _shared_edges

    edges = {}
    for side, make in (("ref", lambda d: RefProc(n_groups=1, replicas=1, data_dir=d)),
                       ("port", lambda d: ProcCluster(device="cpu", n_groups=1, replicas=1,
                                                      data_dir=d))):
        c = make(str(tmp_path / side))
        try:
            edges[side] = c.debug_bundle()["lock_graph"]
        finally:
            c.close()
    for side in ("ref", "port"):
        assert edges[side] and all({"outer", "inner", "path"} <= set(e) for e in edges[side])
        assert not [e for e in edges[side] if "error" in e]
    assert _shared_edges(edges["port"]) == _shared_edges(edges["ref"]) != []


@pytest.mark.parametrize("pkg", ["dgraph_tpu", "dgraph_tpu_torch"])
def test_cluster_facade_json_mutation_raises(pkg):
    """`ClusterFacade` borrows `Server._apply_json`, which calls
    `_apply_json_with_vars`, which the facade does not borrow: a JSON
    mutation through the facade raises in both packages (phase 11
    commits its vectors as RDF)."""
    import importlib

    groups = importlib.import_module(f"{pkg}.worker.groups")
    facade = importlib.import_module(f"{pkg}.worker.facade")
    kw = {"device": "cpu"} if pkg == "dgraph_tpu_torch" else {}
    c = groups.DistributedCluster(n_groups=2, replicas=1, **kw)
    try:
        f = facade.ClusterFacade(c)
        f.alter("name: string @index(exact) .")
        with pytest.raises(AttributeError, match="_apply_json_with_vars"):
            f.new_txn().mutate_json(set_obj={"uid": "0x1", "name": "a"}, commit_now=True)
    finally:
        c.close()


def test_reopened_proc_cluster_restarts_its_timestamps(tmp_path):
    """A ProcCluster's Zero (without a Zero quorum) keeps its timestamps
    in memory: a new coordinator on the same `data_dir` starts again at
    1, so its watermark reads see nothing of what the replicas recovered
    from disk, while a read pinned at the last snapshot of before the
    close sees all of it. Both packages; phase 11 reads after its full
    restart at the snapshot the client last saw."""
    from dgraph_tpu.worker.harness import ProcCluster as RefProc
    from dgraph_tpu_torch.worker.harness import ProcCluster

    schema = "name: string @index(exact) .\nfriend: [uid] ."
    q = '{ q(func: eq(name, "a")) { name friend { name } } }'
    got = {}
    for side, make in (("ref", lambda d: RefProc(n_groups=2, replicas=1, data_dir=d)),
                       ("port", lambda d: ProcCluster(device="cpu", n_groups=2, replicas=1,
                                                      data_dir=d))):
        d = str(tmp_path / side)
        c = make(d)
        try:
            c.alter(schema)
            c.new_txn().mutate_rdf(
                set_rdf='<0x1> <name> "a" .\n<0x1> <friend> <0x2> .\n<0x2> <name> "b" .',
                commit_now=True)
            c.move_tablet("name", 2 if c.zero.belongs_to("name") == 1 else 1)
            before, seen = c.query(q)["data"], c._snapshot_ts
        finally:
            c.close()
        c = make(d)
        try:
            c.alter(schema)
            got[side] = (before, c.query(q)["data"], c.query(q, read_ts=seen)["data"])
        finally:
            c.close()
    want = {"q": [{"name": "a", "friend": [{"name": "b"}]}]}
    assert got["ref"] == got["port"] == (want, {"q": []}, want)


# ---------------------------------------------------------------------------
# Phase 11 at a tiny size
# ---------------------------------------------------------------------------


def test_cluster_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase 11 on the CPU at a tiny size: 333 edges and
    500 tags over 2 x 3 replica processes, one kill, one move, one
    restart, and vectors on an in-process cluster; every check of the
    phase holds, the plain kernels ran, and no replica outlives it."""
    V, Q = chip_smoke.make_corpus(n=300, d=16, nq=4)
    member_sweep.PLAIN_CALLS = vector_topk.PLAIN_CALLS = 0
    out = chip_smoke.serve_cluster(
        "cpu", str(tmp_path), V, Q, fanout=10, roots=3, pool=500, n_flips=5, n_reads=3,
        chunk=400, vec_chunk=100, log=lambda m: None)
    assert out["load"]["edges"] == 3 + 30 + 300 + 500
    assert out["load"]["tablets"]["child"] != out["load"]["tablets"]["tag"]
    assert out["launches"]["setop_rows"] >= 3 and out["launches"]["vector_topk"] >= 3
    assert out["reads"]["b"]["setops"] >= 1 and out["reads"]["b"]["rpcs"] > 0
    assert out["fault"]["follower_reads"] >= 1 and out["move"]["reads"] >= 1
    assert out["move"]["reads_by_flip"]["straddling"] >= 1
    assert [p for p in out["move"]["phases_s"] if p != "move.chunk"] == [
        "move.begin", "move.copy", "move.fence", "move.delta", "move.flip", "move.drop"]
    assert out["vectors"]["rows"] == 300 and out["card_apps"] == []
    assert out["captured"][0]
    assert _children() == []


# ---------------------------------------------------------------------------
# The depth phase 11's room cost earlier phases
# ---------------------------------------------------------------------------


def test_write_phase_lsm_arm_on_cpu(monkeypatch, tmp_path):
    """Phase 8's lsm arm as chip_smoke.py runs it since phase 11: a
    quarter of the vector rows (LSM_VECTORS of 100,000), still with the
    16 similar_to reads after the restart, each one a KV1 call captured
    for the comparison with its plain version."""
    assert chip_smoke.LSM_VECTORS * 4 == 100_000
    monkeypatch.setenv("DGRAPH_TPU_STORAGE", "lsm")
    V, Q = chip_smoke.make_corpus(n=300, d=8, nq=16)
    out = chip_smoke.serve_writes(
        "cpu", str(tmp_path / "store"), V[:75], Q, fanout=6, pool=400, vec_chunk=100,
        edge_chunk=60, n_emails=30, n_pre=10, upsert_threads=4, upserts_per_thread=15,
        n_accounts=16, bank_threads=4, transfers_per_thread=8, log=lambda m: None,
    )
    assert out["load"]["vectors"] == 75 and out["u2"]["setops"] >= 1
    assert out["after_restart_launches"]["setop_rows"] >= 1
    assert out["after_restart_launches"]["vector_topk"] >= 16
    assert [site[1:] for site in out["restart_topk_sites"]] == [(10, "euclidean", False)]
    assert "similar_to" in out["read_ms"]["first"]
