"""The PyTorch port stands alone.

- No module of `dgraph_tpu_torch/`, nor `chip_smoke.py` or
  `member_sweep_crossover.py`, imports jax or anything of `dgraph_tpu`,
  lazily or not (an AST walk).
- With both names blocked on `sys.meta_path`, a subprocess imports the
  port, alters a schema, commits a mutation and answers a query on the
  CPU; then it alters an `hnsw` vector predicate, commits three vectors
  and answers a `similar_to`; then, on a store in a temporary
  `data_dir`, it commits a JSON mutation and a conditional upsert, and
  a second Server opened on that directory answers as the first did;
  then the first query, asked again, hits the plan cache,
  `query_rdf` answers in N-Quads, and with ACL on groot logs in and an
  authorised query answers as it did with ACL off; last, on a new
  Server, a subscription fires on a commit, a CDC file sink holds the
  commit's event, a backup restores into another Server that answers as
  the first, and `bulk_load_rdf` loads N-Quads that a query reads back;
  then a mutation over both groups of a `DistributedCluster` (2 x 3),
  applied in predicate shards, and one through a `ProcCluster` (2 x 3)
  answer a query. A `sitecustomize.py` on `PYTHONPATH` installs the same
  blocker in the cluster's replica processes, each of which must run a
  `dgraph_tpu_torch` module. Last, a GraphQL schema uploaded through the
  HTTP front's `/admin/schema/graphql` takes a GraphQL mutation and
  answers a GraphQL query and a `/graphql` request; the gRPC front
  answers `client_grpc` with the port's own protocol module, and a mesh
  of two host shards answers `sharded_membership`. Then the command line
  (`python -m dgraph_tpu_torch --device cpu`) bulk-loads a data dir and
  `debug` reads it back, in an interpreter with the same blocker.
- Every module the port copied from the reference equals it but for the
  rebinding of `dgraph_tpu` to `dgraph_tpu_torch` and for citations of
  the upstream Go sources, written `dgraph/<path>` in the port; the
  modules the port repaired differ only in the functions named here.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dgraph_tpu_torch")
REF = os.path.join(ROOT, "dgraph_tpu")
BANNED = ("jax", "jaxlib", "dgraph_tpu")

# rewritten for torch, or cut to the slice: not copies
PORTED = {
    "__init__.py",
    "api/server.py",
    "carry.py",
    "device.py",
    "ops/cuda_build.py",
    "ops/ivf_scan.py",
    "ops/member_sweep.py",
    "ops/setops.py",
    "ops/vector_topk.py",
    "parallel/mesh.py",
    "query/dispatch.py",
}
# copies with a repair: (module, top-level function or Class.method)
REPAIRED = {
    # the float paths' device programs -> torch.matmul + KV1 / KV2 on the
    # index's own torch device; the quantized engine, k-means and
    # assignment stay verbatim
    "models/vector.py": [
        "_cpu_backend", "_jit_brute", "_jit_brute_batch", "_ivf_probe",
        "_jit_ivf", "_jit_ivf_batch", "_distances", "_distances_batch",
        "VectorIndex.__init__", "VectorIndex._use_quant",
        "VectorIndex._sync_device", "VectorIndex.search",
        "VectorIndex.search_batch", "VectorIndex._train_ivf",
        "VectorIndex._ivf_search", "VectorIndex._ivf_search_batch",
    ],
    "query/subgraph.py": ["Executor._order_uids_topk"],  # jax.lax.top_k -> torch
    # the cluster entry points take the coordinator's device, as Server
    # does, and build their vector indexes on it
    "worker/groups.py": ["DistributedCluster.__init__", "DistributedCluster.alter"],
    "worker/harness.py": ["ProcCluster.__init__"],
    # the command line takes the device (`--device`, cuda by default) and
    # hands it to every engine it builds
    "cli.py": ["_server", "cmd_alpha", "cmd_explain", "main"],
    # the protocol module loads as this package's own, not as a top-level
    # `api_pb2` that the reference may already have loaded
    "protos/__init__.py": ["load_api_pb2"],
}


def _port_files(suffixes=(".py",)):
    out = []
    for d, _, files in os.walk(PORT):
        if "_build" in d or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(suffixes):
                out.append(os.path.relpath(os.path.join(d, f), PORT))
    return sorted(out)


def _banned_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module"
            )
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names = [str(node.args[0].value)]
        for n in names:
            if n.split(".")[0] in BANNED:
                bad.append((node.lineno, n))
    return bad


@pytest.mark.parametrize(
    "rel", _port_files() + ["../chip_smoke.py", "../member_sweep_crossover.py"],
    ids=lambda r: r,
)
def test_no_jax_or_reference_imports(rel):
    assert _banned_imports(os.path.normpath(os.path.join(PORT, rel))) == []


_BLOCKED_RUN = r"""
import json, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dgraph_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import numpy as np
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.query import dispatch

dispatch._FORCE_DEVICE = True
dispatch._USE_PALLAS = True
s = Server(device="cpu")
s.alter("name: string @index(exact) .\nfriend: [uid] .")
s.new_txn().mutate_rdf(
    set_rdf='<0x2> <name> "a" .\n<0x3> <name> "b" .\n<0x100000004> <name> "b" .\n'
    '<0x2> <friend> <0x3> .\n<0x2> <friend> <0x100000004> .',
    commit_now=True,
)
out = s.query('{ q(func: eq(name, "a")) { friend @filter(eq(name, "b")) { uid } } }')
print(json.dumps(out["data"]))
s.alter('emb: float32vector @index(hnsw(metric:"euclidean")) .')
s.new_txn().mutate_rdf(
    set_rdf='<0x2> <emb> "[1.0, 0.0]"^^<float32vector> .\n'
    '<0x3> <emb> "[0.9, 0.2]"^^<float32vector> .\n'
    '<0x100000004> <emb> "[-1.0, 0.5]"^^<float32vector> .',
    commit_now=True,
)
out = s.query('{ v(func: similar_to(emb, 2, "[1.0, 0.1]")) { name } }')
print(json.dumps(out["data"]))
import shutil, tempfile
d = tempfile.mkdtemp()
w = Server(device="cpu", data_dir=d)
w.alter("email: string @index(exact) @upsert .\nname: string @index(exact) .")
w.new_txn().mutate_json(set_obj={"uid": "_:a", "name": "a", "email": "a@x"}, commit_now=True)
for _ in range(2):
    w.new_txn().upsert(
        '{ v as var(func: eq(email, "b@x")) }',
        set_rdf='_:b <email> "b@x" .\n_:b <name> "b" .', cond="@if(eq(len(v), 0))",
    )
q = '{ q(func: has(email)) { uid name email } }'
before = w.query(q)["data"]
w.kv.sync()
w.kv.close()
r = Server(device="cpu", data_dir=d)
print(json.dumps([before, r.query(q)["data"]]))
r.kv.close()
shutil.rmtree(d)
q0 = '{ q(func: eq(name, "a")) { friend @filter(eq(name, "b")) { uid } } }'
first = s.query(q0)["data"]
hits = s.serving.plan_cache.stats()["hits"]
again = s.query(q0)
hits = s.serving.plan_cache.stats()["hits"] - hits
rdf = s.query_rdf('{ q(func: eq(name, "a")) { name friend { uid } } }')
s.enable_acl(secret=b"k" * 32)
tok = s.login("groot", "password")["accessJwt"]
authed = s.query(q0, access_jwt=tok)
print(json.dumps([hits, again["data"],
                  sorted(rdf.strip().splitlines()), first, authed["data"]]))
from dgraph_tpu_torch.admin.backup import backup, restore
from dgraph_tpu_torch.admin.cdc import cdc_for_uri
from dgraph_tpu_torch.api.subscriptions import Subscriptions
from dgraph_tpu_torch.loaders.bulk import bulk_load_rdf
o = Server(device="cpu")
o.alter("name: string @index(exact) .")
fired = []
Subscriptions(o).subscribe('{ q(func: has(name)) { name } }', fired.append)
d = tempfile.mkdtemp()
cdc = cdc_for_uri(o, d + "/cdc.ndjson")
o.new_txn().mutate_rdf(set_rdf='<0x5> <name> "e" .', commit_now=True)
cdc.flush()
cdc.close()
events = [json.loads(l)["event"] for l in open(d + "/cdc.ndjson")]
backup(o, d + "/bk")
r = Server(device="cpu")
restore(r, d + "/bk")
b = Server(device="cpu")
b.alter("name: string @index(exact) .")
bulk_load_rdf(b, '<0x7> <name> "f" .')
shutil.rmtree(d)
print(json.dumps([[f["data"] for f in fired],
                  [(e["operation"], e["uid"], e["attr"], e["value"]) for e in events],
                  r.query('{ q(func: eq(name, "e")) { uid name } }')["data"],
                  b.query('{ q(func: has(name)) { uid name } }')["data"]]))
import os
os.environ["DGRAPH_TPU_BATCH_APPLY"] = "0"  # edges take the Python apply,
os.environ["DGRAPH_TPU_APPLY_SHARDS"] = "2"  # split over two shards
from dgraph_tpu_torch.posting import mutation
from dgraph_tpu_torch.worker.groups import DistributedCluster
from dgraph_tpu_torch.worker.harness import ProcCluster
sharded = []
_apply = mutation._apply_edges_sharded
mutation._apply_edges_sharded = lambda *a: sharded.append(len(a[2])) or _apply(*a)
schema = "name: string @index(exact) .\nfriend: [uid] ."
rdf = '<0x1> <name> "a" .\n<0x1> <friend> <0x2> .\n<0x2> <name> "b" .'
q1 = '{ q(func: eq(name, "a")) { name friend { name } } }'
dc = DistributedCluster(device="cpu", n_groups=2, replicas=3)
dc.alter(schema)
dc.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
tablets = sorted(set(dc.zero.tablets.values()))
dist = dc.query(q1)["data"]
dc.close()
d = tempfile.mkdtemp()
pc = ProcCluster(device="cpu", n_groups=2, replicas=3, data_dir=d)
try:
    pc.alter(schema)
    pc.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
    proc = pc.query(q1)["data"]
    children = []
    for p in pc.procs.values():
        cmd = open(f"/proc/{p.pid}/cmdline").read().split("\0")
        env = dict(
            kv.split("=", 1) for kv in open(f"/proc/{p.pid}/environ").read().split("\0")
            if "=" in kv
        )
        children.append([cmd[cmd.index("-m") + 1], env.get("PYTHONPATH", "")])
finally:
    pc.close()
shutil.rmtree(d)
print(json.dumps([sharded, tablets, dist, proc, children]))
from dgraph_tpu_torch.api.http_server import HTTPServer
from dgraph_tpu_torch.client import DgraphClient
g = Server(device="cpu")
srv = HTTPServer(g, port=0).start()
try:
    c = DgraphClient(f"http://127.0.0.1:{srv.port}")
    c.set_graphql_schema("type Person { id: ID! name: String @search(by: [exact]) }")
    added = g.graphql.execute('mutation { addPerson(input: [{name: "a"}, {name: "b"}]) '
                              '{ numUids } }')
    direct = g.graphql.execute('query { queryPerson(filter: {name: {eq: "b"}}) { name } }')
    served = c.graphql('query { queryPerson(order: {asc: name}) { name } }')
finally:
    srv.stop()
print(json.dumps([added, direct, served]))
from dgraph_tpu_torch.api.grpc_server import pb, serve
from dgraph_tpu_torch.client_grpc import DgraphClient, DgraphClientStub
from dgraph_tpu_torch.parallel import mesh as pmesh
gs, gport = serve(b)
stub = DgraphClientStub(f"127.0.0.1:{gport}")
try:
    over_grpc = DgraphClient(stub).txn(read_only=True).query('{ q(func: has(name)) { uid name } }')
finally:
    stub.close()
    gs.stop(0)
pmesh.HOST_WIDTH = 2
m = pmesh.make_mesh(device="cpu")
mask = pmesh.sharded_membership(m, np.array([1, 3, 5, 7], np.uint32), 3,
                                np.array([3, 7, 9, 0xFFFFFFFF], np.uint32), 3)
print(json.dumps([over_grpc, pb.__name__, m.size, mask.tolist()]))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dgraph_tpu")))
"""

# installed in every interpreter that finds it on PYTHONPATH, so in the
# cluster's replica processes too (`_spawn` keeps the caller's PYTHONPATH)
_SITECUSTOMIZE = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dgraph_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
"""


def test_runs_with_jax_and_reference_blocked(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path)
    got = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert got.returncode == 0, got.stderr[-3000:]
    lines = got.stdout.strip().splitlines()[-9:]
    data, similar, restart, front, ops, cluster, graphql, grpc_mesh, mods = lines
    assert json.loads(data) == {
        "q": [{"friend": [{"uid": "0x3"}, {"uid": "0x100000004"}]}]
    }
    assert json.loads(similar) == {"v": [{"name": "a"}, {"name": "b"}]}
    before, after = json.loads(restart)
    assert before == after == {"q": [
        {"uid": "0x2", "name": "a", "email": "a@x"},
        {"uid": "0x3", "name": "b", "email": "b@x"},
    ]}
    hits, again, rdf, first, authed = json.loads(front)
    assert hits == 1
    assert rdf == [
        '<0x2> <friend> <0x100000004> .',
        '<0x2> <friend> <0x3> .',
        '<0x2> <name> "a" .',
    ]
    assert authed == again == first == json.loads(data)
    fired, events, restored, bulk = json.loads(ops)
    assert fired == [{"q": []}, {"q": [{"name": "e"}]}]
    assert events == [["set", 5, "name", "e"]]
    assert restored == {"q": [{"uid": "0x5", "name": "e"}]}
    assert bulk == {"q": [{"uid": "0x7", "name": "f"}]}
    sharded, tablets, dist, proc, children = json.loads(cluster)
    # each cluster's coordinator applied the mutation's 3 edges in shards
    assert sharded == [3, 3]
    assert tablets == [1, 2]
    assert dist == proc == {"q": [{"name": "a", "friend": [{"name": "b"}]}]}
    assert len(children) == 6
    for module, pythonpath in children:
        assert module == "dgraph_tpu_torch.worker.alpha_process"
        assert str(tmp_path) in pythonpath.split(os.pathsep)
    added, direct, served = json.loads(graphql)
    assert added == {"data": {"addPerson": {"numUids": 2}}}
    assert direct == {"data": {"queryPerson": [{"name": "b"}]}}
    assert served == {"data": {"queryPerson": [{"name": "a"}, {"name": "b"}]}}
    over_grpc, pb_name, mesh_size, mask = json.loads(grpc_mesh)
    assert over_grpc == bulk
    assert pb_name == "dgraph_tpu_torch.protos.api_pb2"
    assert mesh_size == 2 and mask == [False, True, False, False]
    assert mods == "[]"
    # the command line, in an interpreter that has the blocker too
    pdir = str(tmp_path / "p")
    for args in (["bulk", "-p", pdir, "--schema", str(tmp_path / "schema.txt"),
                  str(tmp_path / "data.rdf")], ["debug", "-p", pdir]):
        (tmp_path / "schema.txt").write_text("name: string @index(exact) .\n")
        (tmp_path / "data.rdf").write_text('<0x1> <name> "a" .\n')
        cli = subprocess.run(
            [sys.executable, "-m", "dgraph_tpu_torch", "--device", "cpu", *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        )
        assert cli.returncode == 0, cli.stderr[-3000:]
    assert json.loads(cli.stdout) == {"name": {"data": 1, "index": 1, "schema": 1}}


def _without(source, names):
    """The source with the named top-level functions / Class.methods cut."""
    tree = ast.parse(source)
    lines = source.splitlines(keepends=True)
    spans = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name in names:
                spans.append(node)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and (
                        f"{node.name}.{sub.name}" in names
                    ):
                        spans.append(sub)
    for node in sorted(spans, key=lambda n: -n.lineno):
        start = min([node.lineno] + [d.lineno for d in node.decorator_list]) - 1
        del lines[start : node.end_lineno]
    return "".join(lines)


COPIES = [
    r for r in _port_files((".py", ".cpp", ".proto"))
    if r not in PORTED and os.path.exists(os.path.join(REF, r))
]


@pytest.mark.parametrize("rel", COPIES, ids=lambda r: r)
def test_copies_have_not_drifted(rel):
    port = open(os.path.join(PORT, rel)).read()
    ref = open(os.path.join(REF, rel)).read()
    names = REPAIRED.get(rel, [])
    if names:
        port, ref = _without(port, names), _without(ref, names)
    assert port.replace("dgraph_tpu_torch", "dgraph_tpu") == _upstream_cited(ref)


def _upstream_cited(source):
    """The reference with its citations of the upstream Go checkout
    (`<checkout>/edgraph/access.go`) written as the port writes them."""
    return re.sub(r"/\w+/reference/", "dgraph/", source)


def test_every_port_module_is_accounted_for():
    """A module is a copy (with a reference counterpart) or ported."""
    for rel in _port_files():
        assert rel in PORTED or os.path.exists(os.path.join(REF, rel)), rel
    assert set(REPAIRED) <= set(COPIES)
