"""The PyTorch port stands alone.

- No module of `dgraph_tpu_torch/`, nor `chip_smoke.py` or
  `member_sweep_crossover.py`, imports jax or anything of `dgraph_tpu`,
  lazily or not (an AST walk).
- With both names blocked on `sys.meta_path`, a subprocess imports the
  port, alters a schema, commits a mutation and answers a query on the
  CPU; then it alters an `hnsw` vector predicate, commits three vectors
  and answers a `similar_to`; then, on a store in a temporary
  `data_dir`, it commits a JSON mutation and a conditional upsert, and
  a second Server opened on that directory answers as the first did.
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
    "query/dispatch.py",
    # package inits that do not re-export modules the slice leaves out
    "serving/__init__.py",
    "worker/__init__.py",
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
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dgraph_tpu")))
"""


def test_runs_with_jax_and_reference_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    got = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert got.returncode == 0, got.stderr[-3000:]
    data, similar, restart, mods = got.stdout.strip().splitlines()[-4:]
    assert json.loads(data) == {
        "q": [{"friend": [{"uid": "0x3"}, {"uid": "0x100000004"}]}]
    }
    assert json.loads(similar) == {"v": [{"name": "a"}, {"name": "b"}]}
    before, after = json.loads(restart)
    assert before == after == {"q": [
        {"uid": "0x2", "name": "a", "email": "a@x"},
        {"uid": "0x3", "name": "b", "email": "b@x"},
    ]}
    assert mods == "[]"


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
    r for r in _port_files((".py", ".cpp"))
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
