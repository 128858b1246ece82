"""The benchmark imports no JAX and nothing of the JAX package (by whole
top-level name: the port's name begins with the JAX package's), reads
nothing of the repository's older benchmarks, and prints no result
without a card."""

import ast
import os
import subprocess
import sys

from portbench import isolation

FORBIDDEN = set(isolation.FORBIDDEN)


def _sources(root):
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_forbidden_import_in_any_source(root):
    for path in _sources(root):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in FORBIDDEN and top not in ("benchmarks", "bench"), (path, n)


def test_reads_import_nothing_of_the_port(root):
    for path in _sources(root):
        if os.sep + "reads" + os.sep not in path:
            continue
        with open(path) as f:
            assert "dgraph_tpu_torch" not in f.read(), path


def test_whole_name_check():
    assert isolation.loaded_forbidden({"dgraph_tpu_torch": 1, "dgraph_tpu_torch.ops": 1}) == []
    assert isolation.loaded_forbidden({"dgraph_tpu.ops": 1, "jaxlib": 1}) == ["dgraph_tpu", "jaxlib"]


_BLOCKED_RUN = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in ("jax", "jaxlib", "flax", "dgraph_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
from portbench import isolation
from portbench.tests import _tiny
r = _tiny.run({root!r}, {cell!r})
assert r["correct"], r["checks"]
assert isolation.loaded_forbidden() == [], isolation.loaded_forbidden()
print("ok")
"""


def test_a_run_loads_no_jax(root):
    code = _BLOCKED_RUN.format(root=root, cell="ldbc-sf1.fof2")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                       cwd=root)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-3000:]


def test_no_card_no_result(root):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ldbc-sf1.fof2",
                        "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=600, cwd=root)
    import torch

    if not torch.cuda.is_available():
        assert p.returncode == 2 and p.stdout == "", (p.returncode, p.stdout[-500:])


_ALONE = r"""
import sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ["portbench/run.py", "--workload", "ldbc-sf1.fof2", "--seed", "5",
            "--seconds", "1", "--trace", "0"]
sys.path = [p for p in sys.path if p not in ("", {repo!r})]
import runpy
runpy.run_path("portbench/run.py", run_name="__main__")
"""


def test_alone_in_a_directory_no_result(tmp_path, root):
    import json
    import shutil

    from portbench.tests import _tiny

    # a graph cell: its data is made on the host, so the run gets as far
    # as loading it into the port, which is not there
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_tiny.spec(root)))
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c", _ALONE.format(repo=root)], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode not in (0, None) and p.stdout == "", (p.returncode, p.stdout[-500:])
