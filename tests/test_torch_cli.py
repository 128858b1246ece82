"""The port's command line (`python -m dgraph_tpu_torch`), its MCP server
and operator tools against the reference's, on the CPU.

Each case runs the same commands through both packages as subprocesses:
`python -m dgraph_tpu ...` (jax on the CPU) and `python -m
dgraph_tpu_torch --device cpu ...`. What each command prints, its exit
code, the HTTP and gRPC answers of an `alpha` it started and the files
it wrote are recorded, and the port's record must equal the reference's
once clocks, pids, ports, the case's own directory and the package's
name are masked. Every alpha serves on port 0 (HTTP and gRPC) and prints
the ports it bound; every process a case starts is killed before it
ends.

The cases are the reference's CLI cases, as commands: test_cli_alpha.py
(single node and `--cluster`), test_ops_subsystems.py's
`test_cli_bulk_export_debug_increment`, test_explain.py's
`test_cli_explain_local`, test_flight_recorder.py's
`test_cli_top_renders_digest_rows`, `test_cli_debug_bundle_against_live_server`
and `test_cli_debug_bundle_partial_when_endpoint_dead`, test_multilang.py's
`test_decrypt_cli_roundtrip`, the tools of test_tools.py, plus `live`,
`backup` and `restore`, `acl`, `mcp` on stdio, `metrics-ref`,
`config-ref` and `lint`. The in-process cases of test_tools.py and the
MCP and task-queue cases of test_ops_subsystems.py run on both packages
through the runner of tests/test_torch_graphql.py.

Then the device: without a card, the port's commands that build an
engine refuse to start unless `--device cpu` is given.
"""

import gzip
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tarfile
import time
import urllib.error
import urllib.request

import pytest

import chip_smoke
from test_torch_graphql import cases, run_both, runner  # noqa: F401 - fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": "dgraph_tpu", "port": "dgraph_tpu_torch"}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Side:
    """One package's command line, run in a directory of the case's own."""

    def __init__(self, side, tmp):
        self.side, self.pkg = side, PKGS[side]
        self.tmp = str(tmp)
        os.makedirs(self.tmp, exist_ok=True)
        self.procs = []

    def argv(self, *args):
        dev = ["--device", "cpu"] if self.side == "port" else []
        return [sys.executable, "-m", self.pkg, *dev, *args]

    def path(self, name):
        return os.path.join(self.tmp, name)

    def mask(self, text):
        text = text.replace(self.tmp, "<tmp>").replace("dgraph_tpu_torch", "dgraph_tpu")
        text = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>", text)
        return re.sub(r"\d+\.\d+s\b", "<s>", text)

    def cli(self, *args, stdin=None, timeout=120):
        got = subprocess.run(self.argv(*args), cwd=self.tmp, env=_env(), input=stdin,
                             capture_output=True, text=True, timeout=timeout)
        return [got.returncode, self.mask(got.stdout)]

    def alpha(self, *args):
        """Start alpha on port 0; returns (http port, grpc port or None)."""
        # a session of its own: alpha's forked apply-pool workers carry its
        # command line and outlive a kill of alpha alone
        proc = subprocess.Popen(self.argv("alpha", "--port", "0", *args), cwd=self.tmp,
                                env=_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True, start_new_session=True)
        self.procs.append(proc)
        want_grpc = "-1" not in args
        http = grpc = None
        deadline = time.time() + 120
        while time.time() < deadline and (http is None or (want_grpc and grpc is None)):
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"{self.pkg} alpha exited: {proc.wait()}")
            m = re.match(r"alpha listening on http://[\d.]+:(\d+)", line)
            if m:
                http = int(m.group(1))
            m = re.match(r"alpha gRPC \(api\.Dgraph\) on [\d.]+:(\d+)", line)
            if m:
                grpc = int(m.group(1))
        assert http is not None, f"{self.pkg} alpha printed no port"
        return http, grpc

    def close(self):
        for p in self.procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=30)
            p.stdout.close()
        self.procs = []


def _http(port, path, body=None, ctype="application/rdf"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=None if body is None else body.encode(),
        headers={"Content-Type": ctype}, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    obj = json.loads(raw)
    if isinstance(obj, dict):
        obj.pop("extensions", None)
    return [status, obj]


def _health(port, timeout=60):
    deadline = time.time() + timeout
    while True:
        try:
            got = _http(port, "/health")
            return [got[0], [h["status"] for h in got[1]]]
        except (OSError, ValueError):
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def _grpc(side, port):
    import importlib

    mod = importlib.import_module(f"{side.pkg}.client_grpc")
    stub = mod.DgraphClientStub(f"127.0.0.1:{port}")
    try:
        c = mod.DgraphClient(stub)
        out = [c.check_version()]
        out.append(c.txn(read_only=True).query('{ q(func: eq(name, "cli-alice")) { name } }'))
        txn = c.txn()
        uids = txn.mutate(set_nquads='_:g <name> "cli-grpc" .', commit_now=True)
        out.append(sorted(uids))
        out.append(c.txn(read_only=True).query('{ q(func: eq(name, "cli-grpc")) { name } }'))
        return out
    finally:
        stub.close()


# ---------------------------------------------------------------------------
# The cases, as commands
# ---------------------------------------------------------------------------


def case_alpha(side, *extra):
    """test_cli_alpha.py: alter, mutate and query over HTTP, then gRPC."""
    http, grpc = side.alpha("--grpc_port", "0", *extra)
    out = [_health(http)]
    out.append(_http(http, "/alter", "name: string @index(exact) ."))
    out.append(_http(http, "/mutate?commitNow=true", '{ set { _:x <name> "cli-alice" . } }'))
    out[-1][1]["data"].pop("uids")  # a blank node's uid: leased per process
    out.append(_http(http, "/query", '{ q(func: eq(name, "cli-alice")) { name } }'))
    out.append(_grpc(side, grpc))
    return out


def case_bulk_export_debug_increment(side):
    """test_ops_subsystems.py's CLI case."""
    open(side.path("data.rdf"), "w").write('_:a <name> "CliUser" .\n')
    open(side.path("schema.txt"), "w").write("name: string @index(exact) .\n")
    p = side.path("p")
    out = [side.cli("bulk", "-p", p, "--schema", side.path("schema.txt"), side.path("data.rdf"))]
    out.append(side.cli("debug", "-p", p))
    out.append(side.cli("export", "-p", p, "--out", side.path("exp")))
    out.append(side.cli("increment", "-p", p, "--num", "3"))
    out.append(sorted(os.listdir(side.path("exp"))))
    return out


def case_live_backup_restore(side):
    """`live` into a data dir, a full `backup`, a `restore` into another
    data dir, and that dir's export."""
    open(side.path("data.rdf"), "w").write(
        "".join(f'<0x{i:x}> <name> "n{i}" .\n<0x{i:x}> <friend> <0x{i + 1:x}> .\n'
                for i in range(1, 40)))
    open(side.path("schema.txt"), "w").write("name: string @index(exact) .\nfriend: [uid] .\n")
    out = [side.cli("live", "-p", side.path("p"), "--schema", side.path("schema.txt"),
                    "--batch", "16", side.path("data.rdf"))]
    out.append(side.cli("backup", "-p", side.path("p"), "--dest", side.path("bk"), "--full"))
    out.append(side.cli("restore", "-p", side.path("q"), "--src", side.path("bk")))
    out.append(side.cli("export", "-p", side.path("q"), "--out", side.path("exp"),
                        "--format", "json"))
    return out


def case_explain_local(side):
    """test_explain.py's `test_cli_explain_local`: the plan of a query
    against a data dir (its wall times masked)."""
    open(side.path("data.rdf"), "w").write('<0x1> <name> "A" .\n')
    open(side.path("schema.txt"), "w").write("name: string @index(exact) .\n")
    p = side.path("data")
    out = [side.cli("bulk", "-p", p, "--schema", side.path("schema.txt"), side.path("data.rdf"))]
    rc, text = side.cli("explain", "-p", p, "{ q(func: has(name)) { name } }")
    assert text.startswith("Query plan") and "name level=1" in text
    out.append([rc, re.sub(r"\d+(\.\d+)? ?(ms|us|µs|ns|s)\b", "<t>", text)])
    return out


def case_top_and_debug_bundle(side):
    """test_flight_recorder.py's CLI cases against a live alpha started
    by the CLI: `top` (text and JSON) and `debug-bundle`."""
    http, _ = side.alpha("--grpc_port", "-1")
    _health(http)
    addr = f"http://127.0.0.1:{http}"
    _http(http, "/alter", "hname: string @index(exact) .")
    _http(http, "/mutate?commitNow=true", '{ set { <0x1> <hname> "A" . } }')
    for _ in range(2):
        _http(http, "/query", '{ q(func: eq(hname, "A")) { hname } }')
    rc, text = side.cli("top", "--addr", addr, "-n", "5")
    assert "CALLS" in text and "SHAPE" in text and "hname" in text
    out = [[rc, text.splitlines()[0].split()]]
    rc, text = side.cli("top", "--addr", addr, "--json")
    rows = json.loads(text)["digests"]
    out.append([rc, sorted(rows[0]), sorted((r["shape"], r["calls"]) for r in rows)])
    rc, text = side.cli("debug-bundle", "--addr", addr, "-o", side.path("bundle.tar.gz"))
    out.append([rc, "wrote" in text])
    with tarfile.open(side.path("bundle.tar.gz")) as tar:
        manifest = json.load(tar.extractfile("debug-bundle/MANIFEST.json"))
        lg = json.load(tar.extractfile("debug-bundle/lockgraph.json"))
        out.append([sorted(m.name for m in tar.getmembers()),
                    {f: bool(v.get("ok")) for f, v in manifest["files"].items()},
                    bool(lg["edges"])])
    return out


def case_debug_bundle_dead_endpoint(side):
    """test_flight_recorder.py's partial bundle: no alpha at all."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        dead = sk.getsockname()[1]
    rc, text = side.cli("debug-bundle", "--addr", f"http://127.0.0.1:{dead}",
                        "-o", side.path("partial.tar.gz"), "--timeout", "0.5")
    with tarfile.open(side.path("partial.tar.gz")) as tar:
        manifest = json.load(tar.extractfile("debug-bundle/MANIFEST.json"))
        return [rc, "PARTIAL" in text, sorted(m.name for m in tar.getmembers()),
                {f: [bool(v.get("ok")), bool(v.get("local"))]
                 for f, v in manifest["files"].items()}]


def case_decrypt(side):
    """test_multilang.py's `test_decrypt_cli_roundtrip`, on a file the
    side's own `enc` encrypted under one key."""
    pytest.importorskip("cryptography")
    import importlib

    enc = importlib.import_module(f"{side.pkg}.enc.enc")
    key = bytes(range(32))
    open(side.path("key"), "wb").write(key)
    plain = b"<0x1> <name> \"secret export\" .\n" * 50
    open(side.path("export.rdf"), "wb").write(enc.encrypt_stream(plain, key))
    got = side.cli("decrypt", "-f", side.path("export.rdf"), "-o", side.path("out.rdf.gz"),
                   "--encryption-key-file", side.path("key"))
    return [got, gzip.decompress(open(side.path("out.rdf.gz"), "rb").read()) == plain]


def case_tools(side):
    """test_tools.py's tools through their commands: cert (create and
    ls), conv, migrate, debuginfo, upgrade."""
    rc, text = side.cli("cert", "--dir", side.path("tls"), "--nodes", "localhost",
                        "--client", "alice")
    out = [rc, sorted(os.listdir(side.path("tls")))]
    rc, text = side.cli("cert", "--dir", side.path("tls"), "--ls")
    out.append([rc, sorted(line.split(" | ")[0] for line in text.splitlines())])
    json.dump({"type": "FeatureCollection", "features": [{
        "geometry": {"type": "Point", "coordinates": [1, 2]},
        "properties": {"name": "spot", "pop": 7}}]}, open(side.path("g.json"), "w"))
    out.append(side.cli("conv", "--geo", side.path("g.json"), "--out", "-"))
    open(side.path("users.csv"), "w").write("id,name,age\n1,ann,30\n2,ben,25\n")
    out.append(side.cli("migrate", "--tables", "users=" + side.path("users.csv"),
                        "--out-rdf", side.path("m.rdf"), "--out-schema", side.path("m.schema")))
    out.append([open(side.path("m.rdf")).read(), open(side.path("m.schema")).read()])
    rc, text = side.cli("debuginfo", "-p", side.path("p"), "--out", side.path("info"))
    out.append([rc, text.startswith("bundle: ")])
    out.append(side.cli("upgrade", "-p", side.path("p")))
    return out


def case_acl(side):
    p = side.path("p")
    return [side.cli("acl", "-p", p, "add-group", "--group", "dev"),
            side.cli("acl", "-p", p, "set-rule", "--group", "dev", "--predicate", "name",
                     "--perm", "4")]


def case_mcp_stdio(side):
    """`mcp` on stdio: initialize, list the tools, alter, mutate, query."""
    calls = [
        {"method": "initialize"},
        {"method": "tools/list"},
        {"method": "tools/call", "params": {"name": "alter_schema", "arguments": {
            "schema": "name: string @index(exact) ."}}},
        {"method": "tools/call", "params": {"name": "run_mutation", "arguments": {
            "set_rdf": '<0x1> <name> "M" .'}}},
        {"method": "tools/call", "params": {"name": "run_query", "arguments": {
            "query": '{ q(func: eq(name, "M")) { uid name } }'}}},
        {"method": "tools/call", "params": {"name": "get_schema", "arguments": {}}},
        {"method": "nope"},
    ]
    stdin = "".join(json.dumps({"jsonrpc": "2.0", "id": i, **c}) + "\n"
                    for i, c in enumerate(calls))
    rc, text = side.cli("mcp", "-p", side.path("p"), stdin=stdin)
    answers = []
    for line in text.splitlines():
        r = json.loads(line)
        for c in (r.get("result") or {}).get("content", ()):
            body = json.loads(c["text"]) if c["text"].startswith("{") else c["text"]
            if isinstance(body, dict):
                body.pop("extensions", None)
            c["text"] = body
        answers.append(r)
    return [rc, answers]


def case_references(side):
    return [side.cli("metrics-ref"), side.cli("config-ref"), side.cli("--version")]


CLI_CASES = {
    "alpha-single-node": lambda s: case_alpha(s),
    "alpha-cluster": lambda s: case_alpha(s, "--cluster", "groups=2; replicas=3"),
    "bulk-export-debug-increment": case_bulk_export_debug_increment,
    "live-backup-restore": case_live_backup_restore,
    "explain-local": case_explain_local,
    "top-and-debug-bundle": case_top_and_debug_bundle,
    "debug-bundle-dead-endpoint": case_debug_bundle_dead_endpoint,
    "decrypt": case_decrypt,
    "tools": case_tools,
    "acl": case_acl,
    "mcp-stdio": case_mcp_stdio,
    "references": case_references,
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_on_both_packages(name, tmp_path):
    """The case's commands on both packages: equal records."""
    got = {}
    for side in PKGS:
        s = Side(side, tmp_path / side)
        try:
            got[side] = CLI_CASES[name](s)
        finally:
            s.close()
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# The in-process cases of the reference's files, on both packages
# ---------------------------------------------------------------------------

INPROC_CASES = (
    cases("test_tools")
    + cases("test_ops_subsystems", only=("test_mcp_protocol", "test_mcp_stdio_loop",
                                         "test_task_queue_serializes_ops"))
)


@pytest.mark.parametrize("case", INPROC_CASES)
def test_tools_and_mcp_on_both_packages(case, runner, tmp_path, request):  # noqa: F811
    """The reference case passes on both packages, with equal answers."""
    run_both(runner, case, tmp_path, request)


# ---------------------------------------------------------------------------
# lint, and the device
# ---------------------------------------------------------------------------


def test_lint_of_the_port():
    """The port's `lint` (its copy of `analysis/` over `dgraph_tpu_torch/`)
    finds no violation and leaves no allowance unused, and exits 0, as
    the reference does (tests/test_static_analysis.py): the port's
    allowlist holds no entry for a module it does not have."""
    rc, text = Side("port", ROOT).cli("lint", "--json", timeout=300)
    rep = json.loads(text)
    assert rc == 0 and rep["violations"] == []
    assert rep["unused_allows"] == []


@pytest.mark.parametrize("args", [
    ("debug", "-p", "{tmp}/p"),
    ("alpha", "--port", "0", "--grpc_port", "-1"),
    ("explain", "-p", "{tmp}/p", "{ q(func: has(name)) { name } }"),
    ("alpha", "--port", "0", "--grpc_port", "-1", "--cluster", "groups=1; replicas=1"),
], ids=["debug", "alpha", "explain", "alpha-cluster"])
def test_commands_refuse_cuda_without_a_card(args, tmp_path):
    """No card here: the default device is cuda, so every command that
    builds an engine exits with the device error, before it serves; the
    same command with `--device cpu` runs."""
    side = Side("port", tmp_path)
    argv = [a.replace("{tmp}", str(tmp_path)) for a in args]
    got = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch", *argv], cwd=str(tmp_path),
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert got.returncode != 0
    assert "torch.cuda.is_available() is False" in got.stderr
    assert "listening" not in got.stdout
    if args[0] != "alpha":
        assert side.cli(*argv)[0] == 0


# ---------------------------------------------------------------------------
# Phase 13's command-line part (13a), rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grpc", [True, False], ids=["grpc", "http-only"])
def test_cli_phase_on_cpu(tmp_path, grpc):
    """chip_smoke's (13a) at a tiny size with `--device cpu`: `bulk`
    loads the graph into a fresh data dir, `alpha` on it answers (a)-(d)
    over HTTP (and gRPC) equal to an in-process Server's answers byte for
    byte, its metrics route counts set-op pairs, and alpha is gone after."""
    quiet = lambda m: None  # noqa: E731
    g, answers = chip_smoke.mesh_data("cpu", fanout=6, pool=400, log=quiet)
    out = chip_smoke.serve_cli("cpu", str(tmp_path), g, answers, grpc=grpc, log=quiet)
    transports = ["http", "grpc"] if grpc else ["http"]
    assert sorted(out["ms"]) == sorted(f"{t} {q}" for t in transports for q in "abcd")
    assert out["bulk"].startswith(f"bulk loaded {6 + 36 + 216 + 400} nquads")
    assert out["setop_pairs_total"] > 0
    left = subprocess.run(["ps", "-eo", "args"], capture_output=True, text=True).stdout
    assert str(tmp_path) not in left
