"""The port's gRPC front (`api/grpc_server.py`, the `api.Dgraph` service)
and its client (`client_grpc.py`) against the reference's, on the CPU.

Each case is a reference test run on both packages by the runner of
tests/test_torch_graphql.py (once as written, once with `dgraph_tpu`
rebound to `dgraph_tpu_torch`, the port's entry points on the CPU).
Besides what that runner records, every response of the gRPC servicer
is recorded (its method and the message as a dict, the `json` payload
parsed, the measured `latency` and JWTs masked), as is every call it
aborts with its status code. The port's must equal the reference's.

Files: tests/test_client_grpc.py and test_grpc_api.py whole, and the
gRPC cases of test_cluster_facade.py (`test_grpc_over_cluster`) and
test_rdf_output.py (`test_grpc_resp_format_rdf`). The reference's
`test_client_grpc.py::test_client_commit_now_and_json` has failed in
whole-suite runs with 6 workers and passed alone (ROADMAP Queue 3); here
it runs on both packages in one process.

Then the protocol module: each package loads its own `api_pb2` (the
port as `dgraph_tpu_torch.protos.api_pb2`, from its own directory), and
both give the same message classes, so either package's client talks to
either package's server.
"""

import importlib
import json
import os

import pytest

import test_torch_graphql
from test_torch_graphql import _JWT, cases, run_both, runner  # noqa: F401 - fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("Login", "Query", "Alter", "CommitOrAbort", "CheckVersion")


def _message(resp):
    from google.protobuf.json_format import MessageToDict

    resp = type(resp).FromString(resp.SerializeToString())
    if hasattr(resp, "latency"):
        resp.ClearField("latency")
    out = MessageToDict(resp, preserving_proto_field_name=True)
    if getattr(resp, "json", b""):
        out["json"] = json.loads(resp.json)
    if getattr(resp, "rdf", b""):
        out["rdf"] = resp.rdf.decode()
    return json.loads(_JWT.sub("<jwt>", json.dumps(out)))


_SINKS = {}  # package -> the running case's answers


def _install(pkg):
    """Wrap the package's servicer methods once: a module-scoped fixture's
    server binds them when it starts and serves later cases with them, so
    each wrapper appends to the answers of whichever case is running."""
    servicer = importlib.import_module(f"{pkg}.api.grpc_server").DgraphServicer
    if "_recorded" in vars(servicer):
        return
    for name in METHODS:
        def call(self, request, context, _real=getattr(servicer, name), _name=name):
            sink = _SINKS.get(pkg)
            try:
                resp = _real(self, request, context)
            except Exception:
                if sink is not None:
                    sink.append(["grpc", _name, "aborted", str(context.code())])
                raise
            if sink is not None:
                sink.append(["grpc", _name, _message(resp)])
            return resp

        setattr(servicer, name, call)
    servicer._recorded = True


def record_grpc(mp, pkg, answers):
    """The runner's recording, plus every gRPC servicer response."""
    _record(mp, pkg, answers)
    _install(pkg)
    mp.setitem(_SINKS, pkg, answers)


_record = test_torch_graphql.record

GRPC_CASES = (
    cases("test_client_grpc") + cases("test_grpc_api")
    + cases("test_cluster_facade", only=("test_grpc_over_cluster",))
    + cases("test_rdf_output", only=("test_grpc_resp_format_rdf",))
)


@pytest.mark.parametrize("case", GRPC_CASES)
def test_grpc_on_both_packages(case, runner, tmp_path, request, monkeypatch):  # noqa: F811
    """The reference case passes on both packages, with equal answers and
    equal gRPC responses."""
    monkeypatch.setattr(test_torch_graphql, "record", record_grpc)
    got = run_both(runner, case, tmp_path, request)
    assert any(a[0] == "grpc" for a in got)


def test_each_package_loads_its_own_protocol_module():
    from dgraph_tpu.api import grpc_server as ref
    from dgraph_tpu_torch.api import grpc_server as port

    assert port.pb.__name__ == "dgraph_tpu_torch.protos.api_pb2"
    assert os.path.dirname(port.pb.__file__) == os.path.join(ROOT, "dgraph_tpu_torch", "protos")
    assert os.path.dirname(ref.pb.__file__) == os.path.join(ROOT, "dgraph_tpu", "protos")
    assert port.pb is not ref.pb and port.pb.Request is ref.pb.Request


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("dgraph_tpu", "dgraph_tpu_torch"), ("dgraph_tpu_torch", "dgraph_tpu")])
def test_clients_and_servers_interoperate(client_pkg, server_pkg):
    """One package's `client_grpc` against the other's server."""
    server = importlib.import_module(f"{server_pkg}.api.server").Server
    engine = server(device="cpu") if server_pkg == "dgraph_tpu_torch" else server()
    gs, port = importlib.import_module(f"{server_pkg}.api.grpc_server").serve(engine)
    client = importlib.import_module(f"{client_pkg}.client_grpc")
    stub = client.DgraphClientStub(f"127.0.0.1:{port}")
    try:
        c = client.DgraphClient(stub)
        c.alter(schema="name: string @index(exact) .")
        c.txn().mutate(set_nquads='<0x7> <name> "x" .', commit_now=True)
        got = c.txn(read_only=True).query('{ q(func: eq(name, "x")) { uid name } }')
        assert got == {"q": [{"uid": "0x7", "name": "x"}]}
    finally:
        stub.close()
        gs.stop(0)
