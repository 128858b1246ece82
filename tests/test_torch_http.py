"""The port's HTTP front, its client and the websocket against the
reference's, on the CPU.

Each case is a reference test run on both packages by the runner of
tests/test_torch_graphql.py (once as written, once with `dgraph_tpu`
rebound to `dgraph_tpu_torch`, the port's entry points on the CPU), its
HTTP responses, websocket frames, GraphQL results and query answers
recorded and held equal (the module docstring there says how).

Files: tests/test_http.py and test_client.py whole; the HTTP cases of
test_cluster_facade.py (`test_http_over_cluster`), test_acl.py
(`test_admin_routes_guardian_only`), test_rdf_output.py
(`test_http_resp_format_rdf`), test_serving_front.py
(`test_http_429_with_retryable_code`), test_explain.py
(`test_http_debug_flag`) and test_flight_recorder.py
(`test_debug_http_flight_recorder_routes`). Their gRPC, MCP and CLI
cases are left out: those servers and the CLI are not ported yet.

Then the repair of the debug bundle: the port's `analysis/` copies give
`ProcCluster.debug_bundle()` and `/debug/bundle` the port's own static
lock graph, with no `error` entry, equal to the reference's on the
modules both packages share verbatim.
"""

import json
import os
import urllib.request

import pytest

from test_torch_graphql import cases, run_both, runner  # noqa: F401 - fixture

HTTP_CASES = (
    cases("test_http") + cases("test_client")
    + cases("test_cluster_facade", only=("test_http_over_cluster",))
    + cases("test_acl", only=("test_admin_routes_guardian_only",))
    + cases("test_rdf_output", only=("test_http_resp_format_rdf",))
    + cases("test_serving_front", only=("test_http_429_with_retryable_code",))
    + cases("test_explain", only=("test_http_debug_flag",))
    + cases("test_flight_recorder", only=("test_debug_http_flight_recorder_routes",))
)


@pytest.mark.parametrize("case", HTTP_CASES)
def test_http_on_both_packages(case, runner, tmp_path, request):  # noqa: F811
    """The reference case passes on both packages, with equal answers."""
    run_both(runner, case, tmp_path, request)


# ---------------------------------------------------------------------------
# The debug bundle's lock graph
# ---------------------------------------------------------------------------


def _shared_edges(edges):
    """The lock-graph edges found in modules that both packages share
    verbatim (the copies without a repaired function)."""
    from test_torch_isolation import COPIES, REPAIRED

    shared = set(COPIES) - set(REPAIRED)
    return sorted(json.dumps(e, sort_keys=True) for e in edges if e["path"] in shared)


def test_debug_bundle_route_carries_the_ports_lock_graph(tmp_path):
    """`/debug/bundle` over a ProcCluster (its `debug_bundle()`): the port's
    bundle carries its own static lock graph, edges with no `error`
    entry, and on the modules both packages share verbatim the edges
    (outer and inner lock, path, line, kind; paths relative to each
    package) equal the reference's."""
    from dgraph_tpu.api.http_server import HTTPServer as RefHTTP
    from dgraph_tpu.worker.harness import ProcCluster as RefProc
    from dgraph_tpu_torch.api.http_server import HTTPServer
    from dgraph_tpu_torch.worker.harness import ProcCluster

    graphs = {}
    for side, make, http in (
        ("ref", lambda d: RefProc(n_groups=1, replicas=1, data_dir=d), RefHTTP),
        ("port", lambda d: ProcCluster(device="cpu", n_groups=1, replicas=1, data_dir=d),
         HTTPServer),
    ):
        c = make(str(tmp_path / side))
        srv = http(c, port=0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/debug/bundle?window=60", timeout=120) as r:
                assert r.status == 200
                graphs[side] = json.loads(r.read())["lock_graph"]
        finally:
            srv.stop()
            c.close()
    port, ref = graphs["port"], graphs["ref"]
    assert port and all({"outer", "inner", "path", "line", "kind"} <= set(e) for e in port)
    assert not [e for e in port if "error" in e]
    assert not any(e["path"].startswith(("dgraph_tpu", "/")) for e in port)
    assert _shared_edges(port) == _shared_edges(ref) != []
