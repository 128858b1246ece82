"""The port's executor with a worker pool against its serial self and the
reference, on the set-op kernel's device path.

Port twin of tests/test_parallel_exec.py's smoke and var-binding cases:
each query runs through `dgraph_tpu_torch.api.server.Server(device="cpu")`
serially and with DGRAPH_TPU_EXEC_WORKERS=4, with every set op forced
onto the device path (so the level workers call setop_rows from several
threads at once, each call with look-back state of its own), and both
answers must equal the reference Server's serial answer byte for byte.
"""

import json
import os

import pytest

from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.ops import setop_rows
from dgraph_tpu_torch.query import dispatch
from test_parallel_exec import CASES, HERE, SMOKE_CASES, VAR_QUERIES


def _load(server):
    server.alter(open(os.path.join(HERE, "schema.txt")).read())
    for rdf in ("triples.rdf", "triples_facets.rdf"):
        with open(os.path.join(HERE, rdf)) as f:
            server.new_txn().mutate_rdf(set_rdf=f.read(), commit_now=True)
    return server


def _data(server, q, workers):
    """The response's `data` bytes with `workers` executor workers, or the
    error it raised (both modes must fail alike)."""
    os.environ["DGRAPH_TPU_EXEC_WORKERS"] = workers
    try:
        data = server.query(q, want="raw")["data"]
    except Exception as exc:  # the error surface is part of the answer
        return f"{type(exc).__name__}: {exc}"
    finally:
        os.environ.pop("DGRAPH_TPU_EXEC_WORKERS", None)
    return data.raw if hasattr(data, "raw") else json.dumps(data, sort_keys=True).encode()


@pytest.fixture(scope="module")
def servers():
    return _load(RefServer()), _load(Server(device="cpu"))


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    monkeypatch.setattr(dispatch, "_USE_PALLAS", True)


def _all_equal(servers, q):
    ref, port = servers
    want = _data(ref, q, "1")
    assert _data(port, q, "1") == want
    assert _data(port, q, "4") == want


@pytest.mark.parametrize("case", SMOKE_CASES, ids=[c["id"] for c in SMOKE_CASES])
def test_exec_workers_smoke(servers, device_path, case):
    _all_equal(servers, case["query"])


@pytest.mark.parametrize("q", VAR_QUERIES, ids=range(len(VAR_QUERIES)))
def test_exec_workers_var_binding(servers, device_path, q):
    _all_equal(servers, q)


def test_exec_workers_reach_setop_rows(servers, device_path):
    """The workers' levels go through setop_rows: a filtered fan-out read
    with 4 workers calls it (its plain version on the CPU)."""
    q = next(c["query"] for c in CASES if "@filter" in c["query"] and "friend" in c["query"])
    calls = setop_rows.PLAIN_CALLS
    _all_equal(servers, q)
    assert setop_rows.PLAIN_CALLS > calls
