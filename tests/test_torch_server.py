"""The port's embedded Server against the JAX reference Server.

The whole DQL golden corpus (the 535 cases of tests/ref_golden) runs
through `dgraph_tpu.api.server.Server` and through
`dgraph_tpu_torch.api.server.Server(device="cpu")`; the `data` bytes
must be equal. The port answers from three stores:
loaded through its own mutations, carried over from the reference's KV
dump (`carry_state`), and loaded again but with every set op forced onto
the torch device path with the member sweep on. A small fan-out graph
whose rows straddle the 2^32 uid segment boundary (chip_smoke's graph,
cut to size) checks queries (a)-(d) against the reference and numpy.
"""

import json
import os

import pytest

import chip_smoke
from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.carry import carry_state
from dgraph_tpu_torch.ops import member_sweep, setop_rows
from dgraph_tpu_torch.query import dispatch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ref_golden")
CASES = json.load(open(os.path.join(HERE, "cases.json")))
SMOKE_CASES = CASES
STORES = ["loaded", "carried", "loaded-device"]


def _read(name):
    with open(os.path.join(HERE, name)) as f:
        return f.read()


def _load(server):
    server.alter(_read("schema.txt"))
    for rdf in ("triples.rdf", "triples_facets.rdf"):
        server.new_txn().mutate_rdf(set_rdf=_read(rdf), commit_now=True)
    return server


def _schema_text(server):
    """The reference's whole schema as text: its alters and the
    predicates its mutations created, which only its memory holds. The
    reference's export line drops `@noconflict` (so does the port's
    copy), so it is added back here."""
    from dgraph_tpu.admin.export import _schema_line

    def line(su):
        text = _schema_line(su)
        return text[: -len(" .")] + " @noconflict ." if su.no_conflict else text

    lines = [line(server.schema.get(p)) for p in server.schema.predicates()]
    for name in server.schema.types():
        fields = "\n  ".join(server.schema.get_type(name).fields)
        lines.append(f"type {name} {{\n  {fields}\n}}")
    return "\n".join(lines) + "\n"


def _data_bytes(server, q):
    """The response's `data` wire bytes, or the error it raised."""
    try:
        data = server.query(q, want="raw")["data"]
    except Exception as exc:  # the error surface is part of the answer
        return f"{type(exc).__name__}: {exc}"
    if hasattr(data, "raw"):
        return data.raw
    return json.dumps(data, sort_keys=True).encode()  # schema blocks


@pytest.fixture(scope="module")
def servers():
    ref = _load(RefServer())
    loaded = _load(Server(device="cpu"))
    carried = carry_state(
        ref.kv.dump_bytes(), _schema_text(ref),
        ref.zero._max_uid, ref.zero.max_assigned, device="cpu",
    )
    return {"ref": ref, "loaded": loaded, "carried": carried}


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("case", SMOKE_CASES, ids=[c["id"] for c in SMOKE_CASES])
def test_golden_smoke_bytes_equal(servers, store, case, monkeypatch):
    if store == "loaded-device":
        monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
        monkeypatch.setattr(dispatch, "_USE_PALLAS", True)
    want = _data_bytes(servers["ref"], case["query"])
    got = _data_bytes(servers[store.split("-")[0]], case["query"])
    assert got == want


def test_server_binds_its_device(monkeypatch):
    s = Server(device="cpu")
    assert s.device.type == "cpu" and dispatch.DISPATCHER.device.type == "cpu"
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Server(device="cuda")
    with pytest.raises(RuntimeError):
        Server()  # cuda is the default


def test_commit_is_visible_after_device_reads(monkeypatch):
    """A commit never leaves a stale operand behind: a read on the forced
    device path after a commit sees the new edge."""
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    s = Server(device="cpu")
    s.alter("friend: [uid] .\nname: string @index(exact) .")
    s.new_txn().mutate_rdf(
        set_rdf='<0x2> <friend> <0x3> .\n<0x3> <name> "a" .\n<0x4> <name> "a" .',
        commit_now=True,
    )
    q = '{ q(func: uid(0x2)) { friend @filter(eq(name, "a")) { uid } } }'
    assert json.loads(_data_bytes(s, q)) == {"q": [{"friend": [{"uid": "0x3"}]}]}
    s.new_txn().mutate_rdf(set_rdf="<0x2> <friend> <0x4> .", commit_now=True)
    assert json.loads(_data_bytes(s, q)) == {
        "q": [{"friend": [{"uid": "0x3"}, {"uid": "0x4"}]}]
    }


@pytest.fixture(scope="module")
def fanout():
    g = chip_smoke.make_graph(fanout=12, pool=3000, hot_every=10)
    ref, port = RefServer(), Server(device="cpu")
    chip_smoke.load_graph(ref, g)
    chip_smoke.load_graph(port, g)
    return g, ref, port


@pytest.mark.parametrize("name", sorted(chip_smoke.QUERIES))
@pytest.mark.parametrize("pair", [(False, False), (True, True)], ids=["host", "device-sweep"])
def test_fanout_queries_two_segments(fanout, name, pair, monkeypatch):
    g, ref, port = fanout
    force, pallas = pair
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", force)
    monkeypatch.setattr(dispatch, "_USE_PALLAS", pallas)
    q = chip_smoke.QUERIES[name]
    calls, setops = member_sweep.PLAIN_CALLS, setop_rows.PLAIN_CALLS
    got = _data_bytes(port, q)
    if force and name == "b":  # the level: one setop_rows call over all sub-rows, no K1
        assert (setop_rows.PLAIN_CALLS, member_sweep.PLAIN_CALLS) == (setops + 1, calls)
    assert got == _data_bytes(ref, q)
    want = chip_smoke.expected(g, "a" if name == "a" else "b")
    assert chip_smoke.extract(name, json.loads(got)) == want


def test_serve_phase_on_cpu():
    """chip_smoke's main-path phase, rehearsed at a tiny size on the CPU."""
    out = chip_smoke.serve("cpu", fanout=6, pool=400, reps=1, log=lambda m: None)
    assert out["setop_per_query"]["b"] == 1 and out["sweep_per_query"]["b"] == 0
    assert list(out["setop_calls"]["b"]) == ["intersect_ragged"]
    assert len(out["setop_calls"]["d"]["difference_ragged"]) == 1
    assert out["launches"] == 0  # no kernel runs without a card
    assert set(out["queries"]) == set(chip_smoke.QUERIES)


def test_k1_read_on_cpu():
    """chip_smoke's served read that reaches K1 ((c) over a small graph
    with a rare hot tag), at its full size on the CPU: equal to the host
    path and numpy, and K1's plain version ran."""
    out = chip_smoke.k1_read("cpu", log=lambda m: None)
    assert out["launches"] >= 1 and out["captured"] is not None
    assert all(pa <= member_sweep.LANE for _, pa, *_ in out["shapes"])
