"""The port's write path against the JAX reference Server.

Every case runs the same operations, made from numpy seeds, through
`dgraph_tpu.api.server.Server` (jax on the CPU) and the port's
`Server(device="cpu")`, both with every set op forced onto the device
path and the member sweep on (the reference's Pallas kernel in interpret
mode, the port's plain version). Responses must be byte-equal and the
uid maps equal. The tolerance is exact everywhere: vectors hold small
integers and `similar_to` answers are compared as ids.

Cases: the reference's upsert blocks (tests/test_query_advanced.py) and
its blank nodes in JSON (tests/test_query_e2e.py); JSON deletes, language
tags and vectors given as lists; `upsert_json` with conditional mutations
that share blank nodes; group commit under 8 client threads (the bank and
the email upserts of chip_smoke phase 8) and a single-thread sequence
whose stored bytes are the same with group commit on and off; a commit
read back on the forced device path, and an upsert that reads its own
earlier commit; restarts of the WAL-backed and the SSTable store, a
`data_dir` the reference wrote, a SIGKILL after acknowledged commits, and
an encrypted SSTable store.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from dgraph_tpu.api import server as ref_server_mod
from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu.query import dispatch as ref_dispatch
from dgraph_tpu.x import config as ref_config
from dgraph_tpu.zero.zero import TxnConflictError as RefConflict
from dgraph_tpu_torch.api import server as port_server_mod
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.ops import setop_rows
from dgraph_tpu_torch.query import dispatch
from dgraph_tpu_torch.x import config
from dgraph_tpu_torch.zero.zero import TxnConflictError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(**kw):
    return Server(device="cpu", **kw)


MAKERS = {"ref": RefServer, "port": _port}
CONFLICT = {"ref": RefConflict, "port": TxnConflictError}


@pytest.fixture(autouse=True)
def forced(monkeypatch):
    """Every set op on the device path, the member sweep on, in both."""
    for mod in (ref_dispatch, dispatch):
        monkeypatch.setattr(mod, "_FORCE_DEVICE", True)
        monkeypatch.setattr(mod, "_USE_PALLAS", True)


def _data(server, q):
    """The response's `data` wire bytes."""
    return server.query(q, want="raw")["data"].raw


def _uids(m):
    """A returned uid map, comparable across processes: objects without a
    "uid" come back under "auto<id(obj)>", a memory address."""
    return sorted(("auto" if k.startswith("auto") else k, v) for k, v in m.items())


def _both(run, **kw):
    """run(server, side) on a fresh reference and a fresh port server;
    returns (reference's, port's)."""
    return tuple(run(MAKERS[side](**kw), side) for side in ("ref", "port"))


# -- upsert blocks (tests/test_query_advanced.py) ------------------------------

ADV_SCHEMA = """
name: string @index(exact) @upsert .
email: string @index(exact) @upsert .
age: int @index(int) .
bonus: float .
friend: [uid] @reverse .
"""
ADV_DATA = """
<0x1> <name> "Alice" .
<0x1> <age> "30"^^<xs:int> .
<0x1> <bonus> "2.5"^^<xs:float> .
<0x2> <name> "Bob" .
<0x2> <age> "25"^^<xs:int> .
<0x2> <bonus> "1.5"^^<xs:float> .
<0x3> <name> "Carol" .
<0x3> <age> "25"^^<xs:int> .
<0x1> <friend> <0x2> .
<0x1> <friend> <0x3> .
"""


def _advanced(s):
    s.alter(ADV_SCHEMA)
    s.new_txn().mutate_rdf(set_rdf=ADV_DATA, commit_now=True)
    return s


def up_insert_then_update(s):
    q = '{ v as var(func: eq(email, "x@y.z")) }'
    first = s.new_txn().upsert(
        query=q, set_rdf='_:new <email> "x@y.z" .\n_:new <name> "Xavier" .',
        cond="@if(eq(len(v), 0))",
    )
    second = s.new_txn().upsert(
        query=q, set_rdf='_:new <email> "x@y.z" .\n_:new <name> "DUPE" .',
        cond="@if(eq(len(v), 0))",
    )
    got = _data(s, '{ q(func: eq(email, "x@y.z")) { name } }')
    assert "new" in first and second == {}
    assert json.loads(got) == {"q": [{"name": "Xavier"}]}
    return [first, second, got]


def up_update_via_uid_var(s):
    s.new_txn().upsert(
        query='{ v as var(func: eq(name, "Bob")) }',
        set_rdf='uid(v) <age> "26"^^<xs:int> .',
    )
    got = _data(s, '{ q(func: eq(name, "Bob")) { age } }')
    assert json.loads(got) == {"q": [{"age": 26}]}
    return [got]


def up_val_var_copy(s):
    s.new_txn().upsert(
        query="{ v as var(func: has(age)) { a as age } }",
        set_rdf="uid(v) <bonus> val(a) .",
    )
    got = _data(s, "{ q(func: has(bonus)) { name bonus } }")
    assert {"name": "Carol", "bonus": 25.0} in json.loads(got)["q"]
    return [got]


def up_self_pair_edges(s):
    s.new_txn().upsert(
        query="{ v as var(func: eq(age, 25)) }",
        set_rdf="uid(v) <friend> uid(v) .",
    )
    got = _data(s, "{ q(func: uid(0x2, 0x3)) { uid friend { uid } ~friend { uid } } }")
    assert {o["uid"] for o in json.loads(got)["q"][0]["friend"]} == {"0x2", "0x3"}
    return [got]


def up_cond_engine_path(s):
    q = '{ u as var(func: eq(email, "a@x.io")) \n n as var(func: eq(name, "taken")) }'
    cond = "@if(eq(len(u), 0) AND eq(len(n), 0))"
    first = s.new_txn().upsert(
        q, set_rdf='_:new <email> "a@x.io" .\n_:new <name> "fresh" .', cond=cond
    )
    second = s.new_txn().upsert(
        q, set_rdf='_:new <email> "a@x.io" .\n_:new <name> "dupe" .', cond=cond
    )
    got = _data(s, '{ q(func: eq(email, "a@x.io")) { uid name } }')
    assert [o["name"] for o in json.loads(got)["q"]] == ["fresh"]
    return [first, second, got]


def up_delete_via_uid_var(s):
    s.new_txn().upsert(
        query='{ v as var(func: eq(name, "Alice")) { f as friend } }',
        del_rdf="uid(v) <friend> uid(f) .\nuid(f) <age> * .",
    )
    got = _data(s, "{ q(func: has(name)) { name age friend { uid } } }")
    assert "friend" not in json.loads(got)["q"][0]
    return [got]


UPSERTS = {
    f.__name__[3:]: f
    for f in (
        up_insert_then_update, up_update_via_uid_var, up_val_var_copy,
        up_self_pair_edges, up_cond_engine_path, up_delete_via_uid_var,
    )
}


@pytest.mark.parametrize("case", sorted(UPSERTS))
def test_upsert_blocks_equal_reference(case):
    ref, port = _both(lambda s, side: UPSERTS[case](_advanced(s)))
    assert port == ref


CONDS = [
    ("@if(eq(len(a), 2))", True),
    ("@if(eq(len(a), 2) AND eq(len(b), 0))", True),
    ("@if(eq(len(a), 2) AND gt(len(b), 0))", False),
    ("@if(eq(len(a), 9) OR eq(len(b), 0))", True),
    ("@if(NOT eq(len(a), 9))", True),
    ("@if((eq(len(a), 9) OR eq(len(b), 0)) AND ge(len(a), 1))", True),
    ("@if(lt(len(c), 1) and not le(len(a), 1))", True),
    ("@if(bogus)", ValueError),
    ("@if((eq(len(a), 2))", ValueError),
    ("eq(len(a), 2)", ValueError),
]


@pytest.mark.parametrize("cond,want", CONDS, ids=[c for c, _ in CONDS])
def test_upsert_conditions_equal_reference(cond, want):
    uv = {"a": [1, 2], "b": []}

    def verdict(fn):
        try:
            return fn(cond, uv)
        except ValueError:
            return ValueError

    got = verdict(port_server_mod._eval_cond)
    assert got == verdict(ref_server_mod._eval_cond) == want


# -- JSON mutations -------------------------------------------------------------

JSON_SCHEMA = (
    "name: string @index(exact) @lang .\nage: int @index(int) .\n"
    "friend: [uid] @reverse .\nnick: [string] .\n"
    'emb: float32vector @index(hnsw(metric:"euclidean")) .\n'
    "type Person {\n  name\n  age\n  friend\n}\n"
)
JSON_READ = (
    "{ q(func: has(name)) { uid name name@fr name@en age nick dgraph.type "
    "friend { uid name } ~friend { uid } } }"
)


def js_blank_nodes(s):
    # tests/test_query_e2e.py: nested blank nodes in one object
    uids = s.new_txn().mutate_json(
        set_obj={
            "uid": "_:alice", "name": "Alice",
            "friend": [{"uid": "_:bob", "name": "Bob"}, {"name": "Anon"}],
        },
        commit_now=True,
    )
    got = _data(s, '{ q(func: eq(name, "Alice")) { name friend { name } } }')
    assert {"alice", "bob"} <= set(uids)
    assert {"name": "Bob"} in json.loads(got)["q"][0]["friend"]
    return [_uids(uids), got, _data(s, JSON_READ)]


def _people(s):
    return s.new_txn().mutate_json(
        set_obj=[
            {"uid": "_:a", "dgraph.type": "Person", "name": "A", "age": 3,
             "nick": ["x", "y"], "friend": [{"uid": "_:b"}, {"uid": "_:c"}]},
            {"uid": "_:b", "dgraph.type": "Person", "name": "B", "age": 4},
            {"uid": "_:c", "name": "C", "age": 5, "friend": {"uid": "_:a"}},
        ],
        commit_now=True,
    )


def js_null_deletes_predicate(s):
    u = _people(s)
    s.new_txn().mutate_json(
        del_obj={"uid": u["a"], "age": None, "nick": None}, commit_now=True
    )
    got = _data(s, JSON_READ)
    assert "age" not in json.loads(got)["q"][0]
    return [u, got]


def js_bare_uid_deletes_node(s):
    u = _people(s)
    s.new_txn().mutate_json(del_obj=[{"uid": u["b"]}], commit_now=True)
    got = _data(s, JSON_READ)
    assert u["b"] not in {o["uid"] for o in json.loads(got)["q"]}
    return [u, got]


def js_edge_and_value_deletes(s):
    u = _people(s)
    s.new_txn().mutate_json(
        del_obj={"uid": u["a"], "friend": [{"uid": u["c"]}], "nick": "x"},
        commit_now=True,
    )
    return [u, _data(s, JSON_READ)]


def js_language_tags(s):
    u = s.new_txn().mutate_json(
        set_obj={"uid": "_:x", "name": "Hi", "name@fr": "Bonjour", "name@en": "Hello"},
        commit_now=True,
    )
    got = _data(s, JSON_READ)
    assert json.loads(got)["q"][0]["name@fr"] == "Bonjour"
    return [u, got, _data(s, '{ q(func: eq(name@fr, "Bonjour")) { uid name@en } }')]


def js_vectors_as_lists(s):
    rng = np.random.default_rng(5)
    V = rng.integers(-8, 9, size=(40, 6)).tolist()
    u = s.new_txn().mutate_json(
        set_obj=[{"uid": f"_:v{i}", "name": f"v{i}", "emb": v} for i, v in enumerate(V)],
        commit_now=True,
    )
    s.new_txn().mutate_json(del_obj={"uid": u["v3"], "emb": None}, commit_now=True)
    q = rng.integers(-8, 9, size=6).tolist()
    got = _data(s, f'{{ q(func: similar_to(emb, 5, "{q}")) {{ name }} }}')
    assert len(json.loads(got)["q"]) == 5
    return [u, got, _data(s, '{ q(func: eq(name, "v7")) { emb } }')]


JSON_CASES = {
    f.__name__[3:]: f
    for f in (
        js_blank_nodes, js_null_deletes_predicate, js_bare_uid_deletes_node,
        js_edge_and_value_deletes, js_language_tags, js_vectors_as_lists,
    )
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_json_mutations_equal_reference(case):
    def run(s, side):
        s.alter(JSON_SCHEMA)
        return JSON_CASES[case](s)

    ref, port = _both(run)
    assert port == ref


def test_upsert_json_shares_blank_nodes():
    """Several conditional JSON mutations of one upsert share its blank
    nodes; a second run of the same block takes the other branches."""
    query = '{ u as var(func: eq(email, "a@x")) v as var(func: eq(email, "b@x")) }'
    mutations = [
        {"cond": "@if(eq(len(v), 0))",
         "set": {"uid": "_:new", "email": "b@x", "name": "B"}},
        {"cond": "@if(gt(len(u), 0) AND eq(len(v), 0))",
         "set": {"uid": "uid(u)", "friend": {"uid": "_:new"}}},
        {"cond": "@if(eq(len(u), 0))", "set": {"uid": "_:never", "name": "no"}},
        {"cond": "@if(gt(len(v), 0))",
         "set": {"uid": "uid(v)", "name": "B again", "friend": [{"uid": "uid(u)"}]},
         "delete": {"uid": "uid(u)", "name": None}},
        {"set": {"uid": "_:new", "nick": "shared"}},
    ]

    def run(s, side):
        s.alter("email: string @index(exact) @upsert .\nname: string @index(exact) .\n"
                "nick: string .\nfriend: [uid] @reverse .")
        s.new_txn().mutate_json(set_obj={"uid": "_:e", "email": "a@x", "name": "A"},
                                commit_now=True)
        read = "{ q(func: has(email)) { uid email name nick friend { uid } ~friend { uid } } }"
        first = s.new_txn().upsert_json(query, mutations)
        after1 = _data(s, read)
        second = s.new_txn().upsert_json(query, mutations)
        return [first, after1, second, _data(s, read)]

    ref, port = _both(run)
    assert port == ref
    assert set(port[0]) == {"new"}
    assert json.loads(port[1])["q"][1]["nick"] == "shared"


# -- group commit ---------------------------------------------------------------


def test_group_commit_bank_holds_under_eight_threads():
    """chip_smoke's (u3) bank in JSON, 8 client threads on each server:
    the total holds at every snapshot read and the final balances are
    exactly the committed transfers (no update lost)."""
    def run(s, side):
        s.alter("acct: string @index(exact) @upsert .\nbal: int @upsert .")
        out = chip_smoke.bank(s, n=24, threads=8, per_thread=12, conflict=CONFLICT[side])
        assert out["transfers"] + out["declined"] == 96 and out["snapshots"] > 0
        return s

    ref, port = _both(run)
    assert port._group_commit is not None and ref._group_commit is not None


def test_bank_fails_when_its_snapshot_reader_fails(monkeypatch):
    """A snapshot read that raises in the bank's reader thread fails the
    bank, though the clients and the final balances are fine."""
    real = chip_smoke._run_query

    def run_query(server, q):
        if "has(bal)" not in q and "bal" in q:
            raise RuntimeError("snapshot read failed")
        return real(server, q)

    monkeypatch.setattr(chip_smoke, "_run_query", run_query)
    s = _port()
    s.alter("acct: string @index(exact) @upsert .\nbal: int @upsert .")
    with pytest.raises(RuntimeError, match="snapshot read failed"):
        chip_smoke.bank(s, n=8, threads=2, per_thread=3, conflict=TxnConflictError)


def test_group_commit_email_upserts_under_eight_threads():
    """chip_smoke's (u1): 8 threads upsert emails drawn with repeats; each
    email ends with exactly one uid, on both servers, and the pre-set
    ones keep their node."""
    pool = np.arange(0x100, 0x100 + 64, dtype=np.uint64)

    def run(s, side):
        s.alter("email: string @index(exact) @upsert .")
        chip_smoke.lease_through(s.zero, 0x1000)
        out, owner = chip_smoke.upsert_emails(
            s, pool, n_emails=40, n_pre=16, threads=8, per_thread=10,
            conflict=CONFLICT[side],
        )
        assert out["upserts"] == 80
        return sorted(e for e in owner)

    ref, port = _both(run)
    assert port == ref


def _serial_or_group_sequence(server_cls):
    s = server_cls()
    s.alter("name: string @index(exact) .\nbal: int @upsert .\nknows: [uid] @reverse .\n")
    for i in range(12):
        s.new_txn().mutate_json(
            set_obj={"uid": f"_:n{i}", "name": f"user{i}", "knows": [{"uid": "0x1"}]},
            commit_now=True,
        )
    s.new_txn().upsert(
        '{ v as var(func: eq(name, "user3")) }', set_rdf="uid(v) <bal> \"7\"^^<xs:int> ."
    )
    t = s.new_txn()
    t.mutate_json(set_obj={"uid": "0x100", "bal": 1})
    t2 = s.new_txn()
    t2.mutate_json(set_obj={"uid": "0x100", "bal": 2})
    t.commit()
    with pytest.raises((TxnConflictError, RefConflict)):
        t2.commit()
    return s.kv.dump_bytes()


def test_group_commit_on_and_off_store_the_same_bytes(monkeypatch):
    """One single-thread sequence (tests/test_group_commit.py's, plus an
    upsert): the stored bytes are the same with DGRAPH_TPU_GROUP_COMMIT on
    and off, in the port and in the reference."""
    got = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("DGRAPH_TPU_GROUP_COMMIT", mode)
        assert bool(config.get("GROUP_COMMIT")) == bool(ref_config.get("GROUP_COMMIT"))
        got["ref", mode] = _serial_or_group_sequence(RefServer)
        got["port", mode] = _serial_or_group_sequence(_port)
    assert len(set(got.values())) == 1


def test_group_commit_leaves_no_stale_device_operand():
    """A commit through group commit, then a read on the forced device
    path, sees the new edge; an upsert whose query block reads its own
    earlier commit through a filtered fan-out (setop_rows' plain version) marks
    every node that commit added."""
    q = '{ q(func: uid(0x2)) { friend @filter(eq(name, "a")) { uid seen } } }'

    def run(s, side):
        s.alter("friend: [uid] .\nname: string @index(exact) .\nseen: string .")
        s.new_txn().mutate_json(
            set_obj=[{"uid": "0x2", "friend": [{"uid": "0x3"}]},
                     {"uid": "0x3", "name": "a"}, {"uid": "0x4", "name": "a"},
                     {"uid": "0x100000005", "name": "a"}],
            commit_now=True,
        )
        first = _data(s, q)
        s.new_txn().mutate_json(
            set_obj={"uid": "0x2", "friend": [{"uid": "0x4"}, {"uid": "0x100000005"}]},
            commit_now=True,
        )
        second = _data(s, q)
        calls = setop_rows.PLAIN_CALLS
        s.new_txn().upsert(
            '{ var(func: uid(0x2)) { f as friend @filter(eq(name, "a")) } }',
            set_rdf='uid(f) <seen> "yes" .',
        )
        if side == "port":
            assert setop_rows.PLAIN_CALLS > calls
            assert s._group_commit is not None
        return [first, second, _data(s, q)]

    ref, port = _both(run)
    assert port == ref
    assert json.loads(port[2]) == {"q": [{"friend": [
        {"uid": "0x3", "seen": "yes"}, {"uid": "0x4", "seen": "yes"},
        {"uid": "0x100000005", "seen": "yes"}]}]}


def test_device_reads_beside_committing_threads():
    """Filtered fan-outs on the forced device path from 4 threads while 4
    others commit: every read answers as on a quiet server, and setop_rows
    counts every call."""
    g = chip_smoke.make_graph(fanout=6, pool=300, hot_every=7)
    s = _port()
    chip_smoke.load_graph(s, g)
    s.alter("email: string @index(exact) @upsert .")
    want = _data(s, chip_smoke.QUERIES["b"])
    calls = setop_rows.PLAIN_CALLS
    _data(s, chip_smoke.QUERIES["b"])
    per_read = setop_rows.PLAIN_CALLS - calls
    assert per_read >= 1
    seen = []

    def reader():
        for _ in range(6):
            seen.append(_data(s, chip_smoke.QUERIES["b"]))

    def writer(i):
        for j in range(10):
            s.new_txn().mutate_json(
                set_obj={"uid": f"_:w{j}", "email": f"w{i}-{j}"}, commit_now=True
            )

    calls = setop_rows.PLAIN_CALLS
    chip_smoke._threads(lambda f, a: f(*a), [(reader, ())] * 4 + [(writer, (i,)) for i in range(4)])
    assert seen == [want] * 24
    assert setop_rows.PLAIN_CALLS - calls == 24 * per_read


# -- on-disk stores and restarts ------------------------------------------------

RESTART_SCHEMA = (
    "name: string @index(exact, term) @lang .\nage: int @index(int) .\n"
    "email: string @index(exact) @upsert .\nfriend: [uid] @reverse @count .\n"
    'emb: float32vector @index(hnsw(metric:"euclidean")) .\n'
    "type Person {\n  name\n  age\n  friend\n}\n"
)
RESTART_READS = [
    "schema {}",
    "schema(type: Person) {}",
    "{ q(func: has(name)) { uid name name@fr age email dgraph.type "
    "friend { uid name } ~friend { uid } c: count(friend) } }",
    '{ q(func: anyofterms(name, "alpha beta")) @filter(ge(age, 2)) { uid name } }',
    '{ q(func: similar_to(emb, 4, "[1, 0, 2, 1]")) { uid name } }',
    '{ q(func: eq(email, "e3@x")) { uid name } }',
]


def _write_some(s):
    """A seeded run of JSON mutations, an upsert and RDF; returns the
    uid maps."""
    rng = np.random.default_rng(9)
    s.alter(RESTART_SCHEMA)
    people = [
        {"uid": f"_:p{i}", "dgraph.type": "Person",
         "name": ["alpha", "beta", "gamma"][i % 3] + f" {i}", "age": int(rng.integers(0, 9)),
         "email": f"e{i}@x", "emb": rng.integers(-4, 5, size=4).tolist(),
         "friend": [{"uid": f"_:p{j}"} for j in rng.choice(12, 3, replace=False)]}
        for i in range(12)
    ]
    out = [s.new_txn().mutate_json(set_obj=people, commit_now=True)]
    out.append(s.new_txn().upsert(
        '{ v as var(func: eq(email, "new@x")) }',
        set_rdf='_:n <email> "new@x" .\n_:n <name> "delta"@fr .\n_:n <name> "delta" .',
        cond="@if(eq(len(v), 0))",
    ))
    s.new_txn().mutate_rdf(
        set_rdf=f'<{out[0]["p1"]}> <age> "8"^^<xs:int> .', commit_now=True
    )
    return out


def _reads(s):
    out = []
    for q in RESTART_READS:
        data = s.query(q, want="raw")["data"]
        out.append(data.raw if hasattr(data, "raw") else json.dumps(data, sort_keys=True))
    return out


def _close(s):
    s.kv.sync()
    s.kv.close()


@pytest.fixture(params=["mem", "lsm"])
def backend(request, monkeypatch, tmp_path):
    monkeypatch.setenv("DGRAPH_TPU_STORAGE", request.param)
    return request.param


def test_restart_recovers_everything_as_the_reference(backend, tmp_path):
    """Write, close, reopen: schema, types, leases and the vector index
    come back, and every answer after the restart equals the
    reference's after its own restart."""
    def run(s, side):
        maps = _write_some(s)
        before = _reads(s)
        _close(s)
        s2 = MAKERS[side](data_dir=str(tmp_path / side))
        after = _reads(s2)
        assert after == before
        assert len(s2.vector_indexes["emb"]) == 12
        fresh = s2.new_txn().mutate_json(set_obj={"uid": "_:z", "name": "z"}, commit_now=True)
        _close(s2)
        return [maps, after, fresh]

    ref = run(RefServer(data_dir=str(tmp_path / "ref")), "ref")
    port = run(_port(data_dir=str(tmp_path / "port")), "port")
    assert port == ref
    assert int(port[2]["z"], 16) > max(int(u, 16) for m in port[0] for u in m.values())
    if backend == "lsm":
        assert os.path.isdir(tmp_path / "port" / "lsm")
    else:
        assert os.path.getsize(tmp_path / "port" / "wal.log") > 0


def test_port_opens_a_data_dir_the_reference_wrote(backend, tmp_path):
    """The store modules are copies, so the port serves a reference
    `data_dir` as the reference serves it after a restart."""
    d = str(tmp_path / "store")
    ref = RefServer(data_dir=d)
    _write_some(ref)
    want = _reads(ref)
    _close(ref)
    port = _port(data_dir=d)
    assert _reads(port) == want
    _close(port)
    again = RefServer(data_dir=d)
    assert _reads(again) == want
    _close(again)


_KILLED = r"""
import sys, threading
from dgraph_tpu_torch.api.server import Server

s = Server(device="cpu", data_dir=sys.argv[1])
s.alter("name: string @index(exact) .\nn: int .")
lock = threading.Lock()

def client(t):
    for i in range(100000):
        u = s.new_txn().mutate_json(
            set_obj={"uid": "_:x", "name": f"t{t}-{i}", "n": i}, commit_now=True)
        with lock:
            print(f"t{t}-{i} {u['x']}", flush=True)

for t in range(4):
    threading.Thread(target=client, args=(t,), daemon=True).start()
threading.Event().wait()
"""


def test_acknowledged_writes_survive_sigkill(backend, tmp_path):
    """A process commits from 4 threads (group commit) and is SIGKILLed
    after 60 acknowledgements: every acknowledged write is read back.
    The kill takes its whole process group, so the apply-shard workers
    it forked go with it."""
    d = str(tmp_path / "store")
    p = subprocess.Popen(
        [sys.executable, "-c", _KILLED, d], cwd=ROOT, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ), start_new_session=True,
    )
    acked = {}
    try:
        for line in p.stdout:
            name, uid = line.split()
            acked[name] = uid
            if len(acked) >= 60:
                break
    finally:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
        p.stdout.close()
    assert len(acked) >= 60
    s = _port(data_dir=d)
    got = {o["name"]: o["uid"] for o in json.loads(
        _data(s, "{ q(func: has(name)) { uid name } }"))["q"]}
    assert {k: got.get(k) for k in acked} == acked
    _close(s)


def test_encrypted_lsm_store_keeps_nothing_in_plaintext(monkeypatch, tmp_path):
    pytest.importorskip("cryptography")
    monkeypatch.setenv("DGRAPH_TPU_STORAGE", "lsm")
    key = bytes(range(32))
    d = str(tmp_path / "sealed")
    s = _port(data_dir=d, encryption_key=key)
    s.alter("secretpred: string @index(exact) .")
    s.new_txn().mutate_json(
        set_obj=[{"uid": f"_:s{i}", "secretpred": f"supersecret-{i}"} for i in range(20)],
        commit_now=True,
    )
    s.kv.flush()  # SSTables as well as the WAL
    q = '{ q(func: eq(secretpred, "supersecret-7")) { uid secretpred } }'
    want = _data(s, q)
    _close(s)
    for dirpath, _, files in os.walk(d):
        for f in files:
            blob = open(os.path.join(dirpath, f), "rb").read()
            assert b"supersecret" not in blob and b"secretpred" not in blob, f
    again = _port(data_dir=d, encryption_key=key)
    assert _data(again, q) == want
    _close(again)
    ref = RefServer(data_dir=d, encryption_key=key)
    assert _data(ref, q) == want
    _close(ref)


def test_a_data_dir_server_needs_its_card(monkeypatch, tmp_path):
    """Server(device="cuda", data_dir=...) raises without a card, before
    it opens (or creates) the store."""
    monkeypatch.setattr(dispatch.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Server(device="cuda", data_dir=str(tmp_path / "store"))
    assert not os.path.exists(tmp_path / "store")


# -- chip_smoke phase 8, rehearsed on the CPU -------------------------------------


def test_write_phase_on_cpu(backend, tmp_path):
    """chip_smoke's phase 8 at a tiny size on the CPU: the JSON load,
    (u1)-(u3) and the restart, with every check it makes on the card."""
    V, Q = chip_smoke.make_corpus(n=300, d=8, nq=16)
    out = chip_smoke.serve_writes(
        "cpu", str(tmp_path / "store"), V, Q, fanout=6, pool=400, vec_chunk=100,
        edge_chunk=60, n_emails=30, n_pre=10, upsert_threads=4, upserts_per_thread=15,
        n_accounts=16, bank_threads=4, transfers_per_thread=8, log=lambda m: None,
    )
    assert out["u2"]["setops"] >= 1 and out["u2"]["marked"] >= 1
    assert out["after_restart_launches"]["setop_rows"] >= 1
    # the KV1 calls credited after the restart are the ones captured for
    # the comparison with the plain version
    assert out["after_restart_launches"]["vector_topk"] >= 16
    assert [site[1:] for site in out["restart_topk_sites"]] == [(10, "euclidean", False)]
    assert out["batches"] + out["bypassed"] >= 16 * 30 // 16
    assert out["disk_bytes"] > 0
