"""The port's streaming encoder (query/streamjson.py) against the dict
encoder and the JAX package.

Every case executes once per package and compares four byte strings:
the port's streaming bytes on the native path and on the pure-Python
path (`native_ok=False`), the port's dict-path bytes, and the
reference's dict-path bytes over the same data. The cases are the
golden corpus's smoke subset and the reference encoder test's shape
queries, then the column path's own: lists whose children are the uid,
count(pred) and scalar values of every type, with holes, pruned rows,
an ordered root and nested lists, through a Server and as hand-built
trees. Last, the row counters on a friends-of-friends read.
"""

import importlib
import json
import os
import struct

import numpy as np
import pytest
from test_stream_encoder import SHAPE_QUERIES, SMOKE_CASES

from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.utils.observe import METRICS

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ref_golden")
PKGS = ("dgraph_tpu_torch", "dgraph_tpu")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _exec(server, pkg, q):
    """The executed tree of `q` and its value variables."""
    cache = _mod(pkg, "posting.lists").LocalCache(
        server.kv, server.zero.read_ts(), mem=server.mem
    )
    ex = _mod(pkg, "query.subgraph").Executor(
        cache, server.schema, vector_indexes=server.vector_indexes,
        stats=server.stats,
    )
    return ex.process(_mod(pkg, "dql").parse(q)), ex.val_vars


def _encodings(pkg, nodes, val_vars, schema):
    """{path: bytes, or the error it raised}: the dict path, and for the
    port the streaming native and pure-Python paths too."""
    enc = _mod(pkg, "query.streamjson").encode_data_bytes
    kw = dict(val_vars=val_vars, schema=schema)
    paths = {"dict": dict(stream=False)}
    if pkg == "dgraph_tpu_torch":
        paths.update(native=dict(stream=True, native_ok=True),
                     python=dict(stream=True, native_ok=False))
    out = {}
    for name, how in paths.items():
        try:
            out[name] = enc(nodes, **how, **kw).to_bytes()
        except Exception as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def _four_ways(servers, q):
    """The port's three encodings and the reference's dict bytes of `q`,
    or the error both packages raised."""
    got = {}
    for pkg, server in zip(PKGS, servers):
        try:
            nodes, vv = _exec(server, pkg, q)
        except Exception as exc:
            got[pkg] = {"error": f"{type(exc).__name__}: {exc}"}
            continue
        got[pkg] = _encodings(pkg, nodes, vv, server.schema)
    port, ref = got["dgraph_tpu_torch"], got["dgraph_tpu"]
    if "error" in ref:
        assert port == ref
        return ref["error"].encode()
    assert port["native"] == port["python"] == port["dict"] == ref["dict"]
    return ref["dict"]


def _loaded(make, schema, rdf=(), json_sets=()):
    s = make()
    s.alter(schema)
    for text in rdf:
        s.new_txn().mutate_rdf(set_rdf=text, commit_now=True)
    for obj in json_sets:
        s.new_txn().mutate_json(set_obj=obj, commit_now=True)
    return s


# ---------------------------------------------------------------------------
# The golden corpus's smoke subset and the reference encoder test's shapes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    def read(name):
        with open(os.path.join(HERE, name)) as f:
            return f.read()

    rdf = (read("triples.rdf"), read("triples_facets.rdf"))
    return tuple(
        _loaded(make, read("schema.txt"), rdf)
        for make in (lambda: Server(device="cpu"), RefServer)
    )


@pytest.mark.parametrize("case", SMOKE_CASES, ids=[c["id"] for c in SMOKE_CASES])
def test_golden_smoke_four_ways(golden, case):
    _four_ways(golden, case["query"])


SHAPE_SCHEMA = (
    "name: string @index(exact) .\nfriend: [uid] @count .\nboss: uid .\n"
    "dob: datetime .\nscore: float .\nblob: binary .\ntags: [string] .\n"
)
SHAPE_RDF = (
    '<0x1> <name> "Alice" .\n'
    '<0x1> <dob> "1910-01-01T07:30:00Z"^^<xs:dateTime> .\n'
    '<0x1> <score> "inf"^^<xs:float> .\n'
    '<0x2> <score> "-inf"^^<xs:float> .\n'
    '<0x1> <tags> "a" .\n<0x1> <tags> "b" .\n'
    '<0x2> <name> "Bob" .\n<0x3> <name> "Chan" .\n'
    "<0x1> <friend> <0x2> .\n<0x1> <friend> <0x3> .\n<0x2> <friend> <0x3> .\n"
    "<0x1> <boss> <0x2> (since=2006-01-02T15:04:05) .\n"
)


@pytest.fixture(scope="module")
def shapes():
    return tuple(
        _loaded(make, SHAPE_SCHEMA, (SHAPE_RDF,))
        for make in (lambda: Server(device="cpu"), RefServer)
    )


@pytest.mark.parametrize("q", SHAPE_QUERIES)
def test_shape_queries_four_ways(shapes, q):
    _four_ways(shapes, q)


# ---------------------------------------------------------------------------
# The column path through a Server: 48 persons (more than the native
# emitters' 32-row threshold), every scalar type, sparse fields
# ---------------------------------------------------------------------------

COLUMN_SCHEMA = (
    "name: string @index(exact) .\ni: int @index(int) .\nb: bool .\n"
    "s: string .\nf: float .\nd: datetime .\nblob: binary .\n"
    "tags: [string] .\nfriend: [uid] @count .\npw: password .\n"
)
N_PERSONS = 48
INTS = (0, -1, 1, 2**63 - 1, -(2**63), 10**18, -(10**18) - 7)
STRINGS = ('plain', 'quote " and back \\ slash', 'tab\tnew\nline', 'été 漢字 😀',
           "'single' quotes", '</script>')
FLOATS = ('0.1', '-2.5', '1e300', 'inf', '-inf', '3', '-0.0')


def _column_rdf():
    lines = []
    for k in range(1, N_PERSONS + 1):
        u = f"<{hex(k)}>"
        lines.append(f'{u} <name> "p{k}" .')
        if k % 5:  # every fifth person has no `i`
            v = INTS[k % len(INTS)] if k < 2 * len(INTS) else (k - 30) * 1001
            lines.append(f'{u} <i> "{v}"^^<xs:int> .')
        if k % 3 == 0:
            lines.append(f'{u} <b> "{"true" if k % 2 else "false"}"^^<xs:boolean> .')
        if k % 4 != 1:
            lines.append(f'{u} <s> {json.dumps(STRINGS[k % len(STRINGS)], ensure_ascii=False)} .')
        if k % 2:
            lines.append(f'{u} <f> "{FLOATS[k % len(FLOATS)]}"^^<xs:float> .')
        if k % 7 == 0:
            lines.append(f'{u} <d> "20{k % 30:02d}-0{1 + k % 9}-1{k % 10}T0{k % 10}:30:00Z"^^<xs:dateTime> .')
        if k % 6 == 0:
            lines.append(f'{u} <pw> "secret{k}"^^<xs:password> .')
        if k % 8 == 0:
            lines.append(f'{u} <tags> "t{k}" .')
            lines.append(f'{u} <tags> "u{k}" .')
        for j in (2 * k, 3 * k + 1, k + 5):
            if j <= N_PERSONS and j != k:
                lines.append(f"{u} <friend> <{hex(j)}> .")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def columns():
    blobs = [{"uid": hex(k), "blob": "aGVsbG8gd29ybGQ=" if k % 2 else "AAEC"}
             for k in range(10, 20)]
    return tuple(
        _loaded(make, COLUMN_SCHEMA, (_column_rdf(),), blobs)
        for make in (lambda: Server(device="cpu"), RefServer)
    )


COLUMN_QUERIES = {
    # a lone INT column with holes, and without (the native int objects)
    "int_holes": "{ q(func: has(name)) { i } }",
    "int_full": "{ q(func: has(i)) { i } }",
    "bool": "{ q(func: has(name)) { b } }",
    "string_escapes": "{ q(func: has(name)) { s } }",
    "float_inf": "{ q(func: has(name)) { f } }",
    "datetime": "{ q(func: has(d)) { d } }",
    "bytes": "{ q(func: has(blob)) { blob } }",
    # every type in one row, and uid beside values
    "uid_and_values": "{ q(func: has(name)) { uid name i b s f d blob } }",
    "count_and_values": "{ q(func: has(name)) { name c: count(friend) i } }",
    # rows whose every column is a hole are left out
    "sparse_rows_pruned": "{ q(func: has(name)) { b d } }",
    "no_row_prints": '{ q(func: eq(name, "p5")) { i } }',
    # a password takes no column; a lone password prints no row
    "password_beside": "{ q(func: has(name)) { pw i } }",
    "password_alone": "{ q(func: has(pw)) { pw } }",
    # the fof2 answer's `n` block: count(uid) alone, no row loop
    "count_uid_alone": "{ q(func: has(name)) { count(uid) } }",
    "count_uid_beside": "{ q(func: has(i)) { count(uid) i } }",
    # an ordered root: dest_uids in value order, not uid order
    "orderdesc": "{ q(func: has(i), orderdesc: i) { uid i c: count(friend) s } }",
    "orderasc_paged": "{ q(func: has(name), orderasc: name, first: 40) { name i } }",
    # nested lists print by columns; the parent, holding a uid
    # predicate, one entity at a time
    "nested_values": "{ q(func: has(name)) { name friend { i s } } }",
    "nested_count": "{ q(func: has(name)) { friend { c: count(friend) f } } }",
    "nested_count_uid": "{ q(func: has(name)) { friend { count(uid) i } } }",
    # shapes that keep the entity path: a list value, val(), math
    "list_value": "{ q(func: has(name)) { name tags } }",
    "val_var": "{ var(func: has(i)) { x as i } q(func: has(i)) { i val(x) } }",
    "scalar_aggregate": "{ var(func: has(i)) { x as i } "
                        "q(func: has(i)) { mx: max(val(x)) i } }",
    "nested_aggregate_alone": "{ var(func: has(name)) { x as i } "
                              "q(func: has(name)) { name friend { mx: max(val(x)) } } }",
    "math": "{ var(func: has(i)) { x as i } q(func: has(i)) { i m: math(x + 1) } }",
}


@pytest.mark.parametrize("name", sorted(COLUMN_QUERIES))
def test_column_queries_four_ways(columns, name):
    out = _four_ways(columns, COLUMN_QUERIES[name])
    assert not out.startswith(b"{") or json.loads(out) is not None


def test_column_values_print_as_json_says(columns):
    """The hand-formatted forms read back as the values stored."""
    data = json.loads(_four_ways(columns, COLUMN_QUERIES["uid_and_values"]))["q"]
    assert len(data) == N_PERSONS
    ints = {o["i"] for o in data if "i" in o}
    assert {2**63 - 1, -(2**63)} <= ints
    assert {o.get("b") for o in data} == {True, False, None}
    assert set(STRINGS) <= {o.get("s") for o in data}
    assert {1.7976931348623157e308, -1.7976931348623157e308} <= {o.get("f") for o in data}
    assert sum("i" not in o for o in data) == N_PERSONS // 5


# ---------------------------------------------------------------------------
# Hand-built trees: what a Server would not store
# ---------------------------------------------------------------------------


def _tree(pkg, case):
    """One `q` block over hand-built postings, and its schema."""
    sg = _mod(pkg, "query.subgraph")
    parser = _mod(pkg, "dql.parser")
    tt = _mod(pkg, "types.types")
    pl = _mod(pkg, "posting.pl")
    schema_mod = _mod(pkg, "schema.schema")
    T = tt.TypeID

    def post(tid, raw):
        return [pl.Posting(uid=1, value=raw, value_type=tid)]

    uids = [0x2A + 3 * j for j in range(40)]
    types = {"v": T.INT, "w": T.STRING}
    cols = {"v": {}, "w": {}}
    counts = {}
    if case == "int_extremes":
        vals = (0, -1, 2**63 - 1, -(2**63), 10**18, -(10**18), 255)
        cols["v"] = {u: post(T.INT, struct.pack("<q", vals[j % 7]))
                     for j, u in enumerate(uids) if j % 9}
    elif case == "mixed_types":
        # a value stored before its predicate became an int
        cols["v"] = {u: post(T.INT, struct.pack("<q", j)) for j, u in enumerate(uids)}
        cols["v"][uids[5]] = post(T.STRING, "5 as text".encode())
    elif case == "all_holes":
        pass
    elif case == "malformed_int":
        # 4 + 12 bytes: a multiple of 8 in all, read whole it would shift
        cols["v"] = {u: post(T.INT, struct.pack("<q", j)) for j, u in enumerate(uids)}
        cols["v"][uids[3]] = post(T.INT, b"\x01\x02\x03\x04")
        cols["v"][uids[4]] = post(T.INT, bytes(12))
    elif case == "per_parent_aggregate":
        cols["w"] = {u: post(T.STRING, f"w{j}".encode()) for j, u in enumerate(uids)}
    elif case == "unsorted_counts":
        uids = uids[::-1]
        counts = {u: j % 4 for j, u in enumerate(uids)}
        cols["w"] = {u: post(T.STRING, f"w{j}".encode()) for j, u in enumerate(uids) if j % 2}
    root = sg.ExecNode(gq=parser.GraphQuery(attr="q"),
                       dest_uids=np.array(uids, dtype=np.uint64))
    for attr in ("v", "w"):
        root.children.append(sg.ExecNode(gq=parser.GraphQuery(attr=attr), attr=attr,
                                         values=cols[attr], parent_node=root))
    if case == "per_parent_aggregate":
        # an aggregate with a value for each row, as under a uid
        # predicate: it needs the entity path
        root.children.insert(0, sg.ExecNode(
            gq=parser.GraphQuery(aggregator="max", val_var="x"), parent_node=root,
            math_vals={u: tt.Val(T.INT, j) for j, u in enumerate(uids) if j % 3}))
    if counts:
        root.children.append(sg.ExecNode(
            gq=parser.GraphQuery(attr="e", alias="n", is_count=True), attr="e",
            counts=counts, is_uid_pred=True, parent_node=root))
    su = {p: schema_mod.SchemaUpdate(predicate=p, value_type=t) for p, t in types.items()}
    su["e"] = schema_mod.SchemaUpdate(predicate="e", value_type=T.UID, is_list=True)
    schema = type("Schema", (), {"get": staticmethod(su.get)})()
    return [root], schema


@pytest.mark.parametrize("case", ["int_extremes", "mixed_types", "all_holes", "unsorted_counts",
                                  "malformed_int", "per_parent_aggregate"])
@pytest.mark.parametrize("lone", [True, False], ids=["lone", "beside"])
def test_hand_built_tree_four_ways(case, lone):
    got = {}
    for pkg in PKGS:
        nodes, schema = _tree(pkg, case)
        if lone:
            nodes[0].children = nodes[0].children[:1]
        got[pkg] = _encodings(pkg, nodes, {}, schema)
    port = got["dgraph_tpu_torch"]
    assert port["native"] == port["python"] == port["dict"] == got["dgraph_tpu"]["dict"]


# ---------------------------------------------------------------------------
# The row counters on a friends-of-friends read
# ---------------------------------------------------------------------------

FOF2 = ("{{ me as var(func: eq(id, [{sids}])) {{ f as knows }} "
        "var(func: uid(f)) {{ fof as knows @filter(NOT uid(me) AND NOT uid(f)) }} "
        "q(func: uid(fof)) {{ id }} "
        "n(func: uid(fof)) {{ count(uid) }} }}")


@pytest.fixture(scope="module")
def persons():
    rng = np.random.default_rng(7)
    n = 200
    lines = [f'<{hex(k)}> <id> "{1000 + k}"^^<xs:int> .' for k in range(1, n + 1)]
    for a, b in rng.integers(1, n + 1, size=(1500, 2)):
        if a != b:
            lines.append(f"<{hex(a)}> <knows> <{hex(b)}> .")
    return _loaded(lambda: Server(device="cpu"),
                   "id: int @index(int) .\nknows: [uid] @reverse .", ("\n".join(lines),))


def _counted(server, q):
    names = ("stream_encode_column_rows_total", "stream_encode_entity_rows_total")
    before = [METRICS.value(m) for m in names]
    data = json.loads(server.query(q, want="raw")["data"].raw)
    return data, [METRICS.value(m) - b for m, b in zip(names, before)]


def test_fof2_rows_all_go_by_columns(persons):
    data, (column, entity) = _counted(persons, FOF2.format(sids="1001, 1002, 1003"))
    rows = len(data["q"])
    assert rows > 32 and data["n"] == [{"count": rows}]
    assert column == rows and entity == 0


def test_nested_uid_predicate_goes_by_entities(persons):
    data, (column, entity) = _counted(persons, "{ q(func: uid(0x1, 0x2, 0x3)) { id knows { id } } }")
    assert entity == len(data["q"]) == 3
    assert column == sum(len(o.get("knows", [])) for o in data["q"]) > 0
