"""The port's ACL, namespaces and audit log against the JAX reference's.

The cases of tests/test_acl.py (all but the HTTP admin routes, whose
server is not ported yet), each run once on the reference
(`dgraph_tpu.api.server.Server`, jax on the CPU) and once on the port
(`Server(device="cpu")`, set ops forced onto the device path). Each side
must meet the reference test's contract, and what a case returns (the
answers, the denials, the audit trail's endpoints) must be equal on both.
"""

import os
import time
from types import SimpleNamespace

import pytest

from dgraph_tpu.acl import acl as ref_acl
from dgraph_tpu.acl import jwt as ref_jwt
from dgraph_tpu.admin.namespace import NamespaceManager as RefNamespaces
from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu.enc import enc as ref_enc
from dgraph_tpu.posting.lists import LocalCache as RefLocalCache
from dgraph_tpu.schema.schema import TypeUpdate as RefTypeUpdate
from dgraph_tpu.x import keys as ref_keys
from dgraph_tpu_torch.acl import acl, jwt
from dgraph_tpu_torch.admin.namespace import NamespaceManager
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.enc import enc
from dgraph_tpu_torch.posting.lists import LocalCache
from dgraph_tpu_torch.query import dispatch
from dgraph_tpu_torch.schema.schema import TypeUpdate
from dgraph_tpu_torch.x import keys

SCHEMA = "name: string @index(exact) .\nsalary: float @index(float) ."
SIDES = ["ref", "port"]
M = {
    "ref": SimpleNamespace(
        Server=RefServer, acl=ref_acl, jwt=ref_jwt, Namespaces=RefNamespaces,
        enc=ref_enc, LocalCache=RefLocalCache, TypeUpdate=RefTypeUpdate, keys=ref_keys,
    ),
    "port": SimpleNamespace(
        Server=lambda **kw: Server(device="cpu", **kw), acl=acl, jwt=jwt,
        Namespaces=NamespaceManager, enc=enc, LocalCache=LocalCache,
        TypeUpdate=TypeUpdate, keys=keys,
    ),
}


@pytest.fixture(autouse=True)
def forced(monkeypatch):
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    monkeypatch.setattr(dispatch, "_USE_PALLAS", True)


def _server(m):
    s = m.Server()
    s.alter(SCHEMA)
    s.enable_acl(secret=b"test-secret-0123456789abcdef0000")
    return s


def _denied(fn):
    """What a call that ACL must refuse gives: the error's type name."""
    try:
        fn()
    except Exception as exc:
        return type(exc).__name__
    return "allowed"


def jwt_roundtrip_and_tamper(m):
    secret = b"s" * 32
    tok = m.jwt.encode({"userid": "u", "exp": time.time() + 100}, secret)
    assert m.jwt.decode(tok, secret)["userid"] == "u"
    for bad in ((tok + "x", secret), (tok, b"wrong" * 8),
                (m.jwt.encode({"exp": time.time() - 1}, secret), secret)):
        with pytest.raises(m.jwt.JwtError):
            m.jwt.decode(*bad)
    return m.jwt.decode(m.jwt.encode({"userid": "u", "exp": 4e9}, secret), secret)


def groot_login_and_guardian_bypass(m):
    s = _server(m)
    toks = s.login("groot", "password")
    assert "accessJwt" in toks
    with pytest.raises(m.acl.AclError):
        s.login("groot", "wrongpass")
    res = s.query("{ q(func: has(name)) { name } }", access_jwt=toks["accessJwt"])
    assert res["data"]["q"] == []
    return res["data"]


def non_user_denied_and_rules(m):
    s = _server(m)
    s.acl.add_user("alice", "alicepw")
    s.acl.add_group("engineering")
    s.acl.add_user_to_group("alice", "engineering")
    a = s.login("alice", "alicepw")["accessJwt"]
    q = "{ q(func: has(name)) { name } }"
    out = [_denied(lambda: s.query(q, access_jwt=a))]
    s.acl.set_rule("engineering", "name", m.acl.READ)
    out.append(s.query(q, access_jwt=a)["data"])
    out.append(_denied(lambda: s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "X" .', access_jwt=a)))
    s.acl.set_rule("engineering", "name", m.acl.WRITE)
    s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "X" .', access_jwt=a, commit_now=True)
    out.append(_denied(lambda: s.query("{ q(func: has(salary)) { salary } }", access_jwt=a)))
    assert out[0] == out[2] == out[3] == "AclError" and out[1] == {"q": []}
    return out


def missing_token_when_acl_on(m):
    s = _server(m)
    with pytest.raises(m.acl.AclError):
        s.query("{ q(func: has(name)) { name } }")
    return "denied"


def refresh_token(m):
    s = _server(m)
    toks2 = s.acl.refresh(s.login("groot", "password")["refreshJwt"])
    assert toks2["accessJwt"]
    claims = s.acl.claims(toks2["accessJwt"])
    assert claims["userid"] == "groot"
    return claims["userid"]


def namespaces_isolated(m):
    """A mutation under a namespace's token lands in that namespace: the
    galaxy's groot does not see it, the namespace's groot does."""
    s = _server(m)
    ns1 = m.Namespaces(s).create_namespace()
    assert ns1 >= 1
    s.acl.add_user("bob", "pw0")
    s.acl.add_user("bob", "pw1", ns=ns1)
    t0, t1 = s.login("bob", "pw0"), s.login("bob", "pw1", ns=ns1)
    assert s.acl.claims(t0["accessJwt"])["namespace"] == 0
    assert s.acl.claims(t1["accessJwt"])["namespace"] == ns1
    with pytest.raises(m.acl.AclError):
        s.login("bob", "pw0", ns=ns1)
    g1 = s.login("groot", "password", ns=ns1)["accessJwt"]
    s.new_txn().mutate_rdf(set_rdf='<0x900> <name> "ns1-only" .', access_jwt=g1, commit_now=True)
    s.new_txn().mutate_json(set_obj={"uid": "0x901", "name": "ns1-json"}, access_jwt=g1,
                            commit_now=True)
    g0 = s.login("groot", "password")["accessJwt"]
    q = '{ q(func: eq(name, ["ns1-only", "ns1-json"])) { uid name } }'
    galaxy, mine = s.query(q, access_jwt=g0)["data"], s.query(q, access_jwt=g1)["data"]
    assert galaxy == {"q": []}
    assert mine == {"q": [{"uid": "0x900", "name": "ns1-only"},
                          {"uid": "0x901", "name": "ns1-json"}]}
    stored = m.LocalCache(s.kv, s.zero.read_ts()).value(
        m.keys.DataKey("name", 0x901, ns1))
    assert stored is not None and stored.value == "ns1-json"
    return [ns1, galaxy, mine]


def audit_log(m, tmp_path):
    s = m.Server()
    s.alter(SCHEMA)
    s.enable_audit(str(tmp_path), key=b"0123456789abcdef")
    s.enable_acl(secret=b"x" * 32)
    toks = s.login("groot", "password")
    s.query("{ q(func: has(name)) { name } }", access_jwt=toks["accessJwt"])
    _denied(lambda: s.login("groot", "nope"))
    entries = s.audit.read_all()
    endpoints = [(e["endpoint"], e["status"]) for e in entries]
    assert ("login", "OK") in endpoints and ("query", "OK") in endpoints
    assert ("login", "DENIED") in endpoints
    raw = open(os.path.join(str(tmp_path), os.listdir(str(tmp_path))[0]), "rb").read()
    assert b'"endpoint"' not in raw  # encrypted at rest
    return endpoints


def encryption_roundtrip(m, tmp_path):
    key_path = str(tmp_path / "key")
    with open(key_path, "wb") as f:
        f.write(b"0123456789abcdef")
    key = m.enc.read_key_file(key_path)
    data = b"secret posting list" * 100
    sealed = m.enc.encrypt_stream(data, key)
    assert sealed[16:] != data and m.enc.decrypt_stream(sealed, key) == data
    assert m.enc.encrypt_stream(data, key) != sealed  # unique IVs
    return len(sealed)


def json_mutation_requires_token_and_ns(m):
    s = _server(m)
    with pytest.raises(m.acl.AclError):
        s.new_txn().mutate_json(set_obj={"uid": "0x1", "name": "evil"})
    tok = s.login("groot", "password")["accessJwt"]
    s.new_txn().mutate_json(set_obj={"uid": "0x1", "name": "ok"}, access_jwt=tok, commit_now=True)
    return s.query('{ q(func: eq(name, "ok")) { uid name } }', access_jwt=tok)["data"]


def expand_all_respects_acl(m):
    s = _server(m)
    g = s.login("groot", "password")["accessJwt"]
    s.new_txn().mutate_rdf(
        set_rdf='<0x2> <name> "secret" .\n<0x2> <dgraph.type> "Person" .',
        access_jwt=g, commit_now=True,
    )
    s.schema.set_type(m.TypeUpdate(name="Person", fields=["name", "salary"]))
    s.acl.add_user("eve", "evepw")
    s.acl.add_group("nothing")
    s.acl.add_user_to_group("eve", "nothing")
    s.acl.set_rule("nothing", "salary", m.acl.READ)  # salary, not name
    a = s.login("eve", "evepw")["accessJwt"]
    res = s.query("{ q(func: uid(0x2)) { expand(_all_) } }", access_jwt=a)["data"]
    assert "name" not in res["q"][0] if res["q"] else True
    grouped = _denied(lambda: s.query(
        "{ q(func: uid(0x2)) @groupby(name) { count(uid) } }", access_jwt=a))
    assert grouped == "AclError"
    return [res, grouped]


def dgraph_internal_preds_guarded(m):
    s = _server(m)
    s.acl.add_user("mal", "malpw")
    a = s.login("mal", "malpw")["accessJwt"]
    with pytest.raises(m.acl.AclError):
        s.query("{ q(func: has(dgraph.password)) { dgraph.password } }", access_jwt=a)
    s.acl.add_group("g1")
    s.acl.add_user_to_group("mal", "g1")
    s.acl.set_rule("g1", "name", m.acl.READ)
    a = s.login("mal", "malpw")["accessJwt"]  # re-login: groups in claims
    res = s.query("{ q(func: type(Person)) { name } }", access_jwt=a)["data"]
    assert res["q"] == []
    return res


def txn_query_and_upsert_require_token(m):
    s = _server(m)
    with pytest.raises(m.acl.AclError):
        s.new_txn().query("{ q(func: has(name)) { name } }")
    with pytest.raises(m.acl.AclError):
        s.new_txn().upsert(query="{ v as var(func: has(name)) }", set_rdf='uid(v) <name> "x" .')
    g = s.login("groot", "password")["accessJwt"]
    got = s.new_txn().query("{ q(func: has(name)) { name } }", access_jwt=g)
    assert got
    return got["data"]


def random_salt(m):
    s = _server(m)
    s.acl.add_user("s1", "same")
    s.acl.add_user("s2", "same")
    cache = m.LocalCache(s.kv, s.zero.read_ts())
    hashes = [
        cache.value(m.keys.DataKey("dgraph.password", s.acl._uid_of_xid(xid, 0))).value
        for xid in ("s1", "s2")
    ]
    assert hashes[0] != hashes[1]  # same password, different salt
    return len(hashes)


CASES = {f.__name__: f for f in (
    jwt_roundtrip_and_tamper, groot_login_and_guardian_bypass,
    non_user_denied_and_rules, missing_token_when_acl_on, refresh_token,
    namespaces_isolated, json_mutation_requires_token_and_ns,
    expand_all_respects_acl, dgraph_internal_preds_guarded,
    txn_query_and_upsert_require_token, random_salt,
)}
ON_DISK = {f.__name__: f for f in (audit_log, encryption_roundtrip)}
_REF = {}


def _reference(name, *args):
    if name not in _REF:
        _REF[name] = {**CASES, **ON_DISK}[name](M["ref"], *args)
    return _REF[name]


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_acl_equals_reference(name, side):
    assert CASES[name](M[side]) == _reference(name)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("name", sorted(ON_DISK))
def test_audit_and_encryption_equal_reference(name, side, tmp_path):
    pytest.importorskip("cryptography")  # sealed files need it, as in the reference
    mine = tmp_path / side
    mine.mkdir()
    theirs = tmp_path / "ref-run"
    theirs.mkdir()
    assert ON_DISK[name](M[side], mine) == _reference(name, theirs)
