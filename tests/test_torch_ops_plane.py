"""The port's ops plane against the JAX reference's, on the CPU.

Every case runs once on the reference (`dgraph_tpu`, jax on the CPU) and
once on the port (`Server(device="cpu")`, with every set op forced onto
the device path and the member sweep on, so the plain versions of its
kernels run), on the same inputs. Each side must meet the reference
test's own contract, and the port's result (query answers, manifest
entries with their sha256s, CDC events, task records) must equal the
reference's byte for byte. The reference runs on its default dispatch
path.

Cases, by the reference test they come from:

- tests/test_query_advanced.py: `test_subscriptions`,
  `test_subscription_acl_safe`;
- tests/test_ops_subsystems.py: `test_cdc_events`,
  `test_rollup_compacts_chains`, `test_task_queue_serializes_ops`;
- tests/test_ops_plane.py, its single-Server cases: manifest-chain
  validation, gapped, torn and legacy backups, uncommitted chunks, the
  chunked round trip with `until`, CDC ordering and ids under group
  commit, the RFC3339 golden, sink retry and backpressure, apply
  equivalence with deletes, replay across the checkpoint gap;
- tests/test_flags_handlers.py: all six cases;
- tests/test_loaders_admin.py: every case but
  `test_online_restore_into_cluster`;
- tests/test_multipart.py: the split and rollup cases;
- tests/test_golden_movies.py: every golden query, over a graph loaded
  by each package's `bulk_load_rdf`.

Left out, with the ROADMAP Queue 1 item each waits for: the
DistributedCluster and ProcCluster cases of test_ops_plane.py (backup
crash at every boundary, in-flight moves, resume and abort, online
restore, the cluster CDC failover) and `test_online_restore_into_cluster`
(item 4, the cluster); the MCP, CLI and HTTP cases of
test_ops_subsystems.py (item 7); GraphQL subscriptions (item 5);
test_multipart.py's mesh cases (item 6).

Then the cases this slice needs: backups and exports carried across the
packages both ways; a restore into a server that already served the
same predicates; `ParallelBulkLoader` forking workers beside a live
Server; the order of subscriptions and vector ingestion; phase 10 of
`chip_smoke.py` rehearsed at a tiny size. The card's cases are in
tests/test_torch_ops_plane_cuda.py.
"""

import gzip
import importlib
import json
import os
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
import test_golden_movies as golden_movies
from dgraph_tpu.api.server import Server as RefServer
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.ops import setop_rows
from dgraph_tpu_torch.query import dispatch

SIDES = ["ref", "port"]
MODULES = {
    "bk": "admin.backup", "cdc": "admin.cdc", "export": "admin.export",
    "handlers": "admin.handlers", "tasks": "admin.tasks",
    "subs": "api.subscriptions", "faults": "conn.faults", "retry": "conn.retry",
    "bulk": "loaders.bulk", "bulk2": "loaders.bulk2", "live": "loaders.live",
    "rdf": "loaders.rdf", "pl": "posting.pl", "rollup": "posting.rollup",
    "kv": "storage.kv", "types": "types.types", "observe": "utils.observe",
    "flags": "x.flags", "keys": "x.keys",
}


def _side(pkg, server):
    m = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}") for k, v in MODULES.items()})
    m.Server = server
    m.METRICS = m.observe.METRICS
    return m


M = {
    "ref": _side("dgraph_tpu", RefServer),
    "port": _side("dgraph_tpu_torch", lambda **kw: Server(device="cpu", **kw)),
}


@pytest.fixture(autouse=True)
def forced(monkeypatch):
    """The port's set ops on the device path with the member sweep on;
    no fault plan left installed in either package."""
    monkeypatch.setattr(dispatch, "_FORCE_DEVICE", True)
    monkeypatch.setattr(dispatch, "_USE_PALLAS", True)
    for m in M.values():
        m.faults.reset()
    yield
    for m in M.values():
        m.faults.reset()


# ---------------------------------------------------------------------------
# reference cases: each returns what the port must reproduce
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _data(server, q, **kw):
    return server.query(q, **kw)["data"]


# tests/test_query_advanced.py

ADV_SCHEMA = """
name: string @index(exact) @upsert .
email: string @index(exact) @upsert .
age: int @index(int) .
bonus: float .
friend: [uid] @reverse .
"""


def _adv_server(m):
    s = m.Server()
    s.alter(ADV_SCHEMA)
    s.new_txn().mutate_rdf(set_rdf="""
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
        """, commit_now=True)
    return s


@case
def subscriptions(m, tmp, mp):
    s = m.Server()
    s.alter("name: string @index(exact) .\ncity: string .")
    events = []
    subs = m.subs.Subscriptions(s)
    sid = subs.subscribe("{ q(func: has(name)) { name } }", events.append)
    assert len(events) == 1  # initial snapshot
    s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "N" .', commit_now=True)
    assert len(events) == 2
    assert events[1]["data"]["q"] == [{"name": "N"}]
    # a commit touching an unrelated predicate does not refire
    s.new_txn().mutate_rdf(set_rdf='<0x2> <city> "Pune" .', commit_now=True)
    assert len(events) == 2
    subs.unsubscribe(sid)
    s.new_txn().mutate_rdf(set_rdf='<0x3> <name> "M" .', commit_now=True)
    assert len(events) == 2
    return [e["data"] for e in events]


@case
def subscription_acl_safe(m, tmp, mp):
    s = _adv_server(m)
    s.enable_acl(secret=b"z" * 32)
    g = s.login("groot", "password")["accessJwt"]
    events = []
    m.subs.Subscriptions(s).subscribe(
        "{ q(func: has(name)) { name } }", events.append, access_jwt=g)
    # the commit succeeds though the re-evaluation runs under ACL
    s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "S" .', access_jwt=g, commit_now=True)
    assert len(events) == 2
    return [e["data"] for e in events]


@case
def subscribe_graphql_without_schema(m, tmp, mp):
    s = m.Server()
    with pytest.raises(ValueError, match="no GraphQL schema configured"):
        m.subs.Subscriptions(s).subscribe_graphql(
            "subscription { queryT { id } }", lambda r: None)
    return "raised"


# tests/test_ops_subsystems.py

SUB_SCHEMA = "name: string @index(exact) .\nfriend: [uid] ."


def _events(path):
    return [json.loads(line) for line in open(path)]


@case
def cdc_events(m, tmp, mp):
    path = str(tmp / "cdc.ndjson")
    s = m.Server()
    s.alter(SUB_SCHEMA)
    cdc = m.cdc.CDC(s, sink_path=path)
    s.new_txn().mutate_rdf(
        set_rdf='<0x1> <name> "A" .\n<0x1> <friend> <0x2> .', commit_now=True)
    s.new_txn().mutate_rdf(del_rdf="<0x1> <friend> <0x2> .", commit_now=True)
    cdc.close()
    events = _events(path)
    ops = [(e["event"]["operation"], e["event"]["attr"]) for e in events]
    assert ("set", "name") in ops and ("set", "friend") in ops and ("del", "friend") in ops
    assert cdc.checkpoint > 0
    ts = [e["meta"]["commit_ts"] for e in events]
    assert ts == sorted(ts)
    return events, cdc.checkpoint


@case
def rollup_compacts_chains(m, tmp, mp):
    s = m.Server()
    s.alter(SUB_SCHEMA)
    for i in range(5):
        s.new_txn().mutate_rdf(set_rdf=f"<0x1> <friend> <{hex(10 + i)}> .", commit_now=True)
    key = m.keys.DataKey("friend", 1)
    assert len(s.kv.versions(key, 1 << 61)) == 5
    n = m.rollup.rollup_all(s, min_deltas=2)
    assert n >= 1
    vers = s.kv.versions(key, 1 << 61)
    assert len(vers) == 1 and vers[0][1][0] != m.pl.KIND_DELTA
    res = _data(s, "{ q(func: uid(0x1)) { friend { uid } } }")
    assert len(res["q"][0]["friend"]) == 5
    # reads at the rollup's timestamp still see the whole list
    at = _data(s, "{ q(func: uid(0x1)) { friend { uid } } }", read_ts=vers[0][0])
    assert at == res
    return n, [(ts, rec.hex()) for ts, rec in vers], res


@case
def task_queue_serializes_ops(m, tmp, mp):
    s = m.Server()
    s.alter(SUB_SCHEMA)
    s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "T" .', commit_now=True)
    order = []
    tq = m.tasks._queue_of(s)

    def slow(tag):
        def run():
            order.append(("start", tag))
            time.sleep(0.05)
            order.append(("end", tag))
            return tag
        return run

    t1 = tq.enqueue(m.tasks.KIND_EXPORT, slow("a"))
    t2 = tq.enqueue(m.tasks.KIND_BACKUP, slow("b"))
    assert tq.wait(t1)["status"] == "Success"
    assert tq.wait(t2)["status"] == "Success"
    assert order == [("start", "a"), ("end", "a"), ("start", "b"), ("end", "b")]
    st = tq.wait(m.tasks.enqueue_backup(s, str(tmp / "b")))
    assert st["status"] == "Success" and st["result"]["records"] > 0
    assert tq.wait(m.tasks.enqueue_rollup(s, min_deltas=1))["status"] == "Success"
    st = tq.wait(tq.enqueue(m.tasks.KIND_EXPORT, lambda: 1 / 0))
    assert st["status"] == "Failed" and "division" in st["error"]
    assert len(tq.list()) == 5
    return order, [(t["kind"], t["status"]) for t in tq.list()]


# tests/test_ops_plane.py, the single-Server cases

OPS_SCHEMA = "name: string @index(exact) .\nage: int .\nfriend: [uid] ."


def _seed(m, n=12):
    s = m.Server()
    s.alter(OPS_SCHEMA)
    rdf = [f'<0x{i:x}> <name> "n{i}" .' for i in range(1, n + 1)]
    rdf += [f'<0x{i:x}> <age> "{i}"^^<xs:int> .' for i in range(1, n + 1)]
    s.new_txn().mutate_rdf(set_rdf="\n".join(rdf), commit_now=True)
    return s


def _entry(since, read_ts):
    return dict(since=since, read_ts=read_ts, records=1,
                type="full" if since == 0 else "incremental", files=[])


@case
def manifest_chain_gap_overlap_detection(m, tmp, mp):
    bk = m.bk
    ok = {"backups": [_entry(0, 10), _entry(10, 20), _entry(20, 30)]}
    assert len(bk.validate_chain(ok)) == 3
    # a later full backup restarts the chain
    got = bk.validate_chain({"backups": [_entry(0, 10), _entry(0, 25), _entry(25, 30)]})
    assert [e["since"] for e in got] == [0, 25]
    for chain, what in (
        ([_entry(0, 10), _entry(15, 20)], "gap"),
        ([_entry(0, 10), _entry(5, 20)], "overlap"),
        ([_entry(5, 10)], "incremental"),
        ([_entry(0, 10), _entry(10, 10)], "inverted"),
    ):
        with pytest.raises(bk.ManifestChainError, match=what):
            bk.validate_chain({"backups": chain})
    return [e["since"] for e in got]


@case
def restore_refuses_gapped_chain(m, tmp, mp):
    bdir = str(tmp / "b")
    s = _seed(m)
    e1 = m.bk.backup(s, bdir)
    s.new_txn().mutate_rdf(set_rdf='<0x40> <name> "x" .', commit_now=True)
    e2 = m.bk.backup(s, bdir)
    man = m.bk.load_manifest(bdir)
    man["backups"][1]["since"] += 3  # tear a hole in the chain
    m.bk.save_manifest(bdir, man)
    with pytest.raises(m.bk.ManifestChainError):
        m.bk.restore(m.Server(), bdir)
    return e1, e2


def _record_offsets(bk, payload):
    offsets, pos = [], 0
    while pos < len(payload):
        klen, _ts, vlen, _crc = bk._REC2.unpack_from(payload, pos)
        offsets.append(pos)
        pos += bk._REC2.size + klen + vlen
    assert pos == len(payload)
    return offsets


@case
def torn_backup_file_rejected_at_every_record_boundary(m, tmp, mp):
    bk = m.bk
    bdir = str(tmp / "b")
    entry = bk.backup(_seed(m, n=6), bdir)
    fmeta = entry["files"][0]
    path = os.path.join(bdir, fmeta["name"])
    payload = gzip.decompress(open(path, "rb").read())
    offsets = _record_offsets(bk, payload)
    assert len(offsets) >= 3
    for cut in offsets[1:] + list(range(offsets[-1] + 1, len(payload))):
        with open(path, "wb") as f:
            f.write(gzip.compress(payload[:cut]))
        with pytest.raises(bk.TornBackupError):
            list(bk.iter_file_records(bdir, fmeta))
        with pytest.raises(bk.TornBackupError):
            bk.restore(m.Server(), bdir)
    # a flipped bit inside a record body trips the per-record CRC
    flipped = bytearray(payload)
    flipped[offsets[1] + bk._REC2.size + 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(gzip.compress(bytes(flipped)))
    with pytest.raises(bk.TornBackupError):
        bk.restore(m.Server(), bdir)
    with open(path, "wb") as f:
        f.write(b"\x00garbage")
    with pytest.raises(bk.TornBackupError):
        bk.restore(m.Server(), bdir)
    with open(path, "wb") as f:
        f.write(gzip.compress(payload))
    assert bk.restore(m.Server(), bdir) == entry["records"]
    return entry, offsets


@case
def legacy_v1_entry_restores_and_detects_truncation(m, tmp, mp):
    bk = m.bk
    bdir = str(tmp / "legacy")
    os.makedirs(bdir)
    s = _seed(m, n=4)
    recs, n = [], 0
    for key, vers in s.kv.iterate_versions(b"", 1 << 62):
        for ts, val in vers:
            recs.append(bk._REC.pack(len(key), ts, len(val)) + key + val)
            n += 1
    blob = b"".join(recs)
    with gzip.open(os.path.join(bdir, "backup-0001-0-9.gz"), "wb") as f:
        f.write(blob)
    bk.save_manifest(bdir, {"backups": [{
        "path": "backup-0001-0-9.gz", "since": 0,
        "read_ts": s.zero.max_assigned, "records": n, "type": "full",
    }]})
    s2 = m.Server()
    assert bk.restore(s2, bdir) == n
    got = _data(s2, "{ q(func: has(name)) { uid } }")
    assert len(got["q"]) == 4
    with gzip.open(os.path.join(bdir, "backup-0001-0-9.gz"), "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(bk.TornBackupError):
        bk.restore(m.Server(), bdir)
    return n, got


@case
def uncommitted_chunk_files_are_invisible(m, tmp, mp):
    bdir = str(tmp / "b")
    entry = m.bk.backup(_seed(m, n=3), bdir)
    stray = m.bk.BackupWriter(bdir, 99, 0, 1 << 20)
    stray.add(b"\x00junkkey", 999999, b"junkval")
    stray.finish()
    s2 = m.Server()
    assert m.bk.restore(s2, bdir) == entry["records"]
    assert s2.kv.get(b"\x00junkkey", 1 << 62) is None
    return entry


@case
def chunked_backup_roundtrip_and_until(m, tmp, mp):
    mp.setenv("DGRAPH_TPU_BACKUP_CHUNK_BYTES", "1")  # floor: 64 KiB
    bdir = str(tmp / "b")
    s = _seed(m, n=10)
    e1 = m.bk.backup(s, bdir)
    assert e1["type"] == "full" and len(e1["files"]) >= 1
    cut_ts = s.zero.max_assigned
    s.new_txn().mutate_rdf(set_rdf='<0x60> <name> "late" .', commit_now=True)
    e2 = m.bk.backup(s, bdir)
    assert e2["type"] == "incremental" and e2["since"] == e1["read_ts"]
    s2 = m.Server()
    m.bk.restore(s2, bdir)
    q = "{ q(func: has(name), orderasc: name) { name } }"
    assert _data(s2, q) == _data(s, q)
    s3 = m.Server()
    m.bk.restore(s3, bdir, until=cut_ts)
    assert _data(s3, '{ q(func: eq(name, "late")) { uid } }')["q"] == []
    assert len(_data(s3, "{ q(func: has(name)) { uid } }")["q"]) == 10
    return e1, e2, _data(s2, q)


@case
def cdc_group_commit_ordering_and_dedup_ids(m, tmp, mp):
    s = m.Server()
    s.alter("v: int .")
    got = []
    cdc = m.cdc.CDC(s, sink_fn=got.append)
    try:
        def w(i):
            for j in range(5):
                s.new_txn().mutate_rdf(set_rdf=f'<0x{i:x}> <v> "{j}"^^<xs:int> .',
                                       commit_now=True)

        ths = [threading.Thread(target=w, args=(i,)) for i in range(1, 9)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        assert cdc.flush()
        ts = [e["meta"]["commit_ts"] for e in got]
        assert ts == sorted(ts) and len(got) == 40
        assert len({(e["meta"]["commit_ts"], e["meta"]["seq"]) for e in got}) == 40
        assert cdc.checkpoint == max(ts)
    finally:
        cdc.close()
    # which thread committed at which timestamp varies run to run: compare
    # what does not (every subject's five values, in commit order)
    per = {}
    for e in got:
        per.setdefault(e["event"]["uid"], []).append(e["event"]["value"])
    return sorted(per.items()), _data(s, "{ q(func: has(v)) { uid v } }")


@case
def cdc_datetime_rfc3339_golden(m, tmp, mp):
    path = str(tmp / "cdc.ndjson")
    s = m.Server()
    s.alter("when: datetime .")
    cdc = m.cdc.CDC(s, sink_path=path)
    try:
        s.new_txn().mutate_rdf(
            set_rdf='<0x1> <when> "2022-10-12T07:20:50.52Z"^^<xs:dateTime> .',
            commit_now=True)
        assert cdc.flush()
    finally:
        cdc.close()
    events = _events(path)
    vals = [e["event"]["value"] for e in events if e["event"]["attr"] == "when"]
    assert vals == ["2022-10-12T07:20:50.520000Z"]
    assert m.types.parse_datetime(vals[0]) == m.types.parse_datetime("2022-10-12T07:20:50.52Z")
    s2 = m.Server()
    s2.alter("when: datetime .")
    s2.new_txn().mutate_rdf(set_rdf=f'<0x1> <when> "{vals[0]}"^^<xs:dateTime> .',
                            commit_now=True)
    q = "{ q(func: has(when)) { when } }"
    assert _data(s2, q) == _data(s, q)
    return events, _data(s2, q)


@case
def cdc_sink_retry_and_backpressure(m, tmp, mp):
    s = m.Server()
    s.alter("v: int .")
    delivered = []
    fails = {"n": 0}

    def flaky(ev):
        if fails["n"] < 3:
            fails["n"] += 1
            raise IOError("sink down")
        delivered.append(ev)

    retries0 = m.METRICS.value("cdc_sink_retries_total")
    cdc = m.cdc.CDC(s, sink_fn=flaky, queue_max=2,
                    retry=m.retry.RetryPolicy(base=0.005, cap=0.02))
    try:
        for j in range(6):
            s.new_txn().mutate_rdf(set_rdf=f'<0x1> <v> "{j}"^^<xs:int> .', commit_now=True)
        assert cdc.flush()
        seen = {(e["meta"]["commit_ts"], e["meta"]["seq"]): e["event"] for e in delivered}
        assert len(seen) == 6
        assert m.METRICS.value("cdc_sink_retries_total") >= retries0 + 3
        assert cdc.checkpoint > 0
    finally:
        cdc.close()
    return sorted(seen.items())


def _apply_events(server, events):
    """The reference test's consumer: each event through the mutation
    path, one commit each."""
    for ev in events:
        e = ev["event"]
        subj, pred = f"<0x{e['uid']:x}>", f"<{e['attr']}>"
        if e["operation"] == "set":
            if "value_uid" in e:
                rdf = f"{subj} {pred} <0x{e['value_uid']:x}> ."
            else:
                v = e["value"]
                if isinstance(v, bool):
                    rdf = f'{subj} {pred} "{v}"^^<xs:boolean> .'
                elif isinstance(v, int):
                    rdf = f'{subj} {pred} "{v}"^^<xs:int> .'
                elif isinstance(v, float):
                    rdf = f'{subj} {pred} "{v}"^^<xs:float> .'
                else:
                    sv = str(v).replace("\\", "\\\\").replace('"', '\\"')
                    rdf = f'{subj} {pred} "{sv}" .'
            server.new_txn().mutate_rdf(set_rdf=rdf, commit_now=True)
        else:
            obj = f"<0x{e['value_uid']:x}>" if "value_uid" in e else "*"
            server.new_txn().mutate_rdf(del_rdf=f"{subj} {pred} {obj} .", commit_now=True)


@case
def cdc_apply_equivalence_single_engine_with_deletes(m, tmp, mp):
    schema = OPS_SCHEMA + "\nwhen: datetime .\nscore: float ."
    s = m.Server()
    s.alter(schema)
    got = []
    cdc = m.cdc.CDC(s, sink_fn=got.append)
    try:
        s.new_txn().mutate_rdf(
            set_rdf='<0x1> <name> "ann" .\n<0x2> <name> "ben" .\n'
            '<0x1> <friend> <0x2> .\n<0x1> <age> "7"^^<xs:int> .\n'
            '<0x2> <score> "2.5"^^<xs:float> .\n'
            '<0x2> <when> "2023-01-02T03:04:05.6Z"^^<xs:dateTime> .', commit_now=True)
        s.new_txn().mutate_rdf(del_rdf="<0x1> <friend> <0x2> .", commit_now=True)
        s.new_txn().mutate_rdf(set_rdf='<0x1> <age> "8"^^<xs:int> .', commit_now=True)
        assert cdc.flush()
    finally:
        cdc.close()
    fresh = m.Server()
    fresh.alter(schema)
    _apply_events(fresh, got)
    out = []
    for q in ("{ q(func: has(name), orderasc: name) { name age score when } }",
              '{ q(func: eq(name, "ann")) { friend { name } age } }'):
        assert _data(fresh, q) == _data(s, q), q
        out.append(_data(fresh, q))
    return got, out


@case
def cdc_replay_covers_checkpoint_gap_exactly(m, tmp, mp):
    s = m.Server()
    s.alter("v: int .\nname: string @index(exact) .")
    live = []
    cdc = m.cdc.CDC(s, sink_fn=live.append)
    try:
        for j in range(4):
            s.new_txn().mutate_rdf(set_rdf=f'<0x{j + 1:x}> <name> "r{j}" .', commit_now=True)
        assert cdc.flush()
    finally:
        cdc.close()
    mid = sorted({e["meta"]["commit_ts"] for e in live})[1]
    s.kv.put(m.cdc.CDC_CHECKPOINT_KEY, 1 << 61, struct.pack("<Q", mid))
    replayed = []
    cdc2 = m.cdc.CDC(s, sink_fn=replayed.append, replay=True)
    try:
        assert cdc2.flush()
    finally:
        cdc2.close()
    live_ids = {(e["meta"]["commit_ts"], e["meta"]["seq"]): e["event"]
                for e in live if e["meta"]["commit_ts"] > mid}
    replay_ids = {(e["meta"]["commit_ts"], e["meta"]["seq"]): e["event"] for e in replayed}
    assert replay_ids == live_ids
    assert cdc2._ckpt_saved == max(ts for ts, _ in live_ids)
    return sorted(replay_ids.items())


# tests/test_flags_handlers.py


@case
def superflag_parse_defaults_and_types(m, tmp, mp):
    sf = m.flags.SuperFlag("backend=lsm; memtable-mb=16",
                           "backend=mem; encryption-key-file=; memtable-mb=8")
    assert sf.get_string("backend") == "lsm"
    assert sf.get_int("memtable-mb") == 16
    assert sf.get_string("encryption-key-file") == ""
    assert sf.get_int("memtable_mb") == 16  # underscores normalize to dashes
    return sf.get_string("backend"), sf.get_int("memtable-mb")


@case
def superflag_rejects_unknown_and_bad_values(m, tmp, mp):
    with pytest.raises(m.flags.SuperFlagError):
        m.flags.SuperFlag("bogus=1", "known=2")
    with pytest.raises(m.flags.SuperFlagError):
        m.flags.SuperFlag("known", "known=2")
    sf = m.flags.SuperFlag("flag=notbool", "flag=")
    with pytest.raises(m.flags.SuperFlagError):
        sf.get_bool("flag")
    return "raised"


@case
def file_handler_roundtrip(m, tmp, mp):
    h = m.handlers.handler_for(f"file://{tmp}/b")
    assert isinstance(h, m.handlers.FileHandler)
    h.put("x.bin", b"data")
    assert h.exists("x.bin") and h.get("x.bin") == b"data"
    assert h.ls() == ["x.bin"]
    return h.ls()


@case
def s3_and_kafka_gated(m, tmp, mp):
    errors = []
    for call, what in ((lambda: m.handlers.handler_for("s3://bucket/prefix"), "boto3"),
                       (lambda: m.handlers.sink_for("kafka://broker:9092/topic"), "kafka-python"),
                       (lambda: m.handlers.handler_for("ftp://nope"), "scheme")):
        with pytest.raises(m.handlers.HandlerError, match=what) as err:
            call()
        errors.append(str(err.value))
    return errors


@case
def backup_to_file_uri_and_restore(m, tmp, mp):
    s = m.Server()
    s.alter("name: string @index(exact) .")
    s.new_txn().mutate_rdf(set_rdf='_:a <name> "bk" .', commit_now=True)
    entry = m.handlers.backup_to_uri(s, f"file://{tmp}/bk")
    assert entry["records"] >= 1
    s2 = m.Server()
    m.bk.restore(s2, str(tmp / "bk"))
    out = _data(s2, '{ q(func: eq(name, "bk")) { name } }')
    assert out["q"][0]["name"] == "bk"
    return entry, out


@case
def file_sink_cdc(m, tmp, mp):
    path = str(tmp / "cdc.ndjson")
    sink = m.handlers.sink_for(path)
    assert isinstance(sink, m.handlers.FileSink)
    sink.send(b"k", json.dumps({"e": 1}).encode())
    sink.send(b"k", json.dumps({"e": 2}).encode())
    sink.close()
    got = [json.loads(line)["e"] for line in open(path).read().strip().splitlines()]
    assert got == [1, 2]
    return got


# tests/test_loaders_admin.py

LD_SCHEMA = """
name: string @index(term, exact) .
age: int @index(int) .
friend: [uid] @reverse @count .
embedding: float32vector @index(hnsw(metric:"euclidean")) .
"""
LD_RDF = """
_:a <name> "Ann" .
_:a <age> "30"^^<xs:int> .
_:a <friend> _:b .
_:a <embedding> "[1.0, 2.0]"^^<float32vector> .
_:b <name> "Ben" .
_:b <age> "40"^^<xs:int> .
_:b <friend> _:a .
"""


def _bulk_server(m):
    s = m.Server()
    s.alter(LD_SCHEMA)
    m.bulk.bulk_load_rdf(s, LD_RDF)
    return s


@case
def bulk_load_and_query(m, tmp, mp):
    s = _bulk_server(m)
    res = _data(s, '{ q(func: eq(name, "Ann")) { name age friend { name } } }')
    assert res["q"][0]["name"] == "Ann" and res["q"][0]["friend"][0]["name"] == "Ben"
    rev = _data(s, '{ q(func: eq(name, "Ben")) { c: count(~friend) } }')
    assert rev["q"][0]["c"] == 1
    vec = _data(s, '{ v(func: similar_to(embedding, 1, "[1.0,2.0]")) { name } }')
    assert vec["v"][0]["name"] == "Ann"
    return res, rev, vec


@case
def bulk_equals_live(m, tmp, mp):
    sb, sl = _bulk_server(m), m.Server()
    sl.alter(LD_SCHEMA)
    m.live.LiveLoader(sl, batch_size=2).load_rdf(LD_RDF)
    q = "{ q(func: has(name), orderasc: name) { name age c: count(friend) } }"
    assert _data(sb, q) == _data(sl, q)
    return _data(sb, q)


@case
def live_loader_stats(m, tmp, mp):
    s = m.Server()
    s.alter(LD_SCHEMA)
    ll = m.live.LiveLoader(s, batch_size=3)
    ll.load_rdf(LD_RDF)
    assert ll.nquads_loaded == 7 and ll.txns_committed >= 2
    return ll.nquads_loaded, ll.txns_committed


@case
def export_rdf_roundtrip(m, tmp, mp):
    s = _bulk_server(m)
    out = m.export.export(s, str(tmp), fmt="rdf")
    assert out["nquads"] >= 7
    with gzip.open(out["data"], "rt") as f:
        rdf = f.read()
    with gzip.open(out["schema"], "rt") as f:
        schema_text = f.read()
    s2 = m.Server()
    s2.alter(schema_text)
    m.bulk.bulk_load_rdf(s2, rdf)
    q = "{ q(func: has(name), orderasc: name) { name age friend { name } } }"
    assert _data(s, q) == _data(s2, q)
    return rdf, schema_text, _data(s2, q)


@case
def export_json(m, tmp, mp):
    out = m.export.export(_bulk_server(m), str(tmp), fmt="json", compress=False)
    with open(out["data"]) as f:
        rows = json.load(f)
    assert {r.get("name") for r in rows if "name" in r} == {"Ann", "Ben"}
    return rows


@case
def backup_restore_full_and_incremental(m, tmp, mp):
    bdir = str(tmp / "backups")
    s = _bulk_server(m)
    e1 = m.bk.backup(s, bdir)
    assert e1["type"] == "full"
    s.new_txn().mutate_rdf(set_rdf='<0x100> <name> "Cid" .', commit_now=True)
    e2 = m.bk.backup(s, bdir)
    assert e2["type"] == "incremental" and e2["since"] == e1["read_ts"]
    s2 = m.Server()
    s2.alter(LD_SCHEMA)
    assert m.bk.restore(s2, bdir) > 0
    q = "{ q(func: has(name), orderasc: name) { name } }"
    assert _data(s2, q) == _data(s, q)
    return e1, e2, _data(s2, q)


@case
def restart_persistence(m, tmp, mp):
    d = str(tmp / "data")
    s = m.Server(data_dir=d)
    s.alter(LD_SCHEMA)
    s.new_txn().mutate_rdf(set_rdf='<0x1> <name> "Zed" .\n'
                           '<0x1> <embedding> "[0.5, 0.5]"^^<float32vector> .',
                           commit_now=True)
    s.kv.close()
    s2 = m.Server(data_dir=d)
    assert s2.schema.get("name").tokenizers == ["term", "exact"]
    assert _data(s2, '{ q(func: eq(name, "Zed")) { name } }')["q"] == [{"name": "Zed"}]
    v = _data(s2, '{ v(func: similar_to(embedding, 1, "[0.5,0.5]")) { uid } }')
    assert v["v"] == [{"uid": "0x1"}]
    s2.new_txn().mutate_rdf(set_rdf='<0x2> <name> "Yao" .', commit_now=True)
    res = _data(s2, "{ q(func: has(name), orderasc: name) { name } }")
    assert [o["name"] for o in res["q"]] == ["Yao", "Zed"]
    s2.kv.close()
    return v, res


@case
def restart_uid_lease_no_reuse(m, tmp, mp):
    d = str(tmp / "lease")
    s = m.Server(data_dir=d)
    s.alter("name: string @index(exact) .")
    s.new_txn().mutate_rdf(set_rdf='_:a <name> "Alice" .', commit_now=True)
    s.kv.close()
    s2 = m.Server(data_dir=d)
    s2.new_txn().mutate_rdf(set_rdf='_:b <name> "Bob" .', commit_now=True)
    res = _data(s2, "{ q(func: has(name), orderasc: name) { uid name } }")
    assert [o["name"] for o in res["q"]] == ["Alice", "Bob"]
    s2.kv.close()
    return res


@case
def drop_attr_survives_restart(m, tmp, mp):
    d = str(tmp / "drop")
    s = m.Server(data_dir=d)
    s.alter("name: string @index(exact) .\ncity: string .")
    s.alter(drop_attr="name")
    s.kv.close()
    s2 = m.Server(data_dir=d)
    assert s2.schema.get("name") is None and s2.schema.get("city") is not None
    s2.kv.close()
    return sorted(s2.schema.predicates())


@case
def rdf_iri_fragments_and_multistatement(m, tmp, mp):
    nqs = m.rdf.parse_rdf(
        '<0x1> <http://schema.org#name> "Alice" . <0x2> <age> "3"^^<xs:int> .')
    assert len(nqs) == 2 and nqs[0].predicate == "http://schema.org#name"
    assert len(m.rdf.parse_rdf('# a comment\n<0x1> <name> "A" .')) == 1
    return [(n.subject, n.predicate) for n in nqs]


@case
def loaders_accept_multistatement_lines(m, tmp, mp):
    s = m.Server()
    s.alter("name: string @index(exact) .")
    m.bulk.bulk_load_rdf(s, '_:a <name> "X" . _:b <name> "Y" .')
    res = _data(s, "{ q(func: has(name)) { uid name } }")
    assert {o["name"] for o in res["q"]} == {"X", "Y"}
    return res


@case
def rdf_dot_abutting_and_export_geo_roundtrip(m, tmp, mp):
    assert len(m.rdf.parse_rdf('<0x1> <name> "Alice".\n<0x2> <name> "Bob".')) == 2
    s = m.Server()
    s.alter("loc: geo @index(geo) .")
    s.new_txn().mutate_rdf(
        set_rdf='<0x1> <loc> "{\\"type\\":\\"Point\\",\\"coordinates\\":[1.0,2.0]}"'
        "^^<geo:geojson> .", commit_now=True)
    out = m.export.export(s, str(tmp), fmt="rdf", compress=False)
    rdf = open(out["data"]).read()
    s2 = m.Server()
    s2.alter("loc: geo @index(geo) .")
    m.bulk.bulk_load_rdf(s2, rdf)
    res = _data(s2, "{ q(func: uid(0x1)) { loc } }")
    assert res["q"][0]["loc"]["type"] == "Point"
    return rdf, res


@case
def restore_into_fresh_server_recovers_schema(m, tmp, mp):
    bdir = str(tmp / "b2")
    m.bk.backup(_bulk_server(m), bdir)
    s2 = m.Server()  # no alter: the schema comes from the backup
    m.bk.restore(s2, bdir)
    assert s2.schema.get("name").tokenizers == ["term", "exact"]
    res = _data(s2, '{ q(func: eq(name, "Ann")) { name } }')
    assert res["q"] == [{"name": "Ann"}]
    vec = _data(s2, '{ v(func: similar_to(embedding, 1, "[1.0,2.0]")) { name } }')
    assert vec["v"][0]["name"] == "Ann"
    return res, vec


@case
def parallel_bulk_loader_spill_and_ingest(m, tmp, mp):
    rdf = []
    for i in range(500):
        rdf.append(f'<0x{i + 1:x}> <name> "n{i:03d}" .')
        rdf.append(f"<0x{i + 1:x}> <follows> <0x{(i % 250) + 1:x}> .")
    rdf.append('_:blank <name> "from-xid" .')
    mp.setenv("DGRAPH_TPU_STORAGE", "lsm")
    s = m.Server(data_dir=str(tmp / "l"))
    s.alter("name: string @index(exact) .\nfollows: [uid] @reverse @count .")
    ld = m.bulk2.ParallelBulkLoader(s, workdir=str(tmp / "w"), workers=1, spill_entries=200)
    ld.load_text("\n".join(rdf))
    assert ld.nquads == 1001
    out = [_data(s, '{ q(func: eq(name, "n007")) { name follows { name } } }'),
           _data(s, '{ q(func: eq(name, "n003")) { c: count(~follows) } }'),
           _data(s, '{ q(func: eq(name, "from-xid")) { name } }')]
    assert out[0]["q"][0]["follows"][0]["name"] == "n007"
    assert out[1]["q"][0]["c"] == 2
    assert out[2]["q"][0]["name"] == "from-xid"
    s.kv.close()
    return out


@case
def parallel_bulk_loader_vectors(m, tmp, mp):
    s = m.Server()
    s.alter('emb: float32vector @index(hnsw(metric:"euclidean")) .\n'
            "name: string @index(exact) .")
    rdf = []
    for i in range(8):
        rdf.append(f'<0x{i + 1:x}> <emb> "[{float(i)}, {float(i)}]"^^<xs:float32vector> .')
        rdf.append(f'<0x{i + 1:x}> <name> "v{i}" .')
    m.bulk2.ParallelBulkLoader(s, workdir=str(tmp / "w"), workers=1).load_text("\n".join(rdf))
    out = _data(s, '{ q(func: similar_to(emb, 2, "[3.1, 3.1]")) { name } }')
    assert [r["name"] for r in out["q"]] == ["v3", "v4"]
    return out


@case
def parallel_bulk_loader_type_inference_chunk_independent(m, tmp, mp):
    lines = ['<0x1> <age> "25"^^<xs:int> .']
    lines += [f'<0x{i:x}> <age> "{i}"^^<xs:int> .' for i in range(2, 40)]
    s = m.Server()
    m.bulk2.ParallelBulkLoader(s, workdir=str(tmp / "w"), workers=2).load_text("\n".join(lines))
    su = s.schema.get("age")
    assert su is not None and su.value_type == m.types.TypeID.INT
    out = _data(s, "{ q(func: eq(age, 25)) { age } }")
    assert out["q"][0]["age"] == 25
    return out


# tests/test_multipart.py, the split and rollup cases


def _deltas(m, kv, key, uids, ts=1, op=None):
    for u in uids:
        ts += 1
        kv.put(key, ts, m.pl.encode_delta([m.pl.Posting(uid=int(u), op=op or m.pl.OP_SET)]))
    return ts


@case
def split_key_roundtrip(m, tmp, mp):
    keys = m.keys
    base = keys.DataKey("friend", 42)
    sk = keys.SplitKey(base, 7)
    assert keys.base_of_split(sk) == (base, 7)
    pk = keys.parse_key(sk)
    assert pk.tag == keys.TAG_SPLIT and (pk.attr, pk.uid, pk.split_start) == ("friend", 42, 7)
    assert not sk.startswith(keys.DataPrefix("friend"))
    assert sk.startswith(keys.SplitPredicatePrefix("friend"))
    return sk.hex()


def _read_back(m, kv, key, ts):
    return m.pl.PostingList.from_versions(key, kv.versions(key, ts), kv=kv, read_ts=ts).uids()


@case
def rollup_splits_and_reads_back(m, tmp, mp):
    mp.setattr(m.pl, "MAX_PART_UIDS", 100)
    kv = m.kv.MemKV()
    key = m.keys.DataKey("follows", 1)
    uids = np.arange(1, 501, dtype=np.uint64)
    _deltas(m, kv, key, uids)
    assert m.rollup.rollup_key(kv, key, 1000)
    _, rec = kv.get(key, 1000)
    splits = m.pl.decode_record(rec)[3]
    assert len(splits) == 10  # 500 / (100 // 2)
    for st in splits:
        assert kv.get(m.keys.SplitKey(key, st), 1000) is not None
    np.testing.assert_array_equal(_read_back(m, kv, key, 1000), uids)
    return rec.hex(), list(splits)


@case
def resplit_after_growth(m, tmp, mp):
    mp.setattr(m.pl, "MAX_PART_UIDS", 100)
    kv = m.kv.MemKV()
    key = m.keys.DataKey("follows", 2)
    ts = _deltas(m, kv, key, range(1, 201))
    assert m.rollup.rollup_key(kv, key, 1000)
    splits1 = m.pl.decode_record(kv.get(key, 1000)[1])[3]
    _deltas(m, kv, key, range(201, 501), ts)
    assert m.rollup.rollup_key(kv, key, 2000)
    splits2 = m.pl.decode_record(kv.get(key, 2000)[1])[3]
    assert len(splits2) > len(splits1)
    np.testing.assert_array_equal(_read_back(m, kv, key, 2000),
                                  np.arange(1, 501, dtype=np.uint64))
    return list(splits1), list(splits2)


@case
def shrink_merges_back(m, tmp, mp):
    mp.setattr(m.pl, "MAX_PART_UIDS", 100)
    kv = m.kv.MemKV()
    key = m.keys.DataKey("follows", 3)
    ts = _deltas(m, kv, key, range(1, 301))
    assert m.rollup.rollup_key(kv, key, 1000)
    _deltas(m, kv, key, range(51, 301), ts, op=m.pl.OP_DEL)
    assert m.rollup.rollup_key(kv, key, 2000)
    rec = kv.get(key, 2000)[1]
    assert m.pl.decode_record(rec)[3] == []  # merged back into one record
    np.testing.assert_array_equal(_read_back(m, kv, key, 2000),
                                  np.arange(1, 51, dtype=np.uint64))
    return rec.hex()


@case
def bulk_rollup_writes_split(m, tmp, mp):
    mp.setattr(m.pl, "MAX_PART_UIDS", 64)
    kv = m.kv.MemKV()
    key = m.keys.DataKey("x", 9)
    uids = np.arange(10, 400, dtype=np.uint64)
    writes = list(m.pl.rollup_writes(key, uids, [], 5))
    for k, ts, rec in writes:
        kv.put(k, ts, rec)
    np.testing.assert_array_equal(_read_back(m, kv, key, 10), uids)
    return [(k.hex(), ts, rec.hex()) for k, ts, rec in writes]


@case
def engine_query_over_split_list(m, tmp, mp):
    mp.setattr(m.pl, "MAX_PART_UIDS", 50)
    s = m.Server()
    s.alter("name: string @index(exact) .\nfollows: [uid] .")
    rdf = ['<0x1> <name> "hub" .']
    for i in range(2, 202):
        rdf.append(f"<0x1> <follows> <0x{i:x}> .")
        rdf.append(f'<0x{i:x}> <name> "n{i}" .')
    s.new_txn().mutate_rdf(set_rdf="\n".join(rdf), commit_now=True)
    m.rollup.rollup_all(s, min_deltas=1)
    _, rec = s.kv.get(m.keys.DataKey("follows", 1), 1 << 60)
    assert len(m.pl.decode_record(rec)[3]) >= 2
    out = _data(s, '{ q(func: eq(name, "hub")) { follows { name } } }')
    assert len(out["q"][0]["follows"]) == 200
    c = _data(s, '{ q(func: eq(name, "hub")) { c: count(follows) } }')
    assert c["q"][0]["c"] == 200
    return out, c


# ---------------------------------------------------------------------------
# the slice's own cases
# ---------------------------------------------------------------------------

GRAPH_SCHEMA = ("child: [uid] .\ntag: string @index(exact) .\n"
                'emb: float32vector @index(hnsw(metric:"euclidean")) .')


def _small_graph_server(m, fanout=6, pool=300):
    """chip_smoke's fan-out graph at a small size, with a few vectors."""
    g = chip_smoke.make_graph(fanout, pool, hot_every=5)
    s = m.Server()
    chip_smoke.load_graph(s, g)
    s.alter(GRAPH_SCHEMA)
    vecs = np.random.default_rng(5).standard_normal((20, 4)).astype(np.float32)
    s.new_txn().mutate_rdf(set_rdf="\n".join(
        f'<{hex(0x7000 + i)}> <emb> "{chip_smoke._vec_text(v)}"^^<xs:float32vector> .'
        for i, v in enumerate(vecs)), commit_now=True)
    return s, g


VEC_READ = '{ v(func: similar_to(emb, 3, "[0.1, 0.2, 0.3, 0.4]")) { uid } }'


@case
def restore_into_warm_server(m, tmp, mp):
    """A server serves (a)-(d) (the port: on the forced device path, its
    card operands cached), takes a full backup, commits on, and then the
    backup is restored into it: the newer commits stay, every answer is
    the one from before the restore, and the vector index holds each uid
    once."""
    s, g = _small_graph_server(m)
    plain0 = setop_rows.PLAIN_CALLS
    reads = {**chip_smoke.QUERIES, "v": VEC_READ}
    first = {name: _data(s, q) for name, q in reads.items()}
    bdir = str(tmp / "b")
    entry = m.bk.backup(s, bdir)
    flipped = [int(u) for u in np.intersect1d(g["hot"], g["l3"])[:3]]
    s.new_txn().mutate_rdf(set_rdf="\n".join(
        f'<{hex(u)}> <tag> "cold" .' for u in flipped), commit_now=True)
    s.new_txn().mutate_rdf(set_rdf='<0x7000> <emb> "[0.1, 0.2, 0.3, 0.4]"^^<xs:float32vector> .',
                           commit_now=True)
    before = {name: _data(s, q) for name, q in reads.items()}
    assert before["b"] != first["b"] and before["v"] != first["v"]
    assert m.bk.restore(s, bdir) == entry["records"]
    after = {name: _data(s, q) for name, q in reads.items()}
    assert after == before
    assert len(s.vector_indexes["emb"]) == 20
    if m is M["port"]:
        assert setop_rows.PLAIN_CALLS > plain0  # the set-op kernel ran, in its plain version
    return entry, after


@pytest.mark.parametrize("mode", ["serial", "batch"])
def test_subscriptions_run_before_vector_ingest(mode, monkeypatch):
    """A `similar_to` subscription re-runs on every commit to its
    predicate, before that commit's vector reaches the index (in both
    packages, on the serial path and behind a group-commit barrier): each
    callback shows the vectors of the commits before it, and a read after
    the commit shows them all. It fires on every touching commit, since
    the compared response carries the query's latencies."""
    monkeypatch.setenv("DGRAPH_TPU_GROUP_COMMIT", "0" if mode == "serial" else "1")
    monkeypatch.setenv("DGRAPH_TPU_GROUP_COMMIT_BYPASS", "0")
    got = {}
    for side in SIDES:
        m = M[side]
        s = m.Server()
        s.alter('emb: float32vector @index(hnsw(metric:"euclidean")) .')
        s.new_txn().mutate_rdf(set_rdf="\n".join(
            f'<{hex(0x10 + i)}> <emb> "[{5.0 + i}, {5.0 + i}]"^^<xs:float32vector> .'
            for i in range(4)), commit_now=True)
        fired = []
        m.subs.Subscriptions(s).subscribe(
            '{ q(func: similar_to(emb, 3, "[0.0, 0.0]")) { uid } }', fired.append)
        reads = []
        for j in range(3):
            s.new_txn().mutate_rdf(
                set_rdf=f'<{hex(0x100 + j)}> <emb> "[{0.1 * (j + 1)}, 0.0]"^^<xs:float32vector> .',
                commit_now=True)
            reads.append(_data(s, '{ q(func: similar_to(emb, 3, "[0.0, 0.0]")) { uid } }'))
        seen = [[o["uid"] for o in f["data"]["q"]] for f in fired]
        assert len(fired) == 4  # the snapshot, then one a commit
        assert seen[1] == seen[0]  # commit 0's own vector not yet in the index
        for j in range(1, 3):
            assert [u for u in seen[j + 1] if int(u, 16) >= 0x100] == [
                hex(0x100 + i) for i in range(j)]
            assert {hex(0x100 + i) for i in range(j + 1)} <= {o["uid"] for o in reads[j]["q"]}
        got[side] = seen, reads
    assert got["port"] == got["ref"]


# cross-package state


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_backup_restores_across_packages(direction, tmp_path):
    """A backup written by one package restores into the other, which
    then answers as the writer: the graph reads, a vector read, the
    schema."""
    src, dst = direction.split("_to_")
    s, _ = _small_graph_server(M[src])
    s.new_txn().mutate_rdf(set_rdf='<0x2> <tag> "fresh" .', commit_now=True)
    bdir = str(tmp_path / "b")
    M[src].bk.backup(s, bdir)
    s.new_txn().mutate_rdf(set_rdf='<0x3> <tag> "late" .', commit_now=True)
    M[src].bk.backup(s, bdir)
    r = M[dst].Server()
    M[dst].bk.restore(r, bdir)
    reads = {**chip_smoke.QUERIES, "v": VEC_READ,
             "tags": '{ q(func: has(tag), first: 5, orderdesc: tag) { uid tag } }'}
    for name, q in reads.items():
        assert _data(r, q) == _data(s, q), name
    assert sorted(r.schema.predicates()) == sorted(s.schema.predicates())


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("loader", ["bulk", "bulk2"])
def test_export_bulk_loads_across_packages(direction, loader, tmp_path):
    """An RDF export of one package, schema and data, bulk-loads into the
    other (by `bulk_load_rdf` or the parallel loader), which answers as
    the exporter."""
    src, dst = direction.split("_to_")
    s, _ = _small_graph_server(M[src])
    out = M[src].export.export(s, str(tmp_path / "x"), fmt="rdf")
    with gzip.open(out["data"], "rt") as f:
        rdf = f.read()
    with gzip.open(out["schema"], "rt") as f:
        schema = f.read()
    r = M[dst].Server()
    r.alter(schema)
    if loader == "bulk":
        M[dst].bulk.bulk_load_rdf(r, rdf)
    else:
        M[dst].bulk2.ParallelBulkLoader(r, workdir=str(tmp_path / "w"), workers=1).load_text(rdf)
    for name, q in {**chip_smoke.QUERIES, "v": VEC_READ}.items():
        assert _data(r, q) == _data(s, q), name


def test_parallel_bulk_loader_forks_beside_a_live_server(tmp_path):
    """`ParallelBulkLoader` with 2 workers forks its map workers while a
    port Server (serving, committing, its threads started) is alive; the
    vectors land in the index exactly, and both packages load the same
    store."""
    rng = np.random.default_rng(9)
    V = (rng.standard_normal((160, 768)) * 4).astype(np.float32)
    text = chip_smoke.vector_nquads(V, 0x100)
    assert chip_smoke.vector_nquads(V, 0x100, workers=2, step=64) == text
    stores = {}
    for side in SIDES:
        m = M[side]
        s, _ = _small_graph_server(m)
        s.alter(chip_smoke.SMALL_SCHEMA)
        ld = m.bulk2.ParallelBulkLoader(s, workdir=str(tmp_path / side), workers=2)
        assert not ld._native_ok() and len(ld._chunk([text])) > 1  # the forking path
        ld.load_text(text)
        assert ld.nquads == len(V)
        idx = s.vector_indexes["emb_small"]
        rows = [idx._rows[0x100 + i] for i in range(len(V))]
        np.testing.assert_array_equal(idx._vecs[rows], V)
        stores[side] = ({bytes(k): v for k, v in s.kv.iterate_versions(b"", 1 << 62)},
                        _data(s, chip_smoke.QUERIES["b"]),
                        _data(s, '{ q(func: similar_to(emb_small, 5, "%s")) { uid } }'
                              % chip_smoke._vec_text(V[7])))
    assert stores["port"] == stores["ref"]


def test_ops_phase_on_cpu(tmp_path, monkeypatch):
    """chip_smoke's phase 10 at a tiny size on the CPU, the kernels'
    plain versions standing in: every check of the phase holds."""
    monkeypatch.setenv("DGRAPH_TPU_VEC_QUANT", "0")
    rng = np.random.default_rng(3)
    V = (rng.standard_normal((300, 16)) * 3).astype(np.float32)
    Q = rng.standard_normal((16, 16)).astype(np.float32)
    out = chip_smoke.serve_ops("cpu", str(tmp_path), V, Q, fanout=6, pool=400, workers=2,
                               n_accounts=20, bank_threads=2, transfers_per_thread=5,
                               split_at=50, log=lambda m: None)
    assert out["subscriptions"]["b_fired"] == 20
    assert out["subscriptions"]["committed_vectors_seen"] == [0, 1, 2, 3, 4]
    assert out["cdc"]["undelivered"] > 0 and out["cdc"]["replayed"] >= out["cdc"]["undelivered"]
    assert out["rollup"]["cold_parts"] >= 2
    assert out["launches"]["setop_rows"] > 0 and out["launches"]["vector_topk"] > 0
    assert out["restore"]["launches"]["vector_topk"] >= 16
    assert out["restore"]["launches"]["setop_rows"] > 0 and out["captured"][0]


# ---------------------------------------------------------------------------
# running the cases
# ---------------------------------------------------------------------------

_REF = {}


def _run(name, side, tmp, mp):
    return json.dumps(CASES[name](M[side], tmp, mp), sort_keys=True, default=str)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case(name, side, tmp_path, tmp_path_factory, monkeypatch):
    """The reference test's contract on this side; the port's result
    equals the reference's, byte for byte."""
    got = _run(name, side, tmp_path, monkeypatch)
    if side == "ref":
        _REF[name] = got
        return
    if name not in _REF:
        with pytest.MonkeyPatch.context() as mp:
            _REF[name] = _run(name, "ref", tmp_path_factory.mktemp("ref"), mp)
    assert got == _REF[name]


@pytest.fixture(scope="module")
def movies():
    out = {}
    for side in SIDES:
        s = M[side].Server()
        s.alter(golden_movies.SCHEMA)
        M[side].bulk.bulk_load_rdf(s, golden_movies.RDF)
        out[side] = s
    return out


GOLDEN = [g for g in golden_movies.GOLDEN if g[2] is not None]


@pytest.mark.parametrize("name,query,want", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_golden_movies_through_bulk_load(movies, name, query, want):
    """test_golden_movies.py's goldens on a graph each package's
    `bulk_load_rdf` loaded: the port answers the golden, as the
    reference does."""
    ref = json.dumps(_data(movies["ref"], query), sort_keys=True)
    got = _data(movies["port"], query)
    assert got == want
    assert json.dumps(got, sort_keys=True) == ref
