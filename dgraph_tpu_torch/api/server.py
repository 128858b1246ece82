"""Embedded API front-end: the edgraph.Server equivalent, on one device.

Port of `dgraph_tpu/api/server.py`: `alter`, transactions that take RDF
and JSON mutations (`mutate_rdf`, `mutate_json`) and upsert blocks
(`upsert`, `upsert_json`), `query` and `query_rdf`, and commits through
group commit (worker/groupcommit.py; DGRAPH_TPU_GROUP_COMMIT=0 gives the
serial path). `Server(data_dir=...)` keeps its store on disk (the
WAL-backed in-memory store, or the SSTable store with
DGRAPH_TPU_STORAGE=lsm, optionally encrypted) and recovers the schema,
the timestamp and uid leases and the vector indexes when it opens one
again. Queries pass the serving front (serving/: the plan cache,
admission, the snapshot-keyed result cache, per-shape digests and the
cross-query micro-batcher, which folds concurrent plain `similar_to`
calls into one `search_batch`), then dql -> query.Executor -> the
streaming JSON encoder, with the set-op data plane on the dispatcher's
torch device. Commits and alters advance the snapshot watermark and
bump the front's epoch, so no cached plan or result outlives them.
Vector predicates (`float32vector @index(hnsw(...))`) get a
`models.vector.VectorIndex` on the same device, fed at commit and rebuilt
on restart. `enable_acl` / `enable_audit` / `login` bring the reference's
ACL (every entry point takes an `access_jwt`, whose namespace the
mutation walkers write into) and its audit log. Commits feed change
data capture (admin/cdc.py: `_cdc`, emitted in commit-ts order inside
the group-commit barrier, or inline on the serial path) and query
subscriptions (api/subscriptions.py: `_subscriptions`, re-run on the
committer's thread before the commit's vectors reach their index, in
the reference's order).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from dgraph_tpu_torch import dql
from dgraph_tpu_torch.acl.acl import READ, WRITE, AclError, AclManager
from dgraph_tpu_torch.admin.export import _schema_line
from dgraph_tpu_torch.audit.audit import AuditLog
from dgraph_tpu_torch.loaders.rdf import NQuad, parse_rdf
from dgraph_tpu_torch.posting import colwrite
from dgraph_tpu_torch.posting.lists import LocalCache, Txn, cache_tier_snapshot
from dgraph_tpu_torch.posting.memlayer import MemoryLayer
from dgraph_tpu_torch.posting.mutation import (
    DirectedEdge,
    apply_edge,
    apply_edges,
    delete_entity_attr,
    ingest_vectors,
)
from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET, encode_deltas
from dgraph_tpu_torch.query import dispatch
from dgraph_tpu_torch.query.functions import QueryBudgetError
from dgraph_tpu_torch.query.outputrdf import encode_rdf
from dgraph_tpu_torch.query.streamjson import encode_response_data
from dgraph_tpu_torch.query.subgraph import Executor
from dgraph_tpu_torch.schema.schema import State, parse_schema
from dgraph_tpu_torch.serving import ServingFront
from dgraph_tpu_torch.serving.digest import DIGESTS
from dgraph_tpu_torch.serving.resultcache import hit_response
from dgraph_tpu_torch.storage.kv import KV, open_kv
from dgraph_tpu_torch.types.types import TypeID, Val
from dgraph_tpu_torch.utils import hosttrace, observe
from dgraph_tpu_torch.utils.cmsketch import StatsHolder, feed_stats
from dgraph_tpu_torch.utils.observe import METRICS, TRACER, profile_scope
from dgraph_tpu_torch.worker.groupcommit import (
    GroupCommit,
    assign_verdicts,
    columnar_writes,
    commit_phase_ns,
)
from dgraph_tpu_torch.x import config, keys
from dgraph_tpu_torch.zero.zero import ZeroLite

# The stream encoder's row counters (query/streamjson.py), declared here
# because utils/observe.py is kept equal to the JAX package's registry.
observe.declare_metric(
    "counter", "stream_encode_column_rows_total",
    "Result rows the streaming encoder printed column by column: every "
    "child of the list's node has a column (the uid, count(pred), a "
    "scalar value) (query/streamjson.py).",
)
observe.declare_metric(
    "counter", "stream_encode_entity_rows_total",
    "Result rows the streaming encoder printed one entity at a time: a "
    "child needs the entity path (a uid predicate, math, val(), a list "
    "or language value) (query/streamjson.py).",
)
# The vector index's scan counters (models/vector.py), declared here for
# the same reason.
observe.declare_metric(
    "counter", "vector_rows_scanned_total",
    "Rows the vector index scored: each probed slab's 128 rows on the IVF "
    "tier, the live rows on a full scan, the rows the quantized scans "
    "read (models/vector.py).",
)
observe.declare_metric(
    "counter", "vector_slabs_probed_total",
    "Slabs of 128 rows the vector index's IVF tier probed on the device "
    "(models/vector.py).",
)


class TxnHandle:
    """Client-side transaction handle (dgo Txn equivalent)."""

    def __init__(self, server: "Server", read_only: bool = False):
        self.server = server
        self.start_ts = server.zero.begin_txn()
        self.txn = Txn(server.kv, self.start_ts, mem=server.mem)
        self.read_only = read_only
        self.finished = False
        if not read_only:
            colwrite.maybe_enable(self.txn, server)

    def query(self, q: str, access_jwt: Optional[str] = None) -> dict:
        """Query within this txn's snapshot (sees own uncommitted writes)."""
        self.txn.materialize_cols()  # read-your-writes over columns
        blocks = dql.parse(q)
        ns = keys.GALAXY_NS
        allowed = None
        if self.server.acl is not None:
            if access_jwt is None:
                raise AclError("no access token (ACL enabled)")
            claims = self.server.acl.claims(access_jwt)
            ns = int(claims.get("namespace", 0))
            self.server.acl.authorize_preds(
                access_jwt, _query_preds(blocks), READ, claims=claims
            )
            allowed = self.server.acl.readable_preds(claims)
        return self.server._query_parsed(blocks, self.txn.cache, ns, allowed)

    def mutate_rdf(
        self,
        set_rdf: str = "",
        del_rdf: str = "",
        commit_now: bool = False,
        access_jwt: Optional[str] = None,
    ) -> Dict[str, str]:
        set_nqs, del_nqs = parse_rdf(set_rdf), parse_rdf(del_rdf)
        body = f"set:{set_rdf!r} del:{del_rdf!r}"
        ns, user = self.server._authorize_mutation(
            access_jwt,
            sorted({nq.predicate for nq in set_nqs + del_nqs}),
            body,
        )
        self.txn.tenant_ns = ns  # per-tenant commit SLO slice
        uids = self.server._apply_nquads(self.txn, set_nqs, del_nqs, ns)
        if commit_now:
            self.commit()
        return uids

    def mutate_json(
        self,
        set_obj=None,
        del_obj=None,
        commit_now: bool = False,
        access_jwt: Optional[str] = None,
    ):
        if self.server.acl is None and self.server.audit is None:
            # the common unsecured path: computing the predicate set
            # and dumping the audit body would be pure waste per write
            ns = keys.GALAXY_NS
        else:
            body = json.dumps(
                {"set": set_obj, "delete": del_obj}, default=str
            )
            ns, _ = self.server._authorize_mutation(
                access_jwt,
                sorted(_json_preds(set_obj) | _json_preds(del_obj)),
                body,
            )
        self.txn.tenant_ns = ns  # per-tenant commit SLO slice
        uids = self.server._apply_json(self.txn, set_obj, del_obj, ns)
        if commit_now:
            self.commit()
        return uids

    def _upsert_prologue(
        self, query: str, mutation_preds_fn, access_jwt: Optional[str]
    ):
        """Shared upsert front half: ACL (READ on query preds, WRITE on
        mutation preds, JWT namespace) + query execution binding
        uid/val vars. `mutation_preds_fn` is called only when ACL is on
        (computing preds means parsing the mutation — skip it for the
        common unsecured path). Returns (ns, uid_vars, val_vars)."""
        blocks = dql.parse(query) if query.strip() else []
        ns = keys.GALAXY_NS
        if self.server.acl is not None:
            if access_jwt is None:
                raise AclError("no access token (ACL enabled)")
            claims = self.server.acl.claims(access_jwt)
            ns = int(claims.get("namespace", 0))
            self.server.acl.authorize_preds(
                access_jwt, _query_preds(blocks), READ, claims=claims
            )
            self.server.acl.authorize_preds(
                access_jwt, sorted(mutation_preds_fn()), WRITE,
                claims=claims,
            )
        uid_vars: Dict[str, List[int]] = {}
        val_vars: Dict[str, dict] = {}
        if blocks:
            self.txn.materialize_cols()  # upsert query reads own writes
            ex = Executor(
                self.txn.cache,
                self.server.schema,
                ns=ns,
                vector_indexes=self.server.vector_indexes,
            )
            ex.process(blocks)
            uid_vars = {
                k: [int(u) for u in v] for k, v in ex.uid_vars.items()
            }
            val_vars = ex.val_vars
        return ns, uid_vars, val_vars

    def upsert(
        self,
        query: str,
        set_rdf: str = "",
        del_rdf: str = "",
        cond: Optional[str] = None,
        commit_now: bool = True,
        access_jwt: Optional[str] = None,
    ) -> Dict[str, str]:
        """Upsert block: run query, substitute uid(v)/val(v) refs in the
        mutation, apply (ref edgraph/server.go:874 buildUpsertQuery +
        dql upsert blocks). `cond` is '@if(eq(len(v), 0))'-style gate."""
        def mpreds():
                return {
                nq.predicate for nq in parse_rdf(set_rdf) + parse_rdf(del_rdf)
            }

        ns, uid_vars, val_vars = self._upsert_prologue(
            query, mpreds, access_jwt
        )
        if cond is not None and not _eval_cond(cond, uid_vars):
            if commit_now:
                self.commit()
            return {}

        out = self.server._apply_rdf_with_vars(
            self.txn, set_rdf, del_rdf, uid_vars, val_vars, ns=ns
        )
        if commit_now:
            self.commit()
        return out

    def upsert_json(
        self,
        query: str,
        mutations: List[dict],
        commit_now: bool = True,
        access_jwt: Optional[str] = None,
    ) -> Dict[str, str]:
        """Multi-mutation JSON upsert: one query block binding uid vars,
        then a list of {"set": obj, "delete": obj, "cond": "@if(...)"}
        mutations applied against those bindings (ref edgraph/server.go
        doQuery with req.Mutations[] — the shape the GraphQL rewriters
        emit, graphql/resolve/mutation_rewriter.go UpsertMutation)."""
        def mpreds():
            return {
                p
                for m in mutations
                for p in (
                    _json_preds(m.get("set"))
                    | _json_preds(m.get("delete"))
                )
            }

        ns, uid_vars, val_vars = self._upsert_prologue(
            query, mpreds, access_jwt
        )
        blanks: Dict[str, int] = {}  # blank-node map SHARED across the
        # request's mutations (ref: one AssignUids per request)
        for m in mutations:
            cond = m.get("cond")
            if cond and not _eval_cond(cond, uid_vars):
                continue
            self.server._apply_json_with_vars(
                self.txn, m.get("set"), m.get("delete"), uid_vars,
                ns=ns, blank=blanks, val_vars=val_vars,
            )
        if commit_now:
            self.commit()
        return {k[2:]: hex(v) for k, v in blanks.items()}

    def commit(self) -> int:
        if self.finished:
            raise RuntimeError("transaction already finished")
        self.finished = True
        return self.server._commit(self.txn)

    def discard(self):
        self.finished = True
        self.server.zero.abort(self.start_ts)


class Server:
    """Single-node engine (Alpha + embedded Zero-lite) serving from one
    torch device. `device="cuda"` (the default) binds the set-op
    dispatcher to the card and raises when there is none; the tests pass
    `device="cpu"`. The dispatcher is process-wide, so one process
    serves from one device: the last Server built sets it. `data_dir`
    keeps the store on disk and recovers what it holds (None: in
    memory); `encryption_key` seals it at rest."""

    def __init__(
        self,
        device="cuda",
        data_dir: Optional[str] = None,
        encryption_key: Optional[bytes] = None,
    ):
        dispatch.DISPATCHER.bind(device)
        self.device = dispatch.DISPATCHER.device
        self.kv: KV = open_kv(data_dir, encryption_key=encryption_key)
        self.zero = ZeroLite()
        self.schema = State()
        # predicate -> models.vector.VectorIndex on self.device
        self.vector_indexes: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._group_commit = None  # lazy (worker/groupcommit.py)
        # slow-query threshold (instance override of the registry knob)
        self.slow_query_ms = float(config.get("SLOW_QUERY_MS"))
        self.mem = MemoryLayer()  # shared decoded-list read cache
        self.stats = StatsHolder()  # selectivity stats (fed on commit)
        self.acl = None  # enabled via enable_acl() (ref --acl superflag)
        self.audit = None  # enabled via enable_audit()
        # the serving front: plan cache + cross-query micro-batcher +
        # admission + result cache (serving/). _snapshot_ts is the
        # batcher's snapshot watermark: the last commit made VISIBLE
        # (published before zero.applied, the barrier read_ts waits
        # on), so two fresh read timestamps covering the same watermark
        # coalesce.
        self._snapshot_ts = 0
        self.serving = ServingFront(
            stats=self.stats,
            schema_fn=lambda: self.schema,
            last_commit_fn=lambda: self._snapshot_ts,
        )
        self._bootstrap_schema()
        if data_dir is not None:
            self._load_persisted_state()
        if config.get("TRACE"):
            # the collector's pauses, published at the end of every read
            hosttrace.install_gc_hook()
        # warm the native C++ layer off the request path (first import
        # compiles codec.cpp; without this the first query/rollup pays it)
        threading.Thread(
            target=lambda: __import__("dgraph_tpu_torch.native"), daemon=True
        ).start()

    # -- security (ref edgraph/access.go; audit/) -----------------------------

    def enable_acl(self, secret: Optional[bytes] = None, groot_password="password"):
        self.acl = AclManager(self, secret)
        self.acl.bootstrap(groot_password=groot_password)
        return self.acl

    def enable_audit(self, out_dir: str, key: Optional[bytes] = None):
        self.audit = AuditLog(out_dir, key=key)
        return self.audit

    def login(self, user: str, password: str, ns: int = keys.GALAXY_NS):
        if self.acl is None:
            raise RuntimeError("ACL not enabled")
        try:
            out = self.acl.login(user, password, ns)
            self._audit("login", user=user, ns=ns)
            return out
        except Exception:
            self._audit("login", user=user, ns=ns, status="DENIED")
            raise

    def _audit(self, endpoint, user="", ns=0, body="", status="OK"):
        if self.audit is not None:
            self.audit.record(endpoint, user=user, ns=ns, body=body, status=status)

    def _authorize(self, access_jwt, preds, need) -> int:
        """Returns the caller's namespace (0 when ACL off)."""
        if self.acl is None:
            return keys.GALAXY_NS
        if access_jwt is None:
            raise AclError("no access token (ACL enabled)")
        claims = self.acl.claims(access_jwt)
        self.acl.authorize_preds(access_jwt, preds, need)
        return int(claims.get("namespace", 0))

    def _authorize_mutation(self, access_jwt, preds, audit_body):
        """WRITE authorization + audit for any mutation entry point.
        Returns (namespace, user)."""
        ns, user = keys.GALAXY_NS, ""
        if self.acl is not None:
            try:
                if access_jwt is None:
                    raise AclError("no access token (ACL enabled)")
                claims = self.acl.claims(access_jwt)
                user = claims.get("userid", "")
                ns = int(claims.get("namespace", 0))
                self.acl.authorize_preds(
                    access_jwt, preds, WRITE, claims=claims
                )
            except Exception:
                self._audit(
                    "mutate", user=user, body=audit_body, status="DENIED"
                )
                raise
        self._audit("mutate", user=user, ns=ns, body=audit_body)
        return ns, user

    def _apply_nquads(self, txn, set_nqs, del_nqs, ns) -> Dict[str, str]:
        blank: Dict[str, int] = {}
        fresh_uids: set = set()  # uids leased by THIS request

        def resolve(ref: str) -> int:
            if ref.startswith("_:"):
                if ref not in blank:
                    blank[ref] = self.zero.assign_uids(1)
                    fresh_uids.add(blank[ref])
                return blank[ref]
            if ref.startswith("0x"):
                return int(ref, 16)
            return int(ref)

        # batched application: plain edges accumulate and flush through
        # apply_edges (bulk reads + bulk tokens); a star delete flushes
        # first so it observes every edge that preceded it in order
        pending: List[DirectedEdge] = []

        def flush():
            if pending:
                apply_edges(txn, self.schema, pending)
                pending.clear()

        for nqs, op in ((set_nqs, OP_SET), (del_nqs, OP_DEL)):
            for nq in nqs:
                if nq.star:
                    if op != OP_DEL:
                        raise ValueError("S P * only valid in delete")
                    flush()
                    delete_entity_attr(
                        txn, self.schema, resolve(nq.subject),
                        nq.predicate, ns,
                    )
                    continue
                e = self._nquad_edge(nq, resolve, op, ns=ns)
                e.fresh = e.entity in fresh_uids
                pending.append(e)
        flush()
        return {k[2:]: hex(v) for k, v in blank.items()}

    def _bootstrap_schema(self):
        # system predicates (ref schema/schema.go initialSchema)
        for su in parse_schema(
            "dgraph.type: [string] @index(exact) .\n"
            "dgraph.xid: string @index(exact) .\n"
        )[0]:
            self.schema.set(su)

    def _load_persisted_state(self):
        """Recover schema + max ts/uid from the KV after restart (ref
        schema load in schema/schema.go LoadFromDb; Zero state from raft)."""
        max_ts = 0
        max_uid = 0
        for key, vers in self.kv.iterate_versions(b"", (1 << 62)):
            if vers:
                max_ts = max(max_ts, vers[0][0])
            try:
                pk = keys.parse_key(key)
            except Exception:
                continue  # non-graph meta keys (e.g. namespace counter)
            if pk.uid is not None:
                max_uid = max(max_uid, pk.uid)
            if pk.is_schema:
                preds, _ = parse_schema(vers[0][1].decode("utf-8"))
                for su in preds:
                    self.schema.set(su)
                    if su.vector_specs:
                        self._ensure_vector_index(su)
            elif pk.is_type:
                _, types = parse_schema(vers[0][1].decode("utf-8"))
                for tu in types:
                    self.schema.set_type(tu)
        while self.zero.max_assigned < max_ts:
            self.zero.next_ts(max_ts - self.zero.max_assigned)
        # re-lease uids past everything on disk, or fresh blank nodes would
        # reuse (and overwrite) existing entities' uids
        if max_uid and max_uid < (1 << 62) and self.zero._max_uid <= max_uid:
            self.zero.assign_uids(max_uid - self.zero._max_uid)
        # seed the snapshot watermark past everything recovered, so
        # watermark reads see the restored store from the first query
        self._snapshot_ts = max(self._snapshot_ts, self.zero.read_ts())
        self.rebuild_vector_indexes()

    def carry(self, kv_blob: bytes, schema_text: str, max_uid: int, max_ts: int):
        """Take over a store: the bytes of a `MemKV.dump_bytes()`, the
        schema text it was written under (every predicate, including the
        ones its mutations created), and Zero's lease watermarks. The
        store is installed as it is; the schema is applied to the
        in-memory state only, since the store already holds its records."""
        self.kv.load_bytes(kv_blob)
        preds, types = parse_schema(schema_text)
        for su in preds:
            self.schema.set(su)
        for tu in types:
            self.schema.set_type(tu)
        if max_ts > self.zero.max_assigned:
            self.zero.next_ts(max_ts - self.zero.max_assigned)
        if max_uid > self.zero._max_uid:
            self.zero.assign_uids(max_uid - self.zero._max_uid)
        self._snapshot_ts = max(self._snapshot_ts, self.zero.read_ts())
        self.mem.invalidate_prefix([b""])
        self.rebuild_vector_indexes()

    def rebuild_vector_indexes(self):
        """Re-ingest stored vectors into the in-memory vector indexes
        (ref posting/index.go:1354 vector-index rebuild prefixes)."""
        ts = self.zero.read_ts()
        read = LocalCache(self.kv, ts)
        for pred in self.schema.predicates():
            su = self.schema.get(pred)
            if not su or not su.vector_specs:
                continue
            self._ensure_vector_index(su)
            vidx = self.vector_indexes[pred]
            for k, _, _ in self.kv.iterate(keys.DataPrefix(pred), ts):
                pk = keys.parse_key(k)
                for p in read.values(k):
                    vidx.insert(pk.uid, p.val().value)

    def _ensure_vector_index(self, su):
        """A vector index for the predicate, on the server's device."""
        from dgraph_tpu_torch.models.vector import VectorIndex

        if su.predicate not in self.vector_indexes:
            self.vector_indexes[su.predicate] = VectorIndex(
                pred=su.predicate,
                metric=su.vector_specs[0].metric,
                device=self.device,
            )

    # -- alter (ref edgraph/server.go:355) -----------------------------------

    def alter(self, schema_text: str = "", drop_attr: str = "", drop_all: bool = False):
        self.serving.on_commit()  # schema changes invalidate cached plans
        try:
            return self._alter_inner(schema_text, drop_attr, drop_all)
        finally:
            # alters write outside the txn/applied barrier: advance the
            # watermark past every read_ts allocated during the alter,
            # so queries that raced the (non-transactional) schema
            # writes never coalesce with, or hit the results of,
            # post-alter traffic
            self._snapshot_ts = max(
                self._snapshot_ts, self.zero.next_ts()
            )

    def _alter_inner(self, schema_text, drop_attr, drop_all):
        with self._lock:
            if drop_all:
                # wipe every key (data + persisted schema/types)
                self.kv.drop_prefix(b"")
                self.schema = State()
                self._bootstrap_schema()
                self.vector_indexes.clear()
                return
            if drop_attr:
                self.kv.drop_prefix(keys.PredicatePrefix(drop_attr))
                self.kv.drop_prefix(keys.SplitPredicatePrefix(drop_attr))
                self.kv.drop_prefix(keys.SchemaKey(drop_attr))
                self.schema.delete(drop_attr)
                self.vector_indexes.pop(drop_attr, None)
                return
            preds, types = parse_schema(schema_text)
            ts = self.zero.next_ts()
            for su in preds:
                old = self.schema.get(su.predicate)
                self.schema.set(su)
                self.kv.put(
                    keys.SchemaKey(su.predicate),
                    ts,
                    _schema_line(su).encode("utf-8"),
                )
                if su.vector_specs:
                    self._ensure_vector_index(su)
                if old is not None and (
                    old.tokenizers != su.tokenizers
                ):
                    self._reindex(su)
            for tu in types:
                self.schema.set_type(tu)
                fields = "\n  ".join(tu.fields)
                self.kv.put(
                    keys.TypeKey(tu.name),
                    ts,
                    f"type {tu.name} {{\n  {fields}\n}}\n".encode("utf-8"),
                )

    def bump_snapshot(self) -> int:
        """Advance the snapshot watermark past every timestamp leased
        so far. Direct-KV writers that bypass the commit path (bulk
        loaders, the namespace counter) MUST call this after their
        writes land, or watermark reads would never see them; commits
        and alters advance it themselves. Returns the new watermark.
        max()-guarded like every other watermark writer: a commit
        leased after our read_ts may publish a larger watermark before
        this assignment runs."""
        self._snapshot_ts = max(self._snapshot_ts, self.zero.read_ts())
        return self._snapshot_ts

    def _reindex(self, su):
        """Full index rebuild for a predicate (ref posting/index.go:1115
        IndexRebuild): drop index range, re-tokenize all values."""
        from dgraph_tpu_torch.posting.pl import Posting, encode_delta
        from dgraph_tpu_torch.tok.tok import build_tokens

        pred = su.predicate
        self.kv.drop_prefix(keys.IndexPrefix(pred))
        ts = self.zero.next_ts()
        read = LocalCache(self.kv, ts)
        tokenizers = su.tokenizer_objs()
        if not tokenizers:
            return
        # aggregate uids per index key: entities sharing a token must land
        # in ONE record, since MemKV overwrites same-(key, ts) versions
        by_key: Dict[bytes, set] = {}
        for k, _, _ in self.kv.iterate(keys.DataPrefix(pred), ts):
            pk = keys.parse_key(k)
            for p in read.values(k):
                for tokb in build_tokens(p.val(), tokenizers):
                    by_key.setdefault(keys.IndexKey(pred, tokb), set()).add(pk.uid)
        self.kv.put_batch(
            (
                ikey,
                ts,
                encode_delta([Posting(uid=u, op=OP_SET) for u in sorted(uids)]),
            )
            for ikey, uids in by_key.items()
        )

    # -- transactions ---------------------------------------------------------

    def new_txn(self, read_only: bool = False) -> TxnHandle:
        return TxnHandle(self, read_only)

    def _commit(self, txn: Txn) -> int:
        # a commit-time consumer of Posting objects that appeared after
        # txn creation (CDC sink, subscription, vector index) forces
        # collected columns back to the serial representation
        colwrite.commit_guard(txn, self)
        # admission costs writes too: a commit charges the same
        # in-flight token budget queries draw from (retryable 429 over
        # budget; no-op with DGRAPH_TPU_ADMISSION off)
        ticket = self.serving.admit_write(txn.pending_postings())
        t_commit0 = time.monotonic()
        try:
            if not bool(config.get("GROUP_COMMIT")):
                # escape hatch (DGRAPH_TPU_GROUP_COMMIT=0): the serial
                # per-txn path, byte-for-byte
                commit_ts = self._commit_serial(txn)
            else:
                gc = self._group_commit
                if gc is None:
                    with self._lock:
                        gc = self._group_commit
                        if gc is None:
                            gc = self._group_commit = GroupCommit(
                                self._gc_propose, serial_fn=self._gc_serial
                            )
                with METRICS.timer("commit_latency_seconds"):
                    commit_ts = gc.commit(txn)
                if not getattr(txn, "gc_bypassed", False):
                    # the bypass ran the serial path, whose inline
                    # post-commit work already happened
                    self._post_commit(txn, commit_ts)
            # counted for both arms, only on success: postings WRITTEN
            # (the columnar kernel reports its exact count)
            METRICS.inc(
                "mutation_edges_total",
                sum(len(p) for p in txn.cache.deltas.values())
                + getattr(txn, "col_nposts", 0),
            )
            # per-tenant SLO slice: mutate paths stamp the resolved
            # namespace onto the txn
            observe.note_tenant(
                "commit",
                getattr(txn, "tenant_ns", keys.GALAXY_NS),
                time.monotonic() - t_commit0,
            )
            return commit_ts
        finally:
            self.serving.release_write(ticket)

    def _gc_propose(self, members):
        """Group-commit propose phase (batch leader's thread): ONE
        oracle exchange decides every member, then all committed
        members' deltas land under ONE lock hold. Returns the apply
        barrier (watermark + zero.applied in commit-ts order)."""
        with TRACER.span("commit", batch=len(members)):
            t0 = time.perf_counter_ns()
            committed = assign_verdicts(
                members,
                self.zero.commit_batch(
                    [
                        (m.txn.start_ts, m.txn.conflict_keys)
                        for m in members
                    ],
                    track=True,
                ),
            )
            t1 = time.perf_counter_ns()
            try:
                # encode OUTSIDE the lock (columnar members through ONE
                # batch_apply call, which must precede encode_deltas: a
                # materialized fallback lands in cache.deltas), then all
                # batch members' writes land in ONE put_batch
                col_writes = columnar_writes(committed)
                writes = []
                for m in committed:
                    cts = m.commit_ts
                    for key, recb, _attr in col_writes.get(m, ()):
                        writes.append((key, cts, recb))
                    for key, recb in encode_deltas(m.txn.cache.deltas):
                        writes.append((key, cts, recb))
                with self._lock:
                    self.kv.put_batch(writes)
            except Exception as e:
                # NEVER raise past the oracle: the verdicts are tracked
                # pending, and only the barrier below clears them
                for m in committed:
                    if m.error is None:
                        m.error = e
            commit_phase_ns(
                oracle=t1 - t0, propose=time.perf_counter_ns() - t1
            )

        def barrier():
            tb = time.perf_counter_ns()
            try:
                with self._lock:
                    for m in committed:
                        # watermark BEFORE the apply barrier, advanced
                        # in commit-ts order (members cts-ascending,
                        # barriers FIFO)
                        self._snapshot_ts = max(
                            self._snapshot_ts, m.commit_ts
                        )
                        self.zero.applied(m.commit_ts)
                # CDC rides the FIFO barrier, not _post_commit: members
                # here are commit-ts ascending and barriers run in
                # ticket order, so the sink stream stays strictly
                # commit-ts ordered even across batches
                cdc = getattr(self, "_cdc", None)
                if cdc is not None:
                    for m in committed:
                        if m.error is None:
                            cdc.emit_commit(
                                m.commit_ts, m.txn.cache.deltas
                            )
            finally:
                ok = 0
                for m in committed:
                    # a commit must never leave a stale operand on the
                    # card: the memory layer drops the dispatcher's
                    # cached device copies too
                    self.mem.invalidate(m.txn.cache.deltas.keys())
                    ck = getattr(m.txn, "col_keys", None)
                    if ck:
                        self.mem.invalidate(ck)
                    if m.error is None:
                        ok += 1
                if ok:
                    METRICS.inc("num_commits", ok)
                    self.serving.on_commit()  # ONE epoch bump per batch
                commit_phase_ns(apply=time.perf_counter_ns() - tb)

        return barrier

    def _post_commit(self, txn: Txn, commit_ts: int) -> None:
        """Per-txn post-commit work on the committer's own thread (stats
        feed, subscriptions, vector ingest): everything after the apply
        barrier that doesn't need batch ordering. CDC emits in the
        barrier."""
        self._feed_stats(txn.cache.deltas)
        colwrite.feed_col_stats(self.stats, txn)
        subs = getattr(self, "_subscriptions", None)
        if subs is not None:
            subs.on_commit(txn.cache.deltas)
        ingest_vectors(self.vector_indexes, txn.cache.deltas)

    def _gc_serial(self, txn: Txn) -> int:
        """Adaptive group-commit bypass target (worker/groupcommit.py):
        the serial path minus its own latency timer (gc.commit's caller
        already runs one), with the txn marked so _commit skips the
        batch-path _post_commit: the serial path does that work inline."""
        txn.gc_bypassed = True
        return self._commit_serial(txn, timed=False)

    def _commit_serial(self, txn: Txn, timed: bool = True) -> int:
        # serialized: MemKV is single-writer, and readers must not see a
        # commit_ts whose deltas aren't written yet
        with TRACER.span("commit"), (
            METRICS.timer("commit_latency_seconds")
            if timed
            else contextlib.nullcontext()
        ), self._lock:
            t0 = time.perf_counter_ns()
            commit_ts = self.zero.commit(txn.start_ts, txn.conflict_keys, track=True)
            t1 = time.perf_counter_ns()
            try:
                txn.write_deltas(self.kv, commit_ts)
            finally:
                t2 = time.perf_counter_ns()
                # watermark BEFORE the apply barrier: any read_ts
                # allocated after this commit becomes visible observes
                # the advanced watermark
                self._snapshot_ts = max(self._snapshot_ts, commit_ts)
                self.zero.applied(commit_ts)
                commit_phase_ns(
                    oracle=t1 - t0,
                    propose=t2 - t1,
                    apply=time.perf_counter_ns() - t2,
                )
        METRICS.inc("num_commits")
        # a commit must never leave a stale operand on the card: the
        # memory layer drops the dispatcher's cached device copies too
        self.mem.invalidate(txn.cache.deltas.keys())
        ck = getattr(txn, "col_keys", None)
        if ck:
            self.mem.invalidate(ck)
        self.serving.on_commit()  # commit-epoch plan invalidation
        self._feed_stats(txn.cache.deltas)
        colwrite.feed_col_stats(self.stats, txn)
        cdc = getattr(self, "_cdc", None)
        if cdc is not None:
            cdc.emit_commit(commit_ts, txn.cache.deltas)
        subs = getattr(self, "_subscriptions", None)
        if subs is not None:
            subs.on_commit(txn.cache.deltas)
        # vector index ingestion at commit (factory seam)
        ingest_vectors(self.vector_indexes, txn.cache.deltas)
        return commit_ts

    def _feed_stats(self, deltas):
        """Count index-key postings into the cm-sketch (ref posting/stats
        collection feeding planForEqFilter)."""
        feed_stats(self.stats, deltas)

    # -- mutations -------------------------------------------------------------

    def _apply_rdf(
        self, txn: Txn, set_rdf: str, del_rdf: str, ns: int = keys.GALAXY_NS
    ) -> Dict[str, str]:
        return self._apply_nquads(
            txn, parse_rdf(set_rdf), parse_rdf(del_rdf), ns
        )

    def _apply_rdf_with_vars(
        self, txn: Txn, set_rdf: str, del_rdf: str, uid_vars, val_vars,
        ns: int = keys.GALAXY_NS,
    ) -> Dict[str, str]:
        """RDF application where subjects/objects may be uid(v) refs and
        values val(v) refs; the mutation fans out over the var's uids
        (ref dql upsert semantics)."""
        blank: Dict[str, int] = {}

        def resolve_many(ref: str) -> List[int]:
            if ref.startswith("uid("):
                var = ref[4:-1]
                return uid_vars.get(var, [])
            if ref.startswith("_:"):
                if ref not in blank:
                    blank[ref] = self.zero.assign_uids(1)
                return [blank[ref]]
            return [int(ref, 16) if ref.startswith("0x") else int(ref)]

        def apply_all(rdf: str, op: int):
            for nq in parse_rdf(rdf):
                for subj in resolve_many(nq.subject):
                    if nq.object_id and nq.object_id.startswith("val("):
                        # val(v): per-subject value substitution
                        var = nq.object_id[4:-1]
                        v = val_vars.get(var, {}).get(subj)
                        if v is None:
                            continue
                        apply_edge(
                            txn,
                            self.schema,
                            DirectedEdge(
                                subj, nq.predicate, value=v,
                                facets=nq.facets, op=op, ns=ns,
                            ),
                        )
                        continue
                    objs = (
                        resolve_many(nq.object_id) if nq.object_id else [None]
                    )
                    for obj in objs:
                        self._apply_nquad(
                            txn, nq, None, op, subj_uid=subj, obj_uid=obj,
                            ns=ns,
                        )

        apply_all(set_rdf, OP_SET)
        apply_all(del_rdf, OP_DEL)
        return {k[2:]: hex(v) for k, v in blank.items()}

    def _nquad_edge(
        self,
        nq: NQuad,
        resolve,
        op: int,
        subj_uid: Optional[int] = None,
        obj_uid: Optional[int] = None,
        ns: int = keys.GALAXY_NS,
    ) -> DirectedEdge:
        """Build the DirectedEdge for one (non-star) N-Quad."""
        subj = subj_uid if subj_uid is not None else resolve(nq.subject)
        if nq.object_id:
            return DirectedEdge(
                subj,
                nq.predicate,
                value_id=obj_uid if obj_uid is not None else resolve(nq.object_id),
                facets=nq.facets,
                op=op,
                ns=ns,
            )
        return DirectedEdge(
            subj,
            nq.predicate,
            value=nq.object_value,
            lang=nq.lang,
            facets=nq.facets,
            op=op,
            ns=ns,
        )

    def _apply_nquad(
        self,
        txn: Txn,
        nq: NQuad,
        resolve,
        op: int,
        subj_uid: Optional[int] = None,
        obj_uid: Optional[int] = None,
        ns: int = keys.GALAXY_NS,
    ):
        """Apply one N-Quad. Callers either pass a `resolve` function or
        pre-resolved subject/object uids (the upsert fan-out path — pinned
        by role, so `uid(v) <p> uid(v)` self-pairs resolve correctly)."""
        if nq.star:
            if op != OP_DEL:
                raise ValueError("S P * only valid in delete")
            subj = subj_uid if subj_uid is not None else resolve(nq.subject)
            delete_entity_attr(txn, self.schema, subj, nq.predicate, ns)
            return
        edge = self._nquad_edge(
            nq, resolve, op, subj_uid=subj_uid, obj_uid=obj_uid, ns=ns
        )
        apply_edge(txn, self.schema, edge)

    def _apply_json(
        self, txn: Txn, set_obj, del_obj, ns: int = keys.GALAXY_NS
    ) -> Dict[str, str]:
        """JSON mutation format (ref chunker/json_parser.go): nested
        objects with "uid" refs; blank nodes via "_:name". Delegates to
        the var-aware walker (no vars bound) so set/delete semantics —
        schema-typed conversion, bare-uid node deletes, null-predicate
        deletes — stay in one place."""
        return self._apply_json_with_vars(txn, set_obj, del_obj, {}, ns=ns)

    def _node_type_preds(self, txn: Txn, uid: int, ns=keys.GALAXY_NS):
        """Predicates expanded from the node's dgraph.type definitions
        (ref worker/mutation.go expandEdges for S * * deletes)."""
        tkey = keys.DataKey("dgraph.type", uid, ns)
        preds = []
        for p in txn.cache.values(tkey):
            tu = self.schema.get_type(str(p.val().value))
            if tu is not None:
                preds.extend(tu.fields)
        return preds

    def _apply_json_with_vars(
        self, txn: Txn, set_obj, del_obj, uid_vars,
        ns: int = keys.GALAXY_NS, blank: Optional[Dict[str, int]] = None,
        val_vars: Optional[Dict[str, dict]] = None,
    ) -> Dict[str, str]:
        """JSON mutations whose uid refs may be upsert vars — the format
        the reference's GraphQL mutation rewriters emit (setjson /
        deletejson with "uid(x)" refs and @if conds, ref
        graphql/resolve/mutation_rewriter.go + edgraph doMutate var
        expansion). Values convert by schema type (geo dicts, datetimes),
        a bare {"uid": U} in delete drops the whole node (S * *), and a
        null field value in delete drops the predicate (S P *)."""
        blank = blank if blank is not None else {}

        fresh_uids: set = set()  # uids leased by THIS request

        def resolve_many(ref) -> List[int]:
            if isinstance(ref, int):
                return [ref]
            if ref.startswith("uid("):
                return list(uid_vars.get(ref[4:-1], []))
            if ref.startswith("_:"):
                if ref not in blank:
                    blank[ref] = self.zero.assign_uids(1)
                    fresh_uids.add(blank[ref])
                return [blank[ref]]
            return [int(ref, 16) if ref.startswith("0x") else int(ref)]

        def to_val(su, v) -> Val:
            # (geo dicts never reach here — walk() routes them through
            # is_geo_literal directly; `su` is the caller's schema
            # entry — one lookup per field, not one per item)
            tid = su.value_type if su is not None else None
            if tid == TypeID.DATETIME:
                from dgraph_tpu_torch.types.types import parse_datetime

                return Val(TypeID.DATETIME, parse_datetime(str(v)))
            if tid == TypeID.PASSWORD:
                from dgraph_tpu_torch.types.types import convert

                return convert(Val(TypeID.STRING, str(v)), TypeID.PASSWORD)
            if tid == TypeID.VFLOAT and isinstance(v, list):
                return Val(TypeID.VFLOAT, np.asarray(v, dtype=np.float32))
            return _json_to_val(v)

        def is_geo_literal(v) -> bool:
            return (
                isinstance(v, dict)
                and "coordinates" in v
                and v.get("type")
                in ("Point", "Polygon", "MultiPolygon", "MultiPoint")
            )

        # batched application: edges accumulate and flush through
        # apply_edges (bulk reads + bulk tokens, posting/mutation.py);
        # every delete flushes first so it observes the edges that
        # preceded it in walk order
        pending: List[DirectedEdge] = []

        def flush():
            if pending:
                apply_edges(txn, self.schema, pending)
                pending.clear()

        def edge(subj, pred, op, value=None, value_id=None, lang=""):
            pending.append(
                DirectedEdge(
                    subj, pred, value=value, value_id=value_id,
                    lang=lang, op=op, ns=ns,
                    fresh=subj in fresh_uids,
                )
            )

        def walk(obj, op, top=False) -> List[int]:
            uid_ref = obj.get("uid")
            subjects = resolve_many(
                uid_ref if uid_ref is not None else f"_:auto{id(obj)}"
            )
            rest = [(k, v) for k, v in obj.items() if k != "uid"]
            if op == OP_DEL and not rest and top:
                # bare top-level {"uid": U}: delete the node outright
                # (nested bare refs are edge targets, not node deletes)
                flush()
                for subj in subjects:
                    for pred in self._node_type_preds(txn, subj, ns):
                        delete_entity_attr(txn, self.schema, subj, pred, ns)
                    delete_entity_attr(
                        txn, self.schema, subj, "dgraph.type", ns
                    )
                return subjects
            schema_get = self.schema.get
            pending_append = pending.append
            for subj in subjects:
                fresh = subj in fresh_uids
                for k, v in rest:
                    if k == "dgraph.type":
                        for t in _as_list(v):
                            edge(
                                subj, "dgraph.type", op,
                                value=Val(TypeID.STRING, t),
                            )
                        continue
                    pred, lang = (
                        k.split("@", 1) if "@" in k else (k, "")
                    )
                    if v is None:
                        if op == OP_DEL:
                            flush()
                            delete_entity_attr(
                                txn, self.schema, subj, pred, ns
                            )
                        continue
                    su = schema_get(pred)
                    # flat-scalar fast path: the dominant live-loader
                    # shape is {"pred": <str|int|float|bool>} — one
                    # constructor each, skipping the list/geo/dict
                    # dispatch below (per-edge GIL work on the write
                    # hot path). DATETIME/PASSWORD convert in to_val.
                    tv = type(v)
                    if tv is str:
                        if not v.startswith("val(") and (
                            su is None
                            or su.value_type not in _SLOW_JSON_TIDS
                        ):
                            pending_append(DirectedEdge(
                                subj, pred, Val(TypeID.STRING, v),
                                None, lang, None, op, ns, fresh,
                            ))
                            continue
                    elif tv is bool or tv is int or tv is float:
                        if (
                            su is None
                            or su.value_type not in _SLOW_JSON_TIDS
                        ):
                            pending_append(DirectedEdge(
                                subj, pred,
                                Val(
                                    TypeID.BOOL if tv is bool
                                    else TypeID.INT if tv is int
                                    else TypeID.FLOAT, v,
                                ),
                                None, lang, None, op, ns, fresh,
                            ))
                            continue
                    if (
                        su is not None
                        and su.value_type == TypeID.VFLOAT
                        and isinstance(v, list)
                        and v
                        and isinstance(v[0], (int, float))
                    ):
                        edge(subj, pred, op, value=to_val(su, v))
                        continue
                    for item in _as_list(v):
                        if is_geo_literal(item):
                            edge(subj, pred, op, value=Val(TypeID.GEO, item))
                        elif isinstance(item, dict):
                            if len(item) == 1 and "uid" in item:
                                # bare nested ref: resolve without the
                                # recursive walk frame
                                for child in resolve_many(item["uid"]):
                                    pending_append(DirectedEdge(
                                        subj, pred, None, child, "",
                                        None, op, ns, fresh,
                                    ))
                                continue
                            for child in walk(item, op):
                                edge(subj, pred, op, value_id=child)
                        elif (
                            isinstance(item, str)
                            and item.startswith("val(")
                            and item.endswith(")")
                        ):
                            # val(v): per-subject value substitution,
                            # like the RDF upsert path
                            vv = (val_vars or {}).get(item[4:-1], {})
                            got = vv.get(subj)
                            if got is not None:
                                edge(subj, pred, op, value=got, lang=lang)
                        else:
                            edge(
                                subj, pred, op,
                                value=to_val(su, item), lang=lang,
                            )
            return subjects

        for obj in _as_list(set_obj):
            walk(obj, OP_SET, top=True)
        for obj in _as_list(del_obj):
            walk(obj, OP_DEL, top=True)
        flush()
        return {k[2:]: hex(v) for k, v in blank.items()}

    # -- observability ----------------------------------------------------------

    def health(self) -> dict:
        """Single-node health/SLO rollup (/debug/healthz body): the
        process healthz (admission rates, pipeline depth, SLO burn
        windows) plus this engine's snapshot-watermark lag. No raft
        groups here — the cluster engines report those."""
        out = observe.healthz("alpha")
        out["snapshot_watermark"] = int(self._snapshot_ts)
        ma = getattr(self.zero, "max_assigned", None)
        if isinstance(ma, (int, float)):
            out["watermark_lag"] = max(0, int(ma) - self._snapshot_ts)
        return out

    # -- queries ----------------------------------------------------------------

    def _plan_cache_tiers(self) -> Dict[str, float]:
        return cache_tier_snapshot(self.mem)

    def query(
        self,
        q: str,
        read_ts: Optional[int] = None,
        access_jwt: Optional[str] = None,
        variables: Optional[Dict[str, str]] = None,
        timeout_ms: Optional[float] = None,
        want: str = "dict",
        debug: bool = False,
    ) -> dict:
        """Run a read-only query at a fresh (or given) read ts.
        timeout_ms bounds execution (ref x/limits --query timeout).
        The response carries reference-shaped extensions.server_latency
        plus the per-query profile; slow queries are force-sampled and
        appended to the slow-query JSONL log (DGRAPH_TPU_SLOW_QUERY_MS,
        DGRAPH_TPU_SLOW_QUERY_LOG).

        `want="raw"` skips the dict-API parse-back: `data` comes back
        as a streamjson.RawJson byte shell for response assembly to
        splice (the HTTP/gRPC serving surface).

        `debug=True` (EXPLAIN/ANALYZE — HTTP ?debug=true, gRPC
        Request.vars["debug"]) turns on the decision-capture hooks and
        attaches the structured plan tree as `extensions.plan`. Capture
        is observation-only: response `data` bytes are identical with
        the flag on or off (golden-enforced, tests/test_explain.py)."""
        # one span a stage under the read's root `query`: `parse`, `admit`
        # (admission, ACL, audit and the read ts) and `execute` (the
        # result-cache probe to the response, `encode` inside it);
        # server_latency is read from their durations
        # info is now always collected: the digest store records the
        # plan-cache outcome per shape, not just EXPLAIN requests (the
        # fill is three dict writes — observation-only either way)
        parse_info: dict = {}
        digested = False  # one digest record per query, on every path
        ticket = None
        slow = False
        completed = False  # clean, untruncated execution
        ns = keys.GALAXY_NS
        shape = None
        try:
            with TRACER.span("query", ns=ns) as root:
                try:
                    # plan cache: repeated query shapes skip parse entirely
                    with TRACER.span("parse") as parse_span:
                        blocks, shape, literals = self.serving.parse(
                            q, variables, info=parse_info
                        )
                except Exception:
                    # unparseable queries accrue to the per-ns `other`
                    # bucket — a flood of malformed text is an
                    # operator-visible shape
                    if DIGESTS.enabled():
                        DIGESTS.record(
                            keys.GALAXY_NS, None, root.seconds, error=True,
                        )
                    raise
                with TRACER.span("admit") as admit_span:
                    # admission gate BEFORE the read-ts allocation: a shed
                    # must be FAST and side-effect-free — under overload
                    # the oracle's applied-barrier wait is exactly where
                    # queries queue, and a request that will be refused
                    # must neither join that queue nor lease a timestamp
                    ticket = self.serving.admit(shape, blocks)
                    allowed = None
                    user = ""
                    if self.acl is not None:
                        try:
                            if access_jwt is None:
                                raise AclError("no access token (ACL enabled)")
                            claims = self.acl.claims(access_jwt)
                            user = claims.get("userid", "")
                            ns = int(claims.get("namespace", 0))
                            self.acl.authorize_preds(
                                access_jwt, _query_preds(blocks), READ,
                                claims=claims,
                            )
                            allowed = self.acl.readable_preds(claims)
                        except Exception:
                            self._audit(
                                "query", user=user, body=q, status="DENIED"
                            )
                            raise
                    self._audit("query", user=user, ns=ns, body=q)
                    deadline = (
                        time.monotonic() + timeout_ms / 1e3
                        if timeout_ms is not None
                        else None
                    )
                    degrade_deadline = None
                    if ticket.degrade:
                        # saturated: run under a bounded budget and return
                        # a partial/degraded response on exhaustion
                        # instead of queueing at full budget (the
                        # partial-result shape)
                        degrade_deadline = (
                            time.monotonic() + self.serving.degrade_budget_s()
                        )
                        deadline = (
                            degrade_deadline
                            if deadline is None
                            else min(deadline, degrade_deadline)
                        )
                    truncated = False
                    # snapshot-watermark read (ref worker/oracle
                    # MaxAssigned): `_snapshot_ts` is published only after
                    # a commit's deltas are written, and advances in
                    # commit-ts order — so a read AT the watermark sees a
                    # complete store without leasing a fresh ts and
                    # waiting out the apply barrier. Under mixed traffic
                    # that wait serialized every read behind the write
                    # pipeline's in-flight window; an in-flight (unacked)
                    # commit is legitimately excluded from the snapshot.
                    # 0 = nothing committed yet: fall back to a fresh
                    # barrier-waited lease.
                    # the watermark is sampled ONCE and reused for BOTH
                    # the read ts and the result-cache key: re-reading
                    # _snapshot_ts at key time would let a commit landing
                    # in between cache watermark-N bytes under the
                    # watermark-N+1 key (a one-line TOCTOU that breaks the
                    # never-stale proof)
                    wm = self._snapshot_ts
                    ts = (
                        read_ts
                        if read_ts is not None
                        else (wm or self.zero.read_ts())
                    )
                root.attrs["ns"] = ns
                stages: dict = {}
                with TRACER.span("execute") as execute_span:
                    # snapshot-keyed result reuse (serving/resultcache.py):
                    # watermark reads with no ACL are a pure function of
                    # (shape, literals, vars, ns, watermark) — the
                    # micro-batcher's snapshot argument
                    # (serving/microbatch.py) — so the whole response's
                    # wire bytes can be served from the LRU. Caller-pinned
                    # read_ts never caches; EXPLAIN queries always execute
                    # but record the would-hit tier in the plan.
                    rc_key = None
                    rc_probe = False
                    raw_hit = None
                    if read_ts is None and self.acl is None:
                        rc_key, raw_hit, rc_probe = self.serving.result_probe(
                            shape, literals, variables, ns, wm, debug,
                        )
                    if raw_hit is None:
                        cache_base = self._plan_cache_tiers() if debug else None
                        with profile_scope(debug=debug) as prof, \
                                METRICS.timer("query_latency_seconds"):
                            try:
                                cache = LocalCache(self.kv, ts, mem=self.mem)
                                # caller-pinned read_ts never coalesces:
                                # the snapshot-watermark argument only
                                # covers fresh engine-allocated timestamps
                                # (which waited on the applied barrier)
                                out = self._query_parsed(
                                    blocks,
                                    cache,
                                    ns,
                                    allowed,
                                    deadline=deadline,
                                    batcher=(
                                        self.serving.batcher_for(cache)
                                        if read_ts is None
                                        else None
                                    ),
                                    want=want,
                                    stages=stages,
                                )
                            except QueryBudgetError:
                                # only the degraded-admission budget
                                # converts a deadline trip into a partial
                                # result; semantic errors (different type)
                                # and a tighter CLIENT timeout (trips
                                # before the degrade budget) raise
                                if (
                                    degrade_deadline is None
                                    or time.monotonic() < degrade_deadline
                                ):
                                    raise
                                out = {"data": {}}
                                truncated = True
                    METRICS.inc("num_queries")
                parse_ns = parse_span.duration_ns
                assign_ns = admit_span.duration_ns
                execute_ns = execute_span.duration_ns
                total_ns = parse_ns + assign_ns + execute_ns
                if raw_hit is not None:
                    # hits are SERVED traffic: they must land in the
                    # latency histogram the SLO/health surface reads. The
                    # sample is the execute stage, the same stage the
                    # miss path's METRICS.timer covers — a hit recording
                    # full wall time would make hit samples incomparable
                    # with miss samples in one histogram
                    METRICS.observe(
                        "query_latency_seconds", execute_span.seconds
                    )
                    # shape stays out of the cost EWMA (finally passes
                    # shape only when `completed`): a hit's latency
                    # describes the cache, not the shape's execution cost
                    # the admission gate estimates
                    if DIGESTS.enabled():
                        DIGESTS.record(
                            ns, shape, total_ns / 1e9,
                            nbytes=len(raw_hit),
                            plan_hit=bool(parse_info.get("hit")),
                            result_hit=True,
                        )
                        digested = True
                    observe.note_tenant("query", ns, execute_span.seconds)
                    return hit_response(
                        raw_hit, want,
                        parsing_ns=parse_ns,
                        assign_ns=assign_ns,
                        processing_ns=execute_ns,
                        watermark=wm,
                    )
                ext = out.setdefault("extensions", {})
                # encoding happens inside _query_parsed, in its `encode`
                # span; the processing component gives it up so the parts
                # still sum to total_ns (the dict-API parse-back, when
                # present, stays inside processing and is itemized as
                # profile.encode.parse_ns)
                enc_ns = min(stages.get("encode_ns", 0), execute_ns)
                ext["server_latency"] = {
                    # new order: parse -> admission/ACL/ts -> execute; the
                    # admission + ACL + audit time rides in the assign
                    # component
                    "parsing_ns": parse_ns,
                    "assign_timestamp_ns": assign_ns,
                    "processing_ns": execute_ns - enc_ns,
                    "encoding_ns": enc_ns,
                    "total_ns": total_ns,
                }
                if total_ns > 0 and prof.encode:
                    prof.encode["share"] = round(
                        int(prof.encode.get("encode_ns", 0)) / total_ns, 4
                    )
                ext["profile"] = prof.to_dict()
                if prof.plan is not None:
                    prof.plan.plan_cache = parse_info or {}
                    prof.plan.admission = {
                        "enabled": self.serving.admission.enabled(),
                        "cost": round(ticket.cost, 3),
                        "degrade": ticket.degrade,
                    }
                    if cache_base is not None:
                        now_tiers = self._plan_cache_tiers()
                        prof.plan.cache = {
                            k: now_tiers[k] - cache_base.get(k, 0)
                            for k in now_tiers
                        }
                    prof.plan.result_cache = {
                        "enabled": self.serving.results.capacity() > 0,
                        "eligible": rc_key is not None,
                        "would_hit": bool(rc_probe),
                        "watermark": int(self._snapshot_ts),
                    }
                    prof.plan.meta = {
                        "read_ts": int(ts),
                        "snapshot_watermark": int(self._snapshot_ts),
                        "wall_ns": total_ns,
                    }
                    ext["plan"] = prof.plan.to_dict()
                if root.trace_id:
                    ext["trace_id"] = f"{root.trace_id:032x}"
                if ticket.degrade:
                    ext["degraded_admission"] = True
                if truncated:
                    METRICS.inc("degraded_queries_total")
                    ext["degraded"] = True
                    ext["partial"] = True
            # the read's root span has ended: the slow-query record below
            # holds its whole local tree
            if DIGESTS.enabled():
                data = out.get("data")
                rows = (
                    sum(
                        len(v)
                        for v in data.values()
                        if isinstance(v, list)
                    )
                    if isinstance(data, dict)
                    else 0
                )
                DIGESTS.record(
                    ns, shape, total_ns / 1e9,
                    rows=rows,
                    nbytes=int(prof.encode.get("bytes", 0)),
                    error=truncated,
                    plan_hit=bool(parse_info.get("hit")),
                    setop_pairs=int(
                        prof.events.get("setop_pairs_total", 0)
                    ),
                    setop_packed=int(
                        prof.events.get("setop_packed_total", 0)
                    ),
                )
                digested = True
            observe.note_tenant("query", ns, execute_span.seconds)
            # structured slow-query log (ref x/log.go LogSlowOperation,
            # edgraph/server.go:1448): force-sample + bounded JSONL —
            # the digest shape key rides along so a slow entry joins
            # its aggregate row in /debug/digests
            slow = observe.maybe_log_slow(
                "query", q, total_ns / 1e6, root,
                extra={"ns": ns, "shape": shape},
                threshold_ms=self.slow_query_ms,
            )
            completed = not truncated
            if rc_key is not None and completed:
                raw = getattr(out.get("data"), "raw", None)
                if raw is not None:
                    self.serving.results.put(rc_key, raw)
            return out
        finally:
            if ticket is not None:
                # a query that entered execution but never reached a
                # digest record (ACL denial, semantic error, client
                # deadline) still counts against its shape — errors are
                # a first-class digest column
                if not digested and DIGESTS.enabled():
                    DIGESTS.record(ns, shape, root.seconds, error=True)
                # only clean completions feed the shape cost EWMA: a
                # truncated/denied/failed run's latency describes the
                # failure, not the shape
                self.serving.finish(
                    ticket,
                    shape if completed else None,
                    root.seconds * 1e3,
                    slow=slow,
                )
            hosttrace.publish_gc()

    def query_rdf(
        self,
        q: str,
        read_ts: Optional[int] = None,
        variables: Optional[Dict[str, str]] = None,
    ) -> str:
        """Query with RDF (N-Quads) response encoding (ref
        query/outputrdf.go ToRDF; resp_format=RDF on the wire)."""
        ts = read_ts if read_ts is not None else self.zero.read_ts()
        blocks = dql.parse(q, variables)
        ex = Executor(
            LocalCache(self.kv, ts, mem=self.mem),
            self.schema,
            vector_indexes=self.vector_indexes,
        )
        nodes = ex.process(blocks)
        return encode_rdf(nodes)

    def _schema_query(self, gq) -> dict:
        """schema {} / schema(pred: ...) / schema(type: ...) blocks
        (ref dql parseSchema + worker schema retrieval; golden shapes in
        query0_test.go TestSchemaBlock*)."""
        from dgraph_tpu_torch.types.types import type_name as _tn

        if gq.expand:  # schema(type: A) / schema(type: [A, B])
            types = []
            for tname in sorted(gq.expand.split(",")):
                tu = self.schema.get_type(tname)
                if tu is not None:
                    types.append(
                        {
                            "name": tu.name,
                            "fields": [{"name": f} for f in tu.fields],
                        }
                    )
            return {"data": {"types": types} if types else {}}
        want = set(gq.facet_names)  # requested fields ({} = all)
        preds = gq.groupby_attrs or sorted(self.schema.predicates())
        out = []
        for pred in preds:
            su = self.schema.get(pred)
            if su is None:
                continue  # unknown preds silently dropped (ref behavior)
            row: dict = {"predicate": pred}

            def put(field, value, truthy=True):
                if want and field not in want:
                    return
                if truthy and not value:
                    return
                row[field] = value

            put("type", _tn(su.value_type), truthy=False)
            put("index", bool(su.directive_index))
            if su.directive_index:
                put("tokenizer", list(su.tokenizers))
            put("reverse", su.directive_reverse)
            put("count", su.count)
            put("lang", su.lang)
            put("list", su.is_list)
            put("upsert", su.upsert)
            put("unique", su.unique)
            put("no_conflict", su.no_conflict)
            out.append(row)
        return {"data": {"schema": out}}

    def _query_parsed(
        self,
        blocks,
        cache: LocalCache,
        ns: int,
        allowed_preds=None,
        deadline=None,
        batcher=None,
        want: str = "dict",
        stages: Optional[dict] = None,
    ) -> dict:
        """Execute parsed blocks and encode the answer. `stages`, where
        given, receives the `encode` span's duration as `encode_ns`."""
        if len(blocks) == 1 and blocks[0].attr == "__schema__":
            return self._schema_query(blocks[0])
        ex = Executor(
            cache,
            self.schema,
            ns=ns,
            vector_indexes=self.vector_indexes,
            allowed_preds=allowed_preds,
            stats=self.stats,
            deadline=deadline,
            batcher=batcher,
        )
        nodes = ex.process(blocks)
        with TRACER.span("encode") as encode_span:
            data, enc_stats = encode_response_data(
                nodes, val_vars=ex.val_vars, schema=self.schema, want=want
            )
        if stages is not None:
            stages["encode_ns"] = encode_span.duration_ns
        prof = observe.current_profile()
        if prof is not None:
            prof.encode.update(enc_stats)
            if prof.plan is not None:
                prof.plan.planner = (
                    ex.planner.explain()
                    if ex.planner is not None
                    else {"enabled": False}
                )
        return {"data": data}


def _query_preds(blocks) -> list:
    """All predicates a query touches (for ACL checks,
    ref edgraph/server.go authorizeRequest)."""
    preds = set()

    def from_func(fn):
        if fn is None or not fn.attr:
            return
        if fn.name == "type":
            preds.add("dgraph.type")  # attr holds the type NAME, not a pred
        else:
            preds.add(fn.attr.lstrip("~"))

    def from_filter(ft):
        if ft is None:
            return
        from_func(ft.func)
        for c in ft.children:
            from_filter(c)

    def walk(g):
        from_func(g.func)
        from_filter(g.filter)
        # classify by node kind (flags), not by attr-name heuristics — a
        # data predicate literally named "q"/"var" must still be checked
        is_virtual = (
            g.is_uid
            or g.val_var
            or g.aggregator
            or g.math_expr is not None
            or g.expand  # expanded preds are ACL-filtered at execution
            or (g.is_count and g.attr == "uid")
        )
        if g.attr and not is_virtual:
            preds.add(g.attr.lstrip("~"))
        for ga in g.groupby_attrs:
            preds.add(ga.lstrip("~"))
        for o in g.order:
            if o.attr:
                preds.add(o.attr)
        for c in g.children:
            walk(c)

    for b in blocks:
        for c in b.children:
            walk(c)
        from_func(b.func)
        from_filter(b.filter)
        for ga in b.groupby_attrs:
            preds.add(ga.lstrip("~"))
        for o in b.order:
            if o.attr:
                preds.add(o.attr)
    return sorted(preds)


def _json_preds(obj) -> set:
    """Predicates referenced by a JSON mutation object tree."""
    preds = set()

    def walk(o):
        if isinstance(o, list):
            for it in o:
                walk(it)
            return
        if not isinstance(o, dict):
            return
        for k, v in o.items():
            if k == "uid":
                continue
            preds.add(k.split("@", 1)[0])
            if isinstance(v, (dict, list)):
                walk(v)

    walk(obj)
    return preds


def _eval_cond(cond: str, uid_vars) -> bool:
    """Evaluate '@if(...)' upsert conditions: len(var) comparisons
    combined with AND/OR/NOT and parentheses (ref dql conditional
    mutations, edgraph/server.go parseMutationObject cond handling)."""
    import re as _re

    m = _re.match(r"\s*@if\s*\((.*)\)\s*$", cond, _re.S)
    if not m:
        raise ValueError(f"unsupported upsert condition {cond!r}")
    expr = m.group(1)

    tokens = _re.findall(
        r"\(|\)|AND\b|OR\b|NOT\b|and\b|or\b|not\b|"
        r"(?:eq|lt|le|gt|ge)\s*\(\s*len\s*\(\s*\w+\s*\)\s*,\s*\d+\s*\)",
        expr,
    )
    if not tokens or "".join(tokens).replace(" ", "") != expr.replace(" ", ""):
        raise ValueError(f"unsupported upsert condition {cond!r}")
    pos = 0

    def atom(tok: str) -> bool:
        am = _re.match(
            r"(eq|lt|le|gt|ge)\s*\(\s*len\s*\(\s*(\w+)\s*\)\s*,\s*(\d+)\s*\)",
            tok,
        )
        op, var, n = am.group(1), am.group(2), int(am.group(3))
        ln = len(uid_vars.get(var, []))
        return {
            "eq": ln == n,
            "lt": ln < n,
            "le": ln <= n,
            "gt": ln > n,
            "ge": ln >= n,
        }[op]

    def parse_or() -> bool:
        nonlocal pos
        left = parse_and()
        while pos < len(tokens) and tokens[pos].lower() == "or":
            pos += 1
            right = parse_and()
            left = left or right
        return left

    def parse_and() -> bool:
        nonlocal pos
        left = parse_not()
        while pos < len(tokens) and tokens[pos].lower() == "and":
            pos += 1
            right = parse_not()
            left = left and right
        return left

    def parse_not() -> bool:
        nonlocal pos
        if pos < len(tokens) and tokens[pos].lower() == "not":
            pos += 1
            return not parse_not()
        return parse_primary()

    def parse_primary() -> bool:
        nonlocal pos
        tok = tokens[pos]
        if tok == "(":
            pos += 1
            v = parse_or()
            if pos >= len(tokens) or tokens[pos] != ")":
                raise ValueError(f"unbalanced parens in {cond!r}")
            pos += 1
            return v
        pos += 1
        return atom(tok)

    out = parse_or()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in upsert condition {cond!r}")
    return out


# schema value types whose JSON scalars need to_val's conversion work
# (everything else takes the flat-scalar fast path in the JSON walker)
_SLOW_JSON_TIDS = (TypeID.DATETIME, TypeID.PASSWORD)


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, list) else [x]


def _json_to_val(item) -> Val:
    if isinstance(item, bool):
        return Val(TypeID.BOOL, item)
    if isinstance(item, int):
        return Val(TypeID.INT, item)
    if isinstance(item, float):
        return Val(TypeID.FLOAT, item)
    if isinstance(item, list):
        return Val(TypeID.VFLOAT, np.asarray(item, dtype=np.float32))
    return Val(TypeID.STRING, str(item))
