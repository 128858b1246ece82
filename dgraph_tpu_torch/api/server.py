"""Embedded API front-end: the edgraph.Server equivalent, on one device.

Port of `dgraph_tpu/api/server.py`, cut to the DQL read path and the
mutations that feed it: `alter`, `new_txn().mutate_rdf(...,
commit_now=True)` and `query`. Queries run through
dql.parse -> query.Executor -> the streaming JSON encoder, with the set-op
data plane on the dispatcher's torch device. Vector predicates
(`float32vector @index(hnsw(...))`) get a `models.vector.VectorIndex` on
the same device, fed at commit, so `similar_to` is served as in the
reference.

Left out of this slice (see ROADMAP): ACL and audit, the serving front
(plan cache, admission, micro-batcher, result cache, digests), CDC and
subscriptions, group commit (commits take the serial path that
DGRAPH_TPU_GROUP_COMMIT=0 gives in the reference), JSON mutations and
upsert blocks, RDF output, and the on-disk stores.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

from dgraph_tpu_torch import dql
from dgraph_tpu_torch.loaders.rdf import NQuad, parse_rdf
from dgraph_tpu_torch.posting import colwrite
from dgraph_tpu_torch.posting.lists import LocalCache, Txn
from dgraph_tpu_torch.posting.memlayer import MemoryLayer
from dgraph_tpu_torch.posting.mutation import (
    DirectedEdge,
    apply_edges,
    delete_entity_attr,
    ingest_vectors,
)
from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET
from dgraph_tpu_torch.query import dispatch
from dgraph_tpu_torch.query.streamjson import encode_response_data
from dgraph_tpu_torch.query.subgraph import Executor
from dgraph_tpu_torch.schema.schema import State, parse_schema
from dgraph_tpu_torch.storage.kv import KV, open_kv
from dgraph_tpu_torch.types.types import TypeID
from dgraph_tpu_torch.utils import observe
from dgraph_tpu_torch.utils.cmsketch import StatsHolder, feed_stats
from dgraph_tpu_torch.utils.observe import METRICS, TRACER, profile_scope
from dgraph_tpu_torch.x import config, keys
from dgraph_tpu_torch.zero.zero import ZeroLite


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

    def query(self, q: str) -> dict:
        """Query within this txn's snapshot (sees own uncommitted writes)."""
        self.txn.materialize_cols()  # read-your-writes over columns
        return self.server._query_parsed(
            dql.parse(q), self.txn.cache, keys.GALAXY_NS
        )

    def mutate_rdf(
        self, set_rdf: str = "", del_rdf: str = "", commit_now: bool = False
    ) -> Dict[str, str]:
        uids = self.server._apply_nquads(
            self.txn, parse_rdf(set_rdf), parse_rdf(del_rdf), keys.GALAXY_NS
        )
        if commit_now:
            self.commit()
        return uids

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
    serves from one device: the last Server built sets it."""

    def __init__(self, device="cuda"):
        dispatch.DISPATCHER.bind(device)
        self.device = dispatch.DISPATCHER.device
        self.kv: KV = open_kv()
        self.zero = ZeroLite()
        self.schema = State()
        # predicate -> models.vector.VectorIndex on self.device
        self.vector_indexes: Dict[str, object] = {}
        self._lock = threading.Lock()
        # slow-query threshold (instance override of the registry knob)
        self.slow_query_ms = float(config.get("SLOW_QUERY_MS"))
        self.mem = MemoryLayer()  # shared decoded-list read cache
        self.stats = StatsHolder()  # selectivity stats (fed on commit)
        # snapshot watermark: the last commit made VISIBLE (published
        # before zero.applied, the barrier read_ts waits on)
        self._snapshot_ts = 0
        self._bootstrap_schema()

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
        try:
            return self._alter_inner(schema_text, drop_attr, drop_all)
        finally:
            # alters write outside the txn/applied barrier: advance the
            # watermark past every read_ts allocated during the alter
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

    def _commit(self, txn: Txn, timed: bool = True) -> int:
        """The reference's serial commit path (_commit_serial)."""
        colwrite.commit_guard(txn, self)
        t_commit0 = time.monotonic()
        # serialized: MemKV is single-writer, and readers must not see a
        # commit_ts whose deltas aren't written yet
        with TRACER.span("commit"), (
            METRICS.timer("commit_latency_seconds")
            if timed
            else contextlib.nullcontext()
        ), self._lock:
            commit_ts = self.zero.commit(txn.start_ts, txn.conflict_keys, track=True)
            try:
                txn.write_deltas(self.kv, commit_ts)
            finally:
                # watermark BEFORE the apply barrier: any read_ts
                # allocated after this commit becomes visible observes
                # the advanced watermark
                self._snapshot_ts = max(self._snapshot_ts, commit_ts)
                self.zero.applied(commit_ts)
        METRICS.inc("num_commits")
        # a commit must never leave a stale operand on the card: the
        # memory layer drops the dispatcher's cached device copies too
        self.mem.invalidate(txn.cache.deltas.keys())
        ck = getattr(txn, "col_keys", None)
        if ck:
            self.mem.invalidate(ck)
        feed_stats(self.stats, txn.cache.deltas)
        colwrite.feed_col_stats(self.stats, txn)
        # vector index ingestion at commit (factory seam)
        ingest_vectors(self.vector_indexes, txn.cache.deltas)
        METRICS.inc(
            "mutation_edges_total",
            sum(len(p) for p in txn.cache.deltas.values())
            + getattr(txn, "col_nposts", 0),
        )
        observe.note_tenant(
            "commit",
            getattr(txn, "tenant_ns", keys.GALAXY_NS),
            time.monotonic() - t_commit0,
        )
        return commit_ts

    # -- mutations -------------------------------------------------------------

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

    # -- queries ----------------------------------------------------------------

    def query(
        self,
        q: str,
        read_ts: Optional[int] = None,
        variables: Optional[Dict[str, str]] = None,
        timeout_ms: Optional[float] = None,
        want: str = "dict",
        debug: bool = False,
    ) -> dict:
        """Run a read-only query at the snapshot watermark (or a given
        read ts). timeout_ms bounds execution. The response carries
        reference-shaped extensions.server_latency plus the per-query
        profile; slow queries go to the slow-query log.

        `want="raw"` returns `data` as a streamjson.RawJson byte shell.
        `debug=True` attaches the EXPLAIN plan tree as `extensions.plan`;
        `data` bytes are the same with it on or off."""
        t_begin = time.monotonic()
        blocks = dql.parse(q, variables)
        t_parsed = time.monotonic()
        deadline = (
            time.monotonic() + timeout_ms / 1e3
            if timeout_ms is not None
            else None
        )
        # snapshot-watermark read (ref worker/oracle MaxAssigned): a read
        # AT the watermark sees a complete store without leasing a fresh
        # ts; 0 = nothing committed yet: lease a barrier-waited one
        ts = (
            read_ts
            if read_ts is not None
            else (self._snapshot_ts or self.zero.read_ts())
        )
        t_assigned = time.monotonic()
        with TRACER.span("query", ns=keys.GALAXY_NS) as root, \
                profile_scope(debug=debug) as prof, \
                METRICS.timer("query_latency_seconds"):
            cache = LocalCache(self.kv, ts, mem=self.mem)
            out = self._query_parsed(
                blocks, cache, keys.GALAXY_NS, deadline=deadline, want=want
            )
        METRICS.inc("num_queries")
        t_done = time.monotonic()
        ext = out.setdefault("extensions", {})
        enc_ns = int(prof.encode.get("encode_ns", 0))
        total_ns = int((t_done - t_begin) * 1e9)
        ext["server_latency"] = {
            "parsing_ns": int((t_parsed - t_begin) * 1e9),
            "assign_timestamp_ns": int((t_assigned - t_parsed) * 1e9),
            "processing_ns": max(
                int((t_done - t_assigned) * 1e9) - enc_ns, 0
            ),
            "encoding_ns": enc_ns,
            "total_ns": total_ns,
        }
        if total_ns > 0 and prof.encode:
            prof.encode["share"] = round(enc_ns / total_ns, 4)
        ext["profile"] = prof.to_dict()
        if prof.plan is not None:
            prof.plan.meta = {
                "read_ts": int(ts),
                "snapshot_watermark": int(self._snapshot_ts),
                "wall_ns": total_ns,
            }
            ext["plan"] = prof.plan.to_dict()
        if root.trace_id:
            ext["trace_id"] = f"{root.trace_id:032x}"
        observe.note_tenant("query", keys.GALAXY_NS, t_done - t_assigned)
        observe.maybe_log_slow(
            "query", q, (t_done - t_begin) * 1e3, root,
            extra={"ns": keys.GALAXY_NS},
            threshold_ms=self.slow_query_ms,
        )
        return out

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
        deadline=None,
        want: str = "dict",
    ) -> dict:
        if len(blocks) == 1 and blocks[0].attr == "__schema__":
            return self._schema_query(blocks[0])
        ex = Executor(
            cache,
            self.schema,
            ns=ns,
            vector_indexes=self.vector_indexes,
            stats=self.stats,
            deadline=deadline,
        )
        nodes = ex.process(blocks)
        data, enc_stats = encode_response_data(
            nodes, val_vars=ex.val_vars, schema=self.schema, want=want
        )
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


def _schema_line(su) -> str:
    """One schema line for a predicate, as the store persists it (a copy
    of the reference's admin/export.py helper)."""
    tname = {
        TypeID.DEFAULT: "default",
        TypeID.STRING: "string",
        TypeID.INT: "int",
        TypeID.FLOAT: "float",
        TypeID.BOOL: "bool",
        TypeID.DATETIME: "datetime",
        TypeID.GEO: "geo",
        TypeID.UID: "uid",
        TypeID.PASSWORD: "password",
        TypeID.VFLOAT: "float32vector",
    }.get(su.value_type, "default")
    t = f"[{tname}]" if su.is_list else tname
    directives = []
    if su.tokenizers or su.vector_specs:
        toks = list(su.tokenizers)
        for vs in su.vector_specs:
            opts = ",".join(f'{k}:"{v}"' for k, v in vs.options.items())
            toks.append(f"{vs.name}({opts})")
        directives.append(f"@index({', '.join(toks)})")
    if su.directive_reverse:
        directives.append("@reverse")
    if su.count:
        directives.append("@count")
    if su.upsert:
        directives.append("@upsert")
    if su.lang:
        directives.append("@lang")
    if su.unique:
        directives.append("@unique")
    d = (" " + " ".join(directives)) if directives else ""
    return f"{su.predicate}: {t}{d} ."
