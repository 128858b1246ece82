"""Edge application with index maintenance: the mutation write path.

Mirrors dgraph/posting/index.go: AddMutationWithIndex (:585) —
apply a DirectedEdge to the data key, and maintain the index keys
(addIndexMutations :84), reverse edges (:276), and count index (:431)
according to the predicate's schema.

An edge is (entity uid, attr, value_id target | typed value, lang, facets,
op). Value changes first delete the old value's index tokens, then insert
the new ones (ref index.go:497 addMutationHelper's current-value read).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from dgraph_tpu_torch.posting import colwrite
from dgraph_tpu_torch.posting.lists import LocalCache, Txn
from dgraph_tpu_torch.posting.pl import (
    OP_DEL,
    OP_SET,
    VALUE_UID,
    Posting,
    lang_uid,
    value_uid,
)
from dgraph_tpu_torch.schema.schema import SchemaUpdate, State
from dgraph_tpu_torch.tok.tok import build_tokens
from dgraph_tpu_torch.types.types import TypeID, Val, convert, to_binary
from dgraph_tpu_torch.utils import observe
from dgraph_tpu_torch.x import keys


class DirectedEdge:
    """Ref protos/pb.proto DirectedEdge."""

    __slots__ = (
        "entity",
        "attr",
        "value",
        "value_type",
        "value_id",
        "lang",
        "facets",
        "op",
        "ns",
        "fresh",
    )

    def __init__(
        self,
        entity: int,
        attr: str,
        value: Optional[Val] = None,
        value_id: Optional[int] = None,
        lang: str = "",
        facets=None,
        op: int = OP_SET,
        ns: int = keys.GALAXY_NS,
        fresh: bool = False,
    ):
        self.entity = entity
        self.attr = attr
        self.value = value
        self.value_id = value_id
        self.lang = lang
        self.facets = facets or {}
        self.op = op
        self.ns = ns
        # `fresh` marks a subject whose uid was leased by THIS request
        # (a blank node): its (entity, pred) keys cannot hold committed
        # values, so the batched apply path skips the deindex read —
        # byte-identical outcome, the serial path just reads emptiness
        self.fresh = fresh


def _facet_bytes(facets) -> tuple[dict, dict]:
    fb, ft = {}, {}
    for k, v in (facets or {}).items():
        if not isinstance(v, Val):
            raise TypeError("facets must be types.Val")
        fb[k] = to_binary(v)
        ft[k] = v.tid
    return fb, ft


def apply_edge(
    txn: Txn, st: State, edge: DirectedEdge, update_schema: bool = True
) -> None:
    """Apply one edge to the txn's local cache with index maintenance."""
    if getattr(txn, "col", None) is not None:
        # direct per-edge entry on a columnar txn: pending columns must
        # land first (same-key ordering), and the txn goes serial
        if txn.col.pending:
            colwrite.count_fallback("direct", 1)
        colwrite.materialize(txn)
    su = st.get(edge.attr)
    if su is None:
        if not update_schema:
            raise ValueError(f"no schema for predicate {edge.attr!r}")
        tid = (
            TypeID.UID
            if edge.value_id is not None
            else (edge.value.tid if edge.value else TypeID.DEFAULT)
        )
        su = st.ensure_default(edge.attr, tid)

    # per-tablet traffic accounting (the rebalancer's mutation signal);
    # fast-path edges in apply_edges are counted there instead
    if observe.tablet_traffic_enabled():
        observe.TABLETS.note_write(edge.ns, edge.attr, 1)

    data_key = keys.DataKey(edge.attr, edge.entity, edge.ns)
    cache = txn.cache

    if su.is_uid or edge.value_id is not None:
        _apply_uid_edge(txn, su, edge, data_key)
    else:
        _apply_value_edge(txn, su, edge, data_key)

    if su.count:
        _update_count_index(txn, su, edge, data_key)


def ingest_vectors(vector_indexes, deltas) -> None:
    """Vector-index ingestion at commit (factory seam, ref
    tok/index/index.go boundary): ONE implementation for every engine's
    post-commit hook. No-op without vector predicates — the per-key
    parse is measurable on the write path.

    A commit's float32 vectors reach each index as one block (one
    append of their rows, read straight from the postings' bytes); a
    remove, or a value of another type or width, first lands the block
    gathered so far, so every index sees the commit's writes in order."""
    if not vector_indexes:
        return
    import numpy as np

    pending = {}  # index -> ([uid], [float32 bytes]) not yet inserted
    # a key's attr sits after its tag, its length and the 8-byte
    # namespace: only keys of a vector predicate are parsed
    heads = {a.encode("utf-8") for a in vector_indexes}

    def land(vidx):
        block = pending.pop(vidx, None)
        if block:
            uids, raw = block
            vecs = np.frombuffer(b"".join(raw), np.float32)
            vidx.insert(uids, vecs.reshape(len(uids), -1))

    for key, posts in deltas.items():
        if key[0] != keys.TAG_SPLIT and (
            key[11 : 3 + int.from_bytes(key[1:3], "big")] not in heads
        ):
            continue
        pk = keys.parse_key(key)
        vidx = vector_indexes.get(pk.attr)
        if vidx is not None and pk.is_data:
            for p in posts:
                if p.is_value and p.op == OP_SET:
                    block = pending.get(vidx)
                    # the index's width, or the block's before the first
                    width = 4 * vidx.dim if vidx.dim else (
                        len(block[1][0]) if block else len(p.value)
                    )
                    if p.value_type == TypeID.VFLOAT and width and len(p.value) == width:
                        uids, raw = pending.setdefault(vidx, ([], []))
                        uids.append(pk.uid)
                        raw.append(p.value)
                    else:
                        land(vidx)
                        vidx.insert(pk.uid, p.val().value)
                elif p.op == OP_DEL:
                    land(vidx)
                    vidx.remove(pk.uid)
    for vidx in list(pending):
        land(vidx)


def apply_edges(
    txn: Txn, st: State, edges: List[DirectedEdge],
    update_schema: bool = True,
) -> None:
    """Batched edge application. On a columnar txn (colwrite.maybe_enable)
    the whole call is first offered to the columnar collector — edges
    land as arrays for the commit-time native batch_apply kernel instead
    of Posting objects. Any ineligible edge falls the call back: the
    collected columns replay through the serial path (byte-identical),
    then this call runs through the Python path — serial, or partitioned
    by predicate across the exec-worker pool when wide enough
    (_apply_edges_sharded; posting lists of distinct predicates live
    under distinct keys, so shards commute)."""
    if not edges:
        return
    col = getattr(txn, "col", None)
    if col is not None:
        reason = col.try_collect(txn, st, edges, update_schema)
        if reason is None:
            return
        colwrite.count_fallback(reason, len(edges))
        colwrite.materialize(txn)
    _apply_edges_fallback(txn, st, edges, update_schema)


def _apply_edges_fallback(
    txn: Txn, st: State, edges: List[DirectedEdge],
    update_schema: bool = True,
) -> None:
    """Python application of a batch the columnar path declined:
    predicate-sharded across the exec pool when the batch is wide
    enough, else the serial bulk path."""
    shards = _shard_plan(edges)
    if shards is None:
        _apply_edges_serial(txn, st, edges, update_schema)
    else:
        _apply_edges_sharded(txn, st, edges, shards, update_schema)


def shard_assign(n_groups: int, nshards: int) -> List[int]:
    """The (ns, attr)-disjoint shard rule, shared between the
    thread-sharded residual apply below and the apply-shard worker
    processes (worker/applyshard.py): group i — in first-appearance
    order — lands on shard i % nshards. One definition, so the two
    planes can never partition the same batch differently."""
    return [i % nshards for i in range(n_groups)]


def _shard_plan(edges) -> Optional[List[List[DirectedEdge]]]:
    """Partition a batch by predicate into shard worklists, or None to
    run serially. APPLY_SHARDS forces a width (tests/chaos); otherwise
    sharding engages only past APPLY_SHARD_MIN_EDGES with EXEC_WORKERS
    threads configured. Per-(ns, attr) edge order is preserved inside a
    shard; shards touch disjoint predicates, hence disjoint keys
    (data/index/reverse/count keys all embed the attr)."""
    from dgraph_tpu_torch.x import config

    forced = int(config.get("APPLY_SHARDS"))
    if forced == 1 or len(edges) < 2:
        return None
    workers = forced if forced > 0 else int(config.get("EXEC_WORKERS"))
    if workers < 2:
        return None
    if forced <= 0 and len(edges) < int(
        config.get("APPLY_SHARD_MIN_EDGES")
    ):
        return None
    by_attr: dict = {}
    for e in edges:
        by_attr.setdefault((e.ns, e.attr), []).append(e)
    if len(by_attr) < 2:
        return None
    nshards = min(workers, len(by_attr))
    shards: List[List[DirectedEdge]] = [[] for _ in range(nshards)]
    assign = shard_assign(len(by_attr), nshards)
    for i, group in enumerate(by_attr.values()):
        shards[assign[i]].extend(group)
    return shards


class _OverlayDeltas:
    """Shard-local delta map layered over the txn's base deltas: reads
    see base + local (earlier serial calls in this txn may have touched
    the same predicate), writes go local only — the merge barrier moves
    them into the base in shard-index order."""

    __slots__ = ("base", "local")

    def __init__(self, base):
        self.base = base
        self.local: dict = {}

    def get(self, key, default=None):
        b = self.base.get(key)
        l = self.local.get(key)
        if b and l:
            return b + l
        return l or b or default

    def setdefault(self, key, default):
        # add_delta's accessor: appends must stay shard-local
        loc = self.local.get(key)
        if loc is None:
            loc = self.local[key] = []
        return loc

    def __contains__(self, key):
        return key in self.local or key in self.base


class _ShardCache(LocalCache):
    """LocalCache view for one apply shard: shares the txn's kv /
    read_ts / memlayer (thread-safe), private posting-list memo and
    delta overlay."""

    def __init__(self, base: LocalCache):
        self.kv = base.kv
        self.read_ts = base.read_ts
        self.mem = base.mem
        self._plists = {}
        self.deltas = _OverlayDeltas(base.deltas)


class _ShardTxn:
    """Txn facade a shard worker writes through: buffers conflict-key
    calls for deterministic replay at the merge barrier."""

    __slots__ = ("cache", "start_ts", "cks")

    def __init__(self, base: Txn, cache: _ShardCache):
        self.cache = cache
        self.start_ts = base.start_ts
        self.cks: List[tuple] = []

    def add_conflict_key(self, key: bytes, extra: bytes = b""):
        self.cks.append((key, extra))


def _apply_edges_sharded(
    txn: Txn, st: State, edges, shards, update_schema: bool
) -> None:
    """Run the shard worklists through _apply_edges_serial on private
    cache overlays — shard 0 on this thread, the rest on the exec pool
    — then merge deterministically in shard-index order (append-order
    inside a key is all the layered store observes, and shards never
    share keys). Any shard error discards every overlay and replays the
    ORIGINAL batch serially on the main txn, reproducing the serial
    path's partial-application-then-raise semantics exactly (per-tablet
    traffic gets counted twice on that path — an accounting smudge, not
    a correctness issue)."""
    from dgraph_tpu_torch.query.subgraph import _expand_pool, _submit_bounded

    nshards = len(shards)
    caches = [_ShardCache(txn.cache) for _ in range(nshards)]
    stxns = [_ShardTxn(txn, c) for c in caches]
    pool = _expand_pool(nshards)
    futs = []
    for k in range(1, nshards):
        futs.append(
            (
                k,
                _submit_bounded(
                    pool, nshards, _apply_edges_serial,
                    stxns[k], st, shards[k], update_schema,
                ),
            )
        )
    err = None
    try:
        _apply_edges_serial(stxns[0], st, shards[0], update_schema)
    except Exception as ex:
        err = ex  # still join the pool shards before acting
    for k, f in futs:
        try:
            if f is None:  # pool at its backpressure bound: run inline
                _apply_edges_serial(stxns[k], st, shards[k], update_schema)
            else:
                f.result()
        except Exception as ex:
            if err is None:
                err = ex
    if err is not None:
        _apply_edges_serial(txn, st, edges, update_schema)
        return
    base = txn.cache.deltas
    for k in range(nshards):
        for key, posts in caches[k].deltas.local.items():
            base.setdefault(key, []).extend(posts)
        for key, extra in stxns[k].cks:
            txn.add_conflict_key(key, extra)
    observe.METRICS.inc("mutation_sharded_apply_total")


def _apply_edges_serial(
    txn: Txn, st: State, edges: List[DirectedEdge],
    update_schema: bool = True,
) -> None:
    """Batched edge application: semantically identical to calling
    apply_edge per edge in order, but the common live-ingest shape —
    scalar value SET with no lang/facets on a non-list, non-count
    predicate, writing a (entity, pred) key no other edge in the batch
    touches — runs through bulk machinery:

      - ONE values_many pass reads every such key's current postings
        (the deindex check) instead of a KV read per edge;
      - term tokens for ASCII strings come from ONE native call
        (codec.cpp tok_terms_ascii), exact/int/bool tokens from direct
        formatters — build_tokens only runs for the long tail;
      - tokenizer objects are the schema entry's cached list.

    Reordering is safe exactly because fast-path keys are
    batch-exclusive: edges sharing a data key (and every rich shape)
    fall back to apply_edge in their original relative order, index
    postings for one uid always come from that uid's own (excluded)
    data-key edges, and per-key delta order is all the layered store
    observes. Keys holding live prior values also fall back (the
    deindex-old-tokens path)."""
    if len(edges) < 2:
        for e in edges:
            apply_edge(txn, st, e, update_schema)
        return
    # classes: 0 slow (apply_edge in order), 1 fast scalar value,
    # 2 fast list-uid SET (append-only postings, order-free)
    infos = []
    key_owners: dict = {}
    key_mixed: dict = {}  # dk -> a non-class-2 edge touches it
    st_get = st.get
    for e in edges:
        su = st_get(e.attr)
        if su is None:
            if not update_schema:
                raise ValueError(f"no schema for predicate {e.attr!r}")
            tid = (
                TypeID.UID
                if e.value_id is not None
                else (e.value.tid if e.value else TypeID.DEFAULT)
            )
            su = st.ensure_default(e.attr, tid)
        dk = keys.DataKey(e.attr, e.entity, e.ns)
        if (
            e.value_id is None
            and not su.is_uid
            and e.value is not None
            and e.op == OP_SET
            and not e.facets
            and not e.lang
            and not su.is_list
            and not su.count
        ):
            cls = 1
        elif (
            e.value_id is not None
            and su.is_list
            and e.op == OP_SET
            and not e.facets
            and not su.count
        ):
            # list-uid SET postings append commutatively (two SETs on
            # one key land as independent final_op entries), so these
            # may even share a data key with each other — just not
            # with any slower-class edge
            cls = 2
        else:
            cls = 0
        key_owners[dk] = key_owners.get(dk, 0) + 1
        if cls != 2:
            key_mixed[dk] = True
        infos.append((e, su, dk, cls))
    fast = [
        i
        for i, (_e, _su, dk, cls) in enumerate(infos)
        if cls == 1 and key_owners[dk] == 1
    ]
    stored: dict = {}
    if fast:
        # the deindex check (does the key hold live prior values?) is
        # only needed where deindexing could happen at all — preds WITH
        # tokenizers (serial apply_edge reads under the same guard) —
        # and never for a `fresh` subject with no txn-local delta
        # (a uid leased this request has no committed values to read)
        need_read = [
            i
            for i in fast
            if infos[i][1].tokenizers
            and not (
                infos[i][0].fresh
                and infos[i][2] not in txn.cache.deltas
            )
        ]
        old_by_idx: dict = {}
        if need_read:
            oldvals = txn.cache.values_many(
                [infos[i][2] for i in need_read]
            )
            old_by_idx = dict(zip(need_read, oldvals))
        kept = []
        for i in fast:
            if old_by_idx.get(i):
                continue  # live prior values: deindex path, per-edge
            e, su, _dk, _cls = infos[i]
            try:
                stored[i] = (
                    convert(e.value, su.value_type)
                    if su.value_type != TypeID.DEFAULT
                    else e.value
                )
            except Exception:
                continue  # conversion error: re-raised by apply_edge
            kept.append(i)
        fast = kept
    tokens = _bulk_tokens(infos, fast, stored)
    fastset = set(fast)
    add_delta = txn.cache.add_delta
    add_ck = txn.add_conflict_key
    # fast-path edges never reach apply_edge (which counts itself):
    # aggregate their per-tablet traffic here, one note per predicate
    traffic = observe.tablet_traffic_enabled()
    wcounts: dict = {}
    for i, (e, su, dk, cls) in enumerate(infos):
        if i in fastset:
            if traffic:
                wcounts[(e.ns, e.attr)] = (
                    wcounts.get((e.ns, e.attr), 0) + 1
                )
            sv = stored[i]
            add_delta(
                dk,
                Posting(
                    uid=VALUE_UID,
                    op=OP_SET,
                    value=to_binary(sv),
                    value_type=sv.tid,
                ),
            )
            add_ck(dk if su.upsert else dk + b"#v")
            for tokb in tokens.get(i, ()):
                ikey = keys.IndexKey(e.attr, tokb, e.ns)
                add_delta(ikey, Posting(uid=e.entity, op=OP_SET))
                if su.upsert:
                    add_ck(ikey)
        elif cls == 2 and dk not in key_mixed:
            if traffic:
                wcounts[(e.ns, e.attr)] = (
                    wcounts.get((e.ns, e.attr), 0) + 1
                )
            # fast list-uid SET: no reads, append-only postings — the
            # same deltas _apply_uid_edge produces for this shape
            add_delta(dk, Posting(uid=e.value_id, op=OP_SET))
            add_ck(
                dk if su.upsert else dk + b"#u",
                str(e.value_id).encode(),
            )
            if su.directive_reverse:
                rk = keys.ReverseKey(e.attr, e.value_id, e.ns)
                add_delta(rk, Posting(uid=e.entity, op=OP_SET))
                add_ck(rk, str(e.entity).encode())
        else:
            apply_edge(txn, st, e, update_schema)
    for (ns, attr), n in wcounts.items():
        observe.TABLETS.note_write(ns, attr, n)


def _bulk_tokens(infos, fast, stored) -> dict:
    """edge index -> index token list for the fast-path edges: native
    bulk term tokenization for ASCII strings, direct formatters for
    exact/int/bool, build_tokens for anything else."""
    from dgraph_tpu_torch import native
    from dgraph_tpu_torch.tok.tok import (
        BoolTokenizer,
        ExactTokenizer,
        IntTokenizer,
        TermTokenizer,
    )

    tokens: dict = {i: [] for i in fast}
    term_idx: List[int] = []
    term_vals: List[bytes] = []
    term_ident = 0
    for i in fast:
        _e, su, _dk, _el = infos[i]
        sv = stored[i]
        for t in su.tokenizer_objs():
            if isinstance(t, TermTokenizer) and sv.tid == TypeID.STRING:
                s = str(sv.value)
                if s.isascii() and native.NATIVE_AVAILABLE:
                    term_idx.append(i)
                    term_vals.append(s.encode("utf-8"))
                    term_ident = t.identifier
                    continue
            elif isinstance(t, ExactTokenizer) and sv.tid == TypeID.STRING:
                tokens[i].append(
                    t.prefix() + str(sv.value).encode("utf-8")
                )
                continue
            elif isinstance(t, IntTokenizer) and sv.tid == TypeID.INT:
                tokens[i].append(
                    t.prefix()
                    + struct.pack(
                        ">Q", (int(sv.value) + (1 << 63)) & ((1 << 64) - 1)
                    )
                )
                continue
            elif isinstance(t, BoolTokenizer) and sv.tid == TypeID.BOOL:
                tokens[i].append(
                    t.prefix() + (b"\x01" if sv.value else b"\x00")
                )
                continue
            tokens[i].extend(build_tokens(sv, [t]))
    if term_idx:
        got = native.tok_terms_ascii(term_vals, term_ident)
        if got is None:
            for i, vb in zip(term_idx, term_vals):
                tokens[i].extend(
                    build_tokens(stored[i], [TermTokenizer()])
                )
        else:
            for i, toks in zip(term_idx, got):
                tokens[i].extend(toks)
    return tokens


def _apply_uid_edge(txn: Txn, su: SchemaUpdate, edge: DirectedEdge, data_key):
    if edge.value_id is None:
        raise ValueError(f"predicate {edge.attr!r} expects a uid edge")
    if not su.is_list and edge.op == OP_SET:
        # single-valued uid predicate: a set REPLACES the target (ref
        # worker/mutation.go — non-list uid preds hold one value; the
        # GraphQL rewriter relies on this when re-pointing references)
        for old in txn.cache.uids(data_key):
            if int(old) != edge.value_id:
                txn.cache.add_delta(data_key, Posting(uid=int(old), op=OP_DEL))
                if su.directive_reverse:
                    rk = keys.ReverseKey(edge.attr, int(old), edge.ns)
                    txn.cache.add_delta(
                        rk, Posting(uid=edge.entity, op=OP_DEL)
                    )
    p = Posting(uid=edge.value_id, op=edge.op)
    fb, ft = _facet_bytes(edge.facets)
    p.facets, p.facet_types = fb, ft
    txn.cache.add_delta(data_key, p)
    txn.add_conflict_key(data_key if su.upsert else data_key + b"#u",
                         str(edge.value_id).encode())

    if su.directive_reverse:
        rkey = keys.ReverseKey(edge.attr, edge.value_id, edge.ns)
        rp = Posting(uid=edge.entity, op=edge.op)
        rp.facets, rp.facet_types = fb, ft
        txn.cache.add_delta(rkey, rp)
        txn.add_conflict_key(rkey, str(edge.entity).encode())


def _apply_value_edge(txn: Txn, su: SchemaUpdate, edge: DirectedEdge, data_key):
    if edge.value is None:
        raise ValueError(f"predicate {edge.attr!r}: missing value")
    # convert to the schema's storage type (ref mutation.go ValidateAndConvert)
    stored = (
        convert(edge.value, su.value_type)
        if su.value_type != TypeID.DEFAULT
        else edge.value
    )
    vbytes = to_binary(stored)

    if su.is_list:
        puid = value_uid(stored)
    else:
        puid = lang_uid(edge.lang if su.lang else "")

    tokenizers = su.tokenizer_objs()

    # deindex old value(s) being overwritten
    if tokenizers:
        if su.is_list:
            old_posts = (
                [p for p in txn.cache.values(data_key) if p.uid == puid]
                if edge.op == OP_DEL
                else []
            )
        else:
            old_posts = [
                p
                for p in txn.cache.values(data_key)
                if p.uid == puid
            ]
        for old in old_posts:
            for tokb in build_tokens(old.val(), tokenizers, lang=old.lang):
                ikey = keys.IndexKey(edge.attr, tokb, edge.ns)
                txn.cache.add_delta(
                    ikey, Posting(uid=edge.entity, op=OP_DEL)
                )
                txn.add_conflict_key(ikey)

    p = Posting(
        uid=puid,
        op=edge.op,
        value=vbytes,
        value_type=stored.tid,
        lang=edge.lang,
    )
    fb, ft = _facet_bytes(edge.facets)
    p.facets, p.facet_types = fb, ft
    txn.cache.add_delta(data_key, p)
    # value writes always conflict at (entity, pred) granularity; @upsert
    # additionally conflicts on index keys (ref posting/list.go:842)
    txn.add_conflict_key(data_key if su.upsert else data_key + b"#v")

    if tokenizers and edge.op == OP_SET:
        for tokb in build_tokens(stored, tokenizers, lang=edge.lang):
            ikey = keys.IndexKey(edge.attr, tokb, edge.ns)
            txn.cache.add_delta(ikey, Posting(uid=edge.entity, op=OP_SET))
            if su.upsert:
                txn.add_conflict_key(ikey)

    # vector index maintenance handled by models/ at commit (factory seam,
    # ref tok/index/index.go boundary); the engine registers vector preds.


def _update_count_index(txn: Txn, su: SchemaUpdate, edge: DirectedEdge, data_key):
    """Maintain @count index: move entity between count buckets
    (ref posting/index.go:431 updateCount)."""
    before = len(txn.cache.uids(data_key))
    # Note: this runs *after* add_delta, so 'before' includes the new edge;
    # recompute prior count from ops in this txn is simplified: we recount
    # from the cache (correct because deltas are applied in order).
    after = before
    prior = after - (1 if edge.op == OP_SET else -1)
    if prior >= 0:
        okey = keys.CountKey(edge.attr, prior, False, edge.ns)
        txn.cache.add_delta(okey, Posting(uid=edge.entity, op=OP_DEL))
    nkey = keys.CountKey(edge.attr, after, False, edge.ns)
    txn.cache.add_delta(nkey, Posting(uid=edge.entity, op=OP_SET))


def delete_entity_attr(txn: Txn, st: State, entity: int, attr: str, ns=keys.GALAXY_NS):
    """S P * deletion: drop all postings of (entity, attr)
    (ref posting/index.go deleteEntries path for star deletes)."""
    if getattr(txn, "col", None) is not None:
        # the star delete reads current postings: collected columns for
        # this (entity, attr) must be visible as deltas first
        from dgraph_tpu_torch.posting import colwrite

        if txn.col.pending:
            colwrite.count_fallback("delete_star", 1)
        colwrite.materialize(txn)
    su = st.get(attr)
    data_key = keys.DataKey(attr, entity, ns)
    tokenizers = su.tokenizer_objs() if su else []
    for p in txn.cache.values(data_key):
        for tokb in build_tokens(p.val(), tokenizers, lang=p.lang):
            ikey = keys.IndexKey(attr, tokb, ns)
            txn.cache.add_delta(ikey, Posting(uid=entity, op=OP_DEL))
    for uid in txn.cache.uids(data_key):
        txn.cache.add_delta(data_key, Posting(uid=int(uid), op=OP_DEL))
        if su and su.directive_reverse:
            rkey = keys.ReverseKey(attr, int(uid), ns)
            txn.cache.add_delta(rkey, Posting(uid=entity, op=OP_DEL))
    for p in txn.cache.values(data_key):
        txn.cache.add_delta(
            data_key,
            Posting(uid=p.uid, op=OP_DEL, value=p.value, value_type=p.value_type),
        )
    txn.add_conflict_key(data_key)
