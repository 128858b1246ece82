"""Streaming arena result encoder: JSON bytes straight from the level buffers.

The dict encoder (outputjson.JsonEncoder) materializes every response
twice: ExecNode tree -> per-node Python dicts -> json.dumps. At large
result sizes that double materialization owns the response path — the
kernel work got fast (compressed-domain set ops, 3 round-trips per
query) and encode share grows linearly with result size. The reference
solves this with an arena fastJson encoder (query/outputnode.go); this
module is the same move shaped for the vectorized executor: results
stream from PR 2's ragged ``(flat_uids, offsets)`` level buffers (the
`RaggedRows` contract, query/ragged.py) straight into byte buffers,
with the bulk shapes — hex-uid arrays, count objects — emitted
block-at-a-time by native kernels (native/codec.cpp ``enc_uid_objs`` /
``enc_int_objs``) instead of one Python object per row.

Byte contract
-------------
`encode_data_bytes(nodes, stream=True)` is byte-identical to
`encode_data_bytes(nodes, stream=False)`, which is
``json.dumps(JsonEncoder(...).encode_blocks(nodes),
separators=(",", ":"), ensure_ascii=False, default=json_default)``.
Identity holds for the native AND pure-Python paths and is enforced
over the full DQL golden corpus (tests/test_stream_encoder.py).

The identity is structural, not re-derived: every scalar byte sequence
is produced by the SAME ``json.dumps`` the dict path uses (keys and
scalar values are dumped individually and spliced), the streaming code
only takes over the *composition* — object/array punctuation, field
order, empty-entity pruning — plus two hand-formatted forms whose
output is trivially stable (lowercase hex uids, decimal int64 counts).
Node subtrees using features the streaming composer does not replicate
(@groupby, @normalize, @ignorereflex, facets, shortest-path blocks,
language fan-out, duplicate display names) fall back to the dict
encoder FOR THAT BLOCK and splice its ``json.dumps`` bytes — identical
by construction, counted in ``stream_encode_fallback_nodes_total``.

`DGRAPH_TPU_STREAM_ENCODER=0` is the registered escape hatch back to
the dict encoder for the whole response path.
"""

from __future__ import annotations

import json
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.query.outputjson import (
    JsonEncoder,
    _display_name,
    _json_val,
)
from dgraph_tpu_torch.query.subgraph import MAXUID, ExecNode
from dgraph_tpu_torch.types.types import TypeID
from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config


def json_default(o: Any):
    """`default=` hook shared by the dict and streaming paths: numpy
    scalars leaking into rarely-exercised shapes (@groupby values,
    path weights) serialize as their Python equivalents instead of
    crashing the response path."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(
        f"object of type {type(o).__name__} is not JSON serializable"
    )


def dumps_bytes(obj: Any) -> bytes:
    """THE serialization contract both encoder paths share."""
    return json.dumps(
        obj, separators=(",", ":"), ensure_ascii=False,
        default=json_default,
    ).encode("utf-8")


def stream_enabled() -> bool:
    """Read per call so tests/benchmarks can flip the escape hatch
    between queries."""
    return bool(config.get("STREAM_ENCODER"))


class Arena:
    """Append-only chunked byte buffer with mark/truncate.

    Chunks are bytes or zero-copy memoryviews over native-kernel
    scratch buffers; ``to_bytes`` is the single final join. mark/
    truncate supports speculative emission: an entity that turns out
    empty (the dict encoder's ``if obj:`` / ``if kid:`` pruning) rolls
    back to the mark instead of being detected up front."""

    __slots__ = ("parts", "length")

    def __init__(self):
        self.parts: List[Any] = []
        self.length = 0

    def write(self, b) -> None:
        self.parts.append(b)
        self.length += len(b)

    def mark(self) -> Tuple[int, int]:
        return (len(self.parts), self.length)

    def truncate(self, m: Tuple[int, int]) -> None:
        del self.parts[m[0]:]
        self.length = m[1]

    def to_bytes(self) -> bytes:
        return b"".join(self.parts)


# row-shape classification for the block-at-a-time kernels
_COL_UID = 1  # the entity's own uid: "uid":"0x.."
_COL_COUNT = 2  # count(pred), from the level's length vector: "c":N
_COL_VALUE = 3  # a scalar value predicate's first posting: "name":v


class StreamEncoder(JsonEncoder):
    """Streaming composer over the dict encoder's semantics.

    Inherits JsonEncoder so non-streamable blocks reuse the dict logic
    verbatim (encode_node_list + dumps_bytes on the result)."""

    def __init__(self, val_vars=None, schema=None, native_ok: bool = True):
        super().__init__(val_vars=val_vars, schema=schema)
        from dgraph_tpu_torch import native

        self._native = native if (native_ok and native.NATIVE_AVAILABLE) else None
        # rows printed by the column path / sent through _emit_entity_b,
        # published once per answer by encode_blocks_into
        self._column_rows = 0
        self._entity_rows = 0

    # -- per-node caches ---------------------------------------------------

    def _key_bytes(self, c: ExecNode) -> bytes:
        kb = getattr(c, "_key_b", None)
        if kb is None:
            name = getattr(c, "_disp_name", None)
            if name is None:
                name = c._disp_name = _display_name(c)  # type: ignore
            kb = c._key_b = dumps_bytes(name) + b":"  # type: ignore
        return kb

    def _streamable(self, node: ExecNode) -> bool:
        ok = getattr(node, "_stream_ok", None)
        if ok is None:
            ok = node._stream_ok = self._check_streamable(node)  # type: ignore
        return ok

    def _check_streamable(self, node: ExecNode) -> bool:
        if getattr(node, "root_groups", None) is not None:
            return False
        if getattr(node, "paths", None):
            return False
        gq = node.gq
        if gq.normalize or gq.ignore_reflex:
            return False
        names = set()
        for c in node.children:
            name = getattr(c, "_disp_name", None)
            if name is None:
                name = c._disp_name = _display_name(c)  # type: ignore
            if name in names:
                # duplicate keys trigger the dict encoder's merge/
                # overwrite semantics (groupby-shares-list, last-wins)
                return False
            names.add(name)
            cgq = c.gq
            if c.groups or cgq.groupby_attrs:
                return False
            if (
                cgq.is_uid
                or cgq.checkpwd_val is not None
                or cgq.math_expr is not None
                or cgq.aggregator
                or cgq.val_var
            ):
                continue
            if cgq.is_count:
                continue
            if cgq.lang == "*":
                return False  # language fan-out emits computed keys
            if cgq.facets or cgq.facet_names or cgq.facet_aliases:
                return False  # facet keys ride beside the field
            if c.is_uid_pred:
                if cgq.normalize:
                    return False
                if getattr(c, "edge_facet_maps", None) is not None:
                    return False
                if not self._streamable(c):
                    return False
        return True

    def _column_plan(self, node: ExecNode) -> Optional[List[tuple]]:
        """How `node`'s entities print, decided once from its children:
        one `(kind, child, key bytes)` per child that prints a field of
        its own in every entity, in field order, for `_write_columns`.
        None where some child needs the entity path: math, val(),
        checkpwd, a per-parent aggregate, a nested uid predicate, a list
        or language value, or a value with no schema entry. Children
        that print nothing in an entity — count(uid), scalar aggregates,
        count() of an unschema'd predicate, a password — take no column,
        so a list of only those has an empty plan. The tests follow
        `_emit_entity_b`'s branches, in its order."""
        plan = getattr(node, "_col_plan", False)
        if plan is not False:
            return plan
        plan = []
        for c in node.children:
            gq = c.gq
            if gq.is_uid:
                plan.append((_COL_UID, c, self._key_bytes(c)))
            elif gq.checkpwd_val is not None or gq.math_expr is not None:
                plan = None
                break
            elif gq.aggregator:
                if any(k != MAXUID for k in c.math_vals):
                    plan = None  # a per-parent aggregate
                    break
            elif gq.val_var:
                plan = None
                break
            elif gq.is_count:
                # count() of a predicate with no schema entry prints nothing
                if gq.attr != "uid" and (
                    self.schema is None
                    or self.schema.get(c.attr.lstrip("~")) is not None
                ):
                    plan.append((_COL_COUNT, c, self._key_bytes(c)))
            elif c.is_uid_pred:
                plan = None
                break
            else:
                su = self.schema.get(c.attr) if self.schema else None
                if su is None or su.is_list or gq.lang:
                    plan = None
                    break
                if su.value_type != TypeID.PASSWORD:
                    plan.append((_COL_VALUE, c, self._key_bytes(c)))
        node._col_plan = plan  # type: ignore
        return plan

    # -- block level -------------------------------------------------------

    def encode_blocks_into(self, nodes: List[ExecNode], a: Arena) -> None:
        """The streaming form of JsonEncoder.encode_blocks + dumps."""
        # dict semantics for repeated block names: last value wins but
        # the FIRST insertion position is kept — a plain dict of
        # name -> payload bytes replicates both for free
        entries: Dict[str, Any] = {}
        for node in nodes:
            if node is None or node.gq.is_var_block:
                continue
            name = node.gq.alias or node.gq.attr
            rg = getattr(node, "root_groups", None)
            if rg is not None and not rg:
                continue  # empty root @groupby omits the whole block
            if node.attr == "_path_":
                if not getattr(node, "paths", None):
                    continue
                name = "_path_"
            entries[name] = self._node_list_chunks(node)
        if self._column_rows:
            METRICS.inc("stream_encode_column_rows_total", self._column_rows)
        if self._entity_rows:
            METRICS.inc("stream_encode_entity_rows_total", self._entity_rows)
        a.write(b"{")
        first = True
        for name, chunks in entries.items():
            if not first:
                a.write(b",")
            first = False
            a.write(dumps_bytes(name) + b":")
            for ch in chunks:
                a.write(ch)
        a.write(b"}")

    def _node_list_chunks(self, node: ExecNode) -> List[Any]:
        sub = Arena()
        if self._streamable(node):
            self._emit_node_list(sub, node)
        else:
            METRICS.inc("stream_encode_fallback_nodes_total")
            sub.write(dumps_bytes(self.encode_node_list(node)))
        return sub.parts

    # -- list level --------------------------------------------------------

    def _emit_node_list(self, a: Arena, node: ExecNode) -> None:
        a.write(b"[")
        n = 0  # items emitted so far (separator discipline)

        # block-level aggregates / count(uid) become standalone objects
        for c in node.children:
            if c.gq.aggregator:
                if getattr(c, "agg_scalar", False):
                    v = c.math_vals.get(MAXUID)
                    if n:
                        a.write(b",")
                    a.write(
                        b"{" + self._key_bytes(c)
                        + (b"null" if v is None else dumps_bytes(_json_val(v)))
                        + b"}"
                    )
                    n += 1
                continue
            elif c.gq.math_expr is not None and not len(node.dest_uids):
                v = c.math_vals.get(MAXUID)
                if v is not None:
                    if n:
                        a.write(b",")
                    a.write(
                        b"{" + self._key_bytes(c)
                        + dumps_bytes(_json_val(v)) + b"}"
                    )
                    n += 1
            elif c.gq.is_count and c.gq.attr == "uid":
                if n:
                    a.write(b",")
                a.write(
                    b"{" + self._key_bytes(c)
                    + b"%d" % len(node.dest_uids) + b"}"
                )
                n += 1

        dest = node.dest_uids
        if len(dest):
            plan = self._column_plan(node)
            if plan:
                self._write_columns(a, plan, dest, n > 0)
            elif plan is None:
                for i, u in enumerate(dest):
                    m = a.mark()
                    if n:
                        a.write(b",")
                    if self._emit_entity_b(a, node, int(u), i):
                        n += 1
                    else:
                        a.truncate(m)
        a.write(b"]")

    # -- entity level ------------------------------------------------------

    def _emit_entity_b(self, a: Arena, node: ExecNode, uid: int, row: int) -> bool:
        """Streaming mirror of JsonEncoder.encode_entity (the streamable
        subset: no normalize/ignorereflex/facets/groupby — those fall
        back at block level). Returns False when the entity is empty
        (caller rolls the arena back, matching `if obj:` pruning)."""
        self._entity_rows += 1
        a.write(b"{")
        nf = 0  # fields written
        for c in node.children:
            gq = c.gq
            if gq.is_uid:
                if nf:
                    a.write(b",")
                a.write(self._key_bytes(c) + b'"0x%x"' % uid)
                nf += 1
            elif gq.checkpwd_val is not None:
                v = c.math_vals.get(uid)
                if v is not None:
                    if nf:
                        a.write(b",")
                    a.write(
                        self._key_bytes(c)
                        + (b"true" if v.value else b"false")
                    )
                    nf += 1
            elif gq.math_expr is not None:
                v = c.math_vals.get(uid)
                if v is not None:
                    if nf:
                        a.write(b",")
                    a.write(self._key_bytes(c) + dumps_bytes(_json_val(v)))
                    nf += 1
            elif gq.aggregator:
                if uid in c.math_vals:  # per-parent aggregate
                    if nf:
                        a.write(b",")
                    a.write(
                        self._key_bytes(c)
                        + dumps_bytes(_json_val(c.math_vals[uid]))
                    )
                    nf += 1
                continue  # scalar aggregates emit at list level
            elif gq.val_var and not gq.aggregator:
                v = self.val_vars.get(gq.val_var, {}).get(uid)
                if v is not None:
                    if nf:
                        a.write(b",")
                    a.write(self._key_bytes(c) + dumps_bytes(_json_val(v)))
                    nf += 1
            elif gq.is_count:
                if gq.attr == "uid":
                    continue
                if self.schema is not None and (
                    self.schema.get(c.attr.lstrip("~")) is None
                ):
                    continue  # count() of an unschema'd predicate
                if nf:
                    a.write(b",")
                a.write(
                    self._key_bytes(c) + b"%d" % int(c.counts.get(uid, 0))
                )
                nf += 1
            elif c.groups is not None and gq.groupby_attrs:
                continue  # unreachable when streamable; kept for parity
            elif c.is_uid_pred:
                m = a.mark()
                if nf:
                    a.write(b",")
                if self._emit_uid_pred(a, c, row):
                    nf += 1
                else:
                    a.truncate(m)
            else:
                posts = c.values.get(uid)
                if posts:
                    su = self.schema.get(c.attr) if self.schema else None
                    if su is not None and su.value_type == TypeID.PASSWORD:
                        continue  # passwords never serialize
                    as_list = (
                        su.is_list if su is not None else len(posts) > 1
                    )
                    if nf:
                        a.write(b",")
                    a.write(self._key_bytes(c))
                    if as_list:
                        a.write(
                            b"["
                            + b",".join(
                                dumps_bytes(_json_val(p.val()))
                                for p in posts
                            )
                            + b"]"
                        )
                    else:
                        a.write(dumps_bytes(_json_val(posts[0].val())))
                    nf += 1
        a.write(b"}")
        return nf > 0

    def _emit_uid_pred(self, a: Arena, c: ExecNode, row: int) -> bool:
        """`"name": [...]` for one parent's edge row. Returns False when
        the dict encoder would omit the key entirely (no kids and no
        count rows). The caller has already written nothing but a
        possible separator; it rolls back on False."""
        if not c.children:
            return False  # selection-less uid pred emits nothing
        um = c.uid_matrix
        r = um[row] if row < len(um) else ()
        n_live = len(r)
        if not n_live:
            return False
        gq = c.gq
        count_children = [
            cc for cc in c.children
            if cc.gq.is_count and cc.gq.attr == "uid"
        ]
        has_count_row = any(
            not cc.gq.var_name for cc in count_children
        )
        su = self.schema.get(c.attr) if self.schema else None
        single = (
            su is not None
            and not su.is_list
            and not c.attr.startswith("~")
            and not gq.normalize
            and not has_count_row  # count rows need the list
        )
        a.write(self._key_bytes(c))
        if not single:
            a.write(b"[")
            plan = self._column_plan(c)
            if plan is not None:
                nk = self._write_columns(a, plan, r, False) if plan else 0
            else:
                nk = 0
                dest_idx = self._dest_idx(c)
                for v in r:
                    m = a.mark()
                    if nk:
                        a.write(b",")
                    if self._emit_entity_b(
                        a, c, int(v), dest_idx.get(int(v), 0)
                    ):
                        nk += 1
                    else:
                        a.truncate(m)
            # `friend { count(uid) }`: the row count appends as one
            # extra {"count": n} object in the child list
            for cc in count_children:
                if nk:
                    a.write(b",")
                a.write(
                    b"{" + self._key_bytes(cc) + b"%d" % n_live + b"}"
                )
                nk += 1
            if not nk:
                return False
            a.write(b"]")
            return True
        # non-list uid predicate encodes as ONE object: kids[0]
        dest_idx = self._dest_idx(c)
        for v in r:
            m = a.mark()
            if self._emit_entity_b(a, c, int(v), dest_idx.get(int(v), 0)):
                return True
            a.truncate(m)
        if count_children:
            # var-bound count(uid) rows still land in kids; with no
            # entity kids the first count row becomes kids[0]
            a.write(
                b"{" + self._key_bytes(count_children[0])
                + b"%d" % n_live + b"}"
            )
            return True
        return False

    def _dest_idx(self, c: ExecNode) -> Dict[int, int]:
        dest_idx = getattr(c, "_dest_idx", None)
        if dest_idx is None:
            dest_idx = c._dest_idx = {  # type: ignore
                int(x): j for j, x in enumerate(c.dest_uids)
            }
        return dest_idx

    # -- block-at-a-time bulk emitters -------------------------------------

    def _write_int_objs(self, a: Arena, pre: bytes, vals, sep: bool) -> int:
        """`{"c":5},{"c":3},...`: `pre`, each int64 of `vals` and `}`,
        in one native call where there are more than 32. Writes `,`
        first when `sep` and `vals` is not empty; returns the rows."""
        if not len(vals):
            return 0
        if sep:
            a.write(b",")
        self._column_rows += len(vals)
        if self._native is not None and vals.size > 32:
            out = self._native.enc_int_objs(vals, pre, b"}")
            if out is not None:
                METRICS.inc("stream_encode_native_bytes_total", len(out))
                a.write(out)
                return len(vals)
        a.write(b",".join([pre + b"%d}" % v for v in vals.tolist()]))
        return len(vals)

    def _uid_pre(self, leaf: ExecNode) -> bytes:
        pre = getattr(leaf, "_uid_pre_b", None)
        if pre is None:
            pre = leaf._uid_pre_b = (  # type: ignore
                b"{" + self._key_bytes(leaf) + b'"0x'
            )
        return pre

    def _write_uid_objs(self, a: Arena, leaf: ExecNode, uids) -> None:
        """`{"uid":"0x1"},{"uid":"0x2"},...` for a whole uid row — ONE
        native call per contiguous run instead of one Python dict per
        entity."""
        pre = self._uid_pre(leaf)
        post = b'"}'
        arr = np.asarray(uids, dtype=np.uint64)
        if self._native is not None and arr.size > 32:
            out = self._native.enc_uid_objs(arr, pre, post)
            if out is not None:
                METRICS.inc("stream_encode_native_bytes_total", len(out))
                a.write(out)
                return
        a.write(
            b",".join(pre + b"%x" % u + post for u in arr.tolist())
        )

    def _row_counts(self, cnt: ExecNode, uids: np.ndarray) -> np.ndarray:
        """Per-row count gather. When the level's length vector survived
        to encode time (subgraph stores `counts_vec` aligned with the
        parent's dest_uids), this is one vectorized searchsorted over
        the ragged level buffer instead of len(row) dict lookups."""
        vec = getattr(cnt, "counts_vec", None)
        if (
            vec is not None
            and cnt.parent_node is not None
            and vec[0] is cnt.parent_node.dest_uids
            and len(vec[0])
            and self._keys_ascending(cnt, vec[0])
        ):
            keys_arr, lens_arr = vec
            idx = np.searchsorted(keys_arr, uids)
            idx = np.minimum(idx, len(keys_arr) - 1)
            got = lens_arr[idx]
            # uids not present key as 0 (counts.get default)
            return np.where(keys_arr[idx] == uids, got, 0).astype(np.int64)
        cd = cnt.counts
        return np.fromiter(
            (cd.get(int(u), 0) for u in uids), np.int64, len(uids)
        )

    @staticmethod
    def _keys_ascending(cnt: ExecNode, keys) -> bool:
        """searchsorted needs strictly ascending keys — root orderasc/
        orderdesc reorders dest_uids by VALUE before child expansion,
        so the level vector's key array is not always uid-sorted.
        Checked once per count node (O(n) vs the O(n) gather it
        guards); unsorted keys take the dict-lookup path."""
        ok = getattr(cnt, "_counts_vec_sorted", None)
        if ok is None:
            ka = np.asarray(keys)
            ok = bool(len(ka) < 2 or bool(np.all(ka[:-1] < ka[1:])))
            cnt._counts_vec_sorted = ok  # type: ignore
        return ok

    def _write_columns(self, a: Arena, plan, uids, sep: bool) -> int:
        """The entities of `uids` under a `_column_plan`, built a column
        at a time: each child's fields in one pass over the rows, then
        each row's object in one join, and one write for the lot. A row
        whose every column is a hole is left out, as the dict encoder's
        `if obj:` leaves out an empty entity. Writes `,` first when
        `sep` and some row prints; returns the rows printed.

        A lone uid column goes to the native `enc_uid_objs`, a lone
        count or INT column to `enc_int_objs`; a value's first posting
        decodes in bulk where it is INT or BOOL, and any other type
        through the same `dumps_bytes(_json_val(...))` as an entity."""
        arr = np.asarray(uids, dtype=np.uint64)
        lone = len(plan) == 1
        if lone and plan[0][0] == _COL_UID:
            if sep:
                a.write(b",")
            self._write_uid_objs(a, plan[0][1], arr)
            self._column_rows += len(arr)
            return len(arr)
        rows = arr.tolist()
        cols = []
        for kind, c, key in plan:
            pre = key if lone else b"," + key
            if kind == _COL_UID:
                cols.append([pre + b'"0x%x"' % u for u in rows])
                continue
            have = None  # per row, whether it has a value; None: all do
            got, ints, shapes = (), None, ()
            if kind == _COL_COUNT:
                ints = self._row_counts(c, arr)
            else:
                firsts = [p[0] if p else None for p in map(c.values.get, rows)]
                got = [p for p in firsts if p is not None]
                if len(got) < len(firsts):
                    have = [p is not None for p in firsts]
                shapes = {(p.value_type, len(p.value)) for p in got}
                if shapes == {(TypeID.INT, 8)}:
                    ints = np.frombuffer(b"".join([p.value for p in got]), "<i8")
            if ints is not None and lone:
                return self._write_int_objs(a, b"{" + key, ints, sep)
            if ints is not None:
                vals = [b"%d" % v for v in ints.tolist()]
            elif shapes and {t for t, _ in shapes} == {TypeID.BOOL}:
                vals = [b"true" if p.value == b"\x01" else b"false" for p in got]
            else:
                vals = [dumps_bytes(_json_val(p.val())) for p in got]
            if have is None:
                cols.append([pre + v for v in vals])
            else:
                it = iter(vals)
                cols.append([pre + next(it) if h else b"" for h in have])
        if lone:
            objs = [f for f in cols[0] if f]
        else:  # each field led by its comma: drop the row's first
            objs = [r[1:] for r in map(b"".join, zip(*cols)) if r]
        if objs:
            if sep:
                a.write(b",")
            a.write(b"{" + b"},{".join(objs) + b"}")
        self._column_rows += len(objs)
        return len(objs)


def encode_data_bytes(
    nodes: List[ExecNode],
    val_vars=None,
    schema=None,
    stream: Optional[bool] = None,
    arena: Optional[Arena] = None,
    native_ok: bool = True,
) -> Arena:
    """The response `data` object as JSON bytes, appended to `arena`
    (a fresh one when None). `stream=None` reads the
    DGRAPH_TPU_STREAM_ENCODER escape hatch; False is the dict path —
    byte-identical by contract."""
    a = arena if arena is not None else Arena()
    if stream is None:
        stream = stream_enabled()
    if stream:
        StreamEncoder(
            val_vars=val_vars, schema=schema, native_ok=native_ok
        ).encode_blocks_into(nodes, a)
    else:
        enc = JsonEncoder(val_vars=val_vars, schema=schema)
        a.write(dumps_bytes(enc.encode_blocks(nodes)))
    return a


# ---------------------------------------------------------------------------
# Response-path integration: the servers' `data` payload carries its own
# wire bytes so response assembly SPLICES instead of re-serializing.
# ---------------------------------------------------------------------------


class RawData(dict):
    """Parsed response `data` dict carrying its own wire bytes.

    dict-API consumers (tests, subscriptions, the Python client path)
    see a normal dict; response assembly (http_server._reply /
    grpc_server) splices ``.raw`` — the exact compact-JSON bytes the
    encoder produced — instead of running the whole tree through
    json.dumps a second time."""

    def __init__(self, obj: Dict[str, Any], raw: bytes):
        super().__init__(obj)
        self.raw = raw


class RawJson:
    """Unparsed response `data`: wire bytes only (``want="raw"`` on the
    query entry points). The serving surface never needs the dict, so
    the compat parse-back is skipped entirely."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        self.raw = raw


def encode_response_data(
    nodes: List[ExecNode],
    val_vars=None,
    schema=None,
    stream: Optional[bool] = None,
    want: str = "dict",
    native_ok: bool = True,
) -> Tuple[Any, Dict[str, int]]:
    """Encode the executed tree into the response `data` payload.

    Returns ``(data, stats)``: `data` is a RawData dict (``want="dict"``,
    the in-process API) or a RawJson byte shell (``want="raw"``, the
    serving surface — no parse-back). Both carry ``.raw``, so response
    assembly splices the same bytes either way. `stats` attributes the
    work for server_latency/profile: ``encode_ns`` is the time to
    materialize the wire bytes (THE A/B quantity — on the dict path it
    covers encode_blocks + json.dumps, on the stream path the arena
    fill), ``parse_ns`` the dict-API compat parse-back (stream path
    only), ``bytes`` the payload size, ``stream`` which path ran."""
    if stream is None:
        stream = stream_enabled()
    t0 = _time.perf_counter()
    if stream:
        a = Arena()
        StreamEncoder(
            val_vars=val_vars, schema=schema, native_ok=native_ok
        ).encode_blocks_into(nodes, a)
        raw = a.to_bytes()
        obj = None
    else:
        enc = JsonEncoder(val_vars=val_vars, schema=schema)
        obj = enc.encode_blocks(nodes)
        raw = dumps_bytes(obj)
    t1 = _time.perf_counter()
    stats = {
        "encode_ns": int((t1 - t0) * 1e9),
        "bytes": len(raw),
        "stream": int(stream),
    }
    if want == "raw":
        return RawJson(raw), stats
    if obj is None:
        obj = json.loads(raw)
        stats["parse_ns"] = int((_time.perf_counter() - t1) * 1e9)
    return RawData(obj, raw), stats


def response_bytes(res: Dict[str, Any]) -> Optional[bytes]:
    """Assemble the full response body by splicing the pre-encoded
    `data` bytes into the envelope arena next to the compact-dumped
    extensions. None when `res` carries no raw data (schema blocks,
    truncated/error shapes) — the caller re-dumps as before."""
    raw = getattr(res.get("data"), "raw", None)
    if raw is None:
        return None
    a = Arena()
    a.write(b"{")
    first = True
    for k, v in res.items():
        if not first:
            a.write(b",")
        first = False
        a.write(dumps_bytes(k) + b":")
        a.write(raw if k == "data" else dumps_bytes(v))
    a.write(b"}")
    return a.to_bytes()
