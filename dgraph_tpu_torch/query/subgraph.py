"""SubGraph executor: level-batched query processing.

Mirrors dgraph/query/query.go (SubGraph:249, ProcessGraph:2156)
with the key TPU-first change (SURVEY.md §7.3): instead of one goroutine per
(attr, uid-chunk) like the reference (x.DivideAndRule, children spawned at
query.go:2459), the executor expands a whole level at a time and hands every
set operation of that level to the batch dispatcher in one call — filters
AND/OR/NOT combine row-wise via vmapped device kernels
(ref query.go:2355-2372 -> ops/setops.py).

Execution order of blocks follows variable dependencies
(ref query/query.go:2899 canExecute).
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.dql.parser import FilterTree, GraphQuery, Order
from dgraph_tpu_torch.posting.lists import LocalCache
from dgraph_tpu_torch.posting.pl import Posting
from dgraph_tpu_torch.query import ragged
from dgraph_tpu_torch.query.dispatch import DISPATCHER
from dgraph_tpu_torch.query.functions import (
    EMPTY,
    MAXUID,
    FuncRunner,
    QueryError,
    _as_uids,
)
from dgraph_tpu_torch.schema.schema import State
from dgraph_tpu_torch.types.types import TypeID, Val, compare_vals, convert
from dgraph_tpu_torch.utils import observe
from dgraph_tpu_torch.utils.observe import (
    METRICS,
    TRACER,
    current_plan,
    current_profile,
)
from dgraph_tpu_torch.x import config, keys

# ---------------------------------------------------------------------------
# Sibling-expansion worker pool (ref query.go ProcessGraph goroutine-per-
# child). One process-wide bounded pool, sized by DGRAPH_TPU_EXEC_WORKERS
# (0/1 = serial escape hatch). Only the OUTERMOST expansion of a query
# fans out — nested levels inside a worker run serially (a worker that
# blocks on its own nested futures could deadlock a bounded pool) — so the
# widest level gets the threads and the pool can never self-starve.
# ---------------------------------------------------------------------------

_EXPAND_POOLS: Dict[int, ThreadPoolExecutor] = {}
_EXPAND_POOL_LOCK = threading.Lock()
_EXPAND_TLS = threading.local()
# tasks submitted to a pool but not yet running — the pool's REAL
# backpressure (guarded by _EXPAND_POOL_LOCK, published as the
# exec_pool_queue_depth gauge). A submit that would push the backlog
# past workers * _POOL_QUEUE_BOUND is refused and the caller expands
# inline instead, so the queue can never grow without bound.
_POOL_QUEUED = 0
_POOL_QUEUE_BOUND = 4


def _exec_workers() -> int:
    return int(config.get("EXEC_WORKERS"))


def pool_backpressure() -> Tuple[int, int]:
    """(queued_not_started_tasks, configured_workers) — what admission
    control reads instead of guessing saturation from query counts."""
    with _EXPAND_POOL_LOCK:
        return _POOL_QUEUED, _exec_workers()


def _publish_pool_depth_locked() -> None:
    METRICS.set_gauge("exec_pool_queue_depth", float(_POOL_QUEUED))


def _submit_bounded(pool: ThreadPoolExecutor, workers: int, call, *args):
    """Bounded pool submit: returns a Future, or None when the pool's
    backlog is at the bound (the caller runs the task inline). The
    queued count drops when the task STARTS, so the gauge measures
    waiting work, not running work."""
    global _POOL_QUEUED
    with _EXPAND_POOL_LOCK:
        if _POOL_QUEUED >= workers * _POOL_QUEUE_BOUND:
            return None
        _POOL_QUEUED += 1
        _publish_pool_depth_locked()

    def _run():
        global _POOL_QUEUED
        with _EXPAND_POOL_LOCK:
            _POOL_QUEUED -= 1
            _publish_pool_depth_locked()
        return call(*args)

    try:
        return pool.submit(_run)
    except BaseException:
        with _EXPAND_POOL_LOCK:
            _POOL_QUEUED -= 1
            _publish_pool_depth_locked()
        raise


def _expand_pool(workers: int) -> ThreadPoolExecutor:
    # one pool per distinct width, never shut down mid-process: a query
    # holding a stale pool reference must keep submitting safely even if
    # another query re-reads a changed DGRAPH_TPU_EXEC_WORKERS (the set
    # of widths a deployment uses is tiny, so leaked idle threads are
    # bounded; they exit with the process)
    with _EXPAND_POOL_LOCK:
        pool = _EXPAND_POOLS.get(workers)
        if pool is None:
            pool = _EXPAND_POOLS[workers] = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="dgraph-tpu-expand",
            )
        return pool


@dataclass
class ExecNode:
    """Executed form of one GraphQuery node (ref query.SubGraph)."""

    gq: GraphQuery
    attr: str = ""
    src_uids: np.ndarray = field(default_factory=lambda: EMPTY)
    # one row per parent uid (aligned with parent's dest_uids)
    uid_matrix: List[np.ndarray] = field(default_factory=list)
    dest_uids: np.ndarray = field(default_factory=lambda: EMPTY)
    # value predicate reads: uid -> postings
    values: Dict[int, List[Posting]] = field(default_factory=dict)
    counts: Dict[int, int] = field(default_factory=dict)
    children: List["ExecNode"] = field(default_factory=list)
    is_uid_pred: bool = False
    math_vals: Dict[int, Val] = field(default_factory=dict)
    groups: Dict[int, List[dict]] = field(default_factory=dict)
    # value-variable levels (ref query.go variable propagation): vars whose
    # maps are keyed by THIS node's dest_uids, and ancestor-level vars
    # propagated down to this level (summed over all paths)
    own_vars: set = field(default_factory=set)
    level_vars: Dict[str, Dict[int, Val]] = field(default_factory=dict)
    parent_node: Optional["ExecNode"] = None
    # inside a @cascade subtree: pagination defers until after pruning
    under_cascade: bool = False


class Executor:
    def __init__(
        self,
        cache: LocalCache,
        st: State,
        ns: int = keys.GALAXY_NS,
        vector_indexes=None,
        allowed_preds=None,
        stats=None,
        deadline: Optional[float] = None,
        batcher=None,
    ):
        self.cache = cache
        self.st = st
        self.ns = ns
        self.stats = stats
        # cross-query micro-batcher (serving/microbatch.py): when set,
        # level-task reads may coalesce with other in-flight queries at
        # the same read snapshot; None = today's direct path
        self.batcher = batcher
        # absolute time.monotonic() budget (ref x/limits query timeout);
        # checked at block and expansion boundaries
        self.deadline = deadline
        self.vector_indexes = vector_indexes or {}
        # None = unrestricted; a set filters expand(_all_) expansion to
        # ACL-readable predicates (ref expand filtering in edgraph auth)
        self.allowed_preds = allowed_preds
        # level-batched task reads (uids_many/values_many); the per-uid
        # escape hatch exists for A/B benchmarking (level_batch_read_calls)
        self.level_batch = bool(config.get("LEVEL_BATCH"))
        # sibling fan-out width; 0/1 = serial (resolved per Executor so
        # tests can flip the env between queries)
        self.exec_workers = _exec_workers()
        self.uid_vars: Dict[str, np.ndarray] = {}
        # vars whose stored order is MEANINGFUL (shortest-path vars hold
        # path order; uid(var) roots preserve it — ref TestShortestPathRev)
        self.ordered_uid_vars: set = set()
        # value vars; scalar (block-wide) vars broadcast via key MAXUID
        # (ref query.go:1593 count-var stored at math.MaxUint64)
        self.val_vars: Dict[str, Dict[int, Val]] = {}
        # where each value var is keyed (for per-parent aggregation)
        self.var_def_node: Dict[str, ExecNode] = {}
        # cost-based planner (query/planner.py): whole-query evaluation
        # ordering + intersect-vs-filter strategy, observation-
        # equivalent by construction; None = declaration-order
        # execution (the DGRAPH_TPU_QUERY_PLANNER=0 A/B escape hatch)
        from dgraph_tpu_torch.query.planner import Planner, planner_enabled

        self.planner = (
            Planner(
                st, stats, ns,
                uid_vars=self.uid_vars, val_vars=self.val_vars,
            )
            if planner_enabled()
            else None
        )

    def _runner(self) -> FuncRunner:
        return FuncRunner(
            self.cache,
            self.st,
            self.ns,
            vector_indexes=self.vector_indexes,
            uid_vars=self.uid_vars,
            val_vars=self.val_vars,
            stats=self.stats,
            ordered_uid_vars=self.ordered_uid_vars,
            batcher=self.batcher,
            planner=self.planner,
        )

    # ------------------------------------------------------------------
    # Block orchestration (ref query.Request.Process query.go:3046)
    # ------------------------------------------------------------------

    def _check_deadline(self):
        if self.deadline is not None:
            import time as _time

            if _time.monotonic() > self.deadline:
                from dgraph_tpu_torch.query.functions import QueryBudgetError

                raise QueryBudgetError("query exceeded its time budget")

    def process(self, blocks: List[GraphQuery]) -> List[ExecNode]:
        pending = list(blocks)
        executed: List[ExecNode] = [None] * len(blocks)  # type: ignore
        idx = {id(b): i for i, b in enumerate(blocks)}
        while pending:
            progress = True
            while pending and progress:
                progress = False
                still = []
                for b in pending:
                    self._check_deadline()
                    if self._deps_ready(b):
                        node = self.execute_block(b)
                        executed[idx[id(b)]] = node
                        progress = True
                    else:
                        still.append(b)
                pending = still
            if not pending:
                break
            # a var declared in an EXECUTED block but never bound (its
            # defining predicate matched nothing / isn't in the schema)
            # resolves to the empty set, like the reference's nil
            # DestUIDs (ref TestGroupBy_FixPanicForNilDestUIDs). Vars
            # declared only in still-pending blocks stay unresolved — a
            # dependency cycle must error, not silently empty out.
            pending_ids = {id(b) for b in pending}
            ran = [b for b in blocks if id(b) not in pending_ids]
            declared = self._declared_vars(ran)
            fixable = set()
            for b in pending:
                for d in self._block_deps(b):
                    if (
                        d not in self.uid_vars
                        and d not in self.val_vars
                        and d in declared
                    ):
                        fixable.add(d)
            if not fixable:
                raise QueryError(
                    f"unresolved query variables in blocks: "
                    f"{[b.attr for b in pending]}"
                )
            for d in fixable:
                self.uid_vars[d] = EMPTY
        return executed

    def _declared_vars(self, blocks: List[GraphQuery]) -> set:
        out: set = set()

        def walk(g):
            if g.var_name:
                out.add(g.var_name)
            out.update(g.facet_vars.keys())
            for c in g.children:
                walk(c)

        for b in blocks:
            walk(b)
        return out

    def _block_deps(self, gq: GraphQuery) -> set:
        deps = set()
        defined = set()

        def from_func(fn):
            if fn is None:
                return
            if fn.uid_var:
                deps.update(fn.uid_var.split(","))
            if fn.val_var:
                deps.add(fn.val_var)

        def from_filter(ft):
            if ft is None:
                return
            from_func(ft.func)
            for c in ft.children:
                from_filter(c)

        def walk(g):
            from_func(g.func)
            from_filter(g.filter)
            for o in g.order:
                if o.val_var:
                    deps.add(o.val_var)
            if g.val_var:
                deps.add(g.val_var)
            if g.math_expr is not None:
                from dgraph_tpu_torch.query.matheval import math_vars

                deps.update(math_vars(g.math_expr))
            if isinstance(g.shortest_from, tuple):
                deps.add(g.shortest_from[1])
            if isinstance(g.shortest_to, tuple):
                deps.add(g.shortest_to[1])
            if g.expand.startswith("val:"):
                deps.add(g.expand[4:])
            if g.var_name:
                defined.add(g.var_name)
            defined.update(g.facet_vars.keys())
            for c in g.children:
                walk(c)

        walk(gq)
        return deps - defined  # intra-block vars resolve during execution

    def _deps_ready(self, gq: GraphQuery) -> bool:
        return all(
            d in self.uid_vars or d in self.val_vars
            for d in self._block_deps(gq)
        )

    # ------------------------------------------------------------------
    # One block
    # ------------------------------------------------------------------

    def execute_block(self, gq: GraphQuery) -> ExecNode:
        if gq.attr == "shortest":
            return self._shortest_block(gq)

        runner = self._runner()
        if gq.func is None:
            # func-less block: `me() { sum(val(a)) }` — aggregate-root /
            # math-only blocks operate on var maps with no uid set
            # (ref query.go Params.IsEmpty aggregate-root handling)
            node = ExecNode(gq=gq, attr=gq.attr, dest_uids=EMPTY)
            return self._finish_block(gq, node, skip_order=True)
        if gq.func.name == "eq" and gq.func.val_var:
            # eq(val(x), v): keep uids whose var value == arg
            want = gq.func.args[0]
            vals = self.val_vars.get(gq.func.val_var, {})
            root = _as_uids(u for u in vals if _vals_equal(vals[u], want))
            if gq.filter is not None:
                root = self.eval_filter(gq.filter, root)
        else:
            pre_g = self._try_reverse_only_groupby(gq)
            if pre_g is not None:
                return pre_g
            pre = self._try_index_only_order(gq)
            if pre is not None:
                node = ExecNode(gq=gq, attr=gq.attr, dest_uids=pre)
                node.dest_uids = _paginate(
                    node.dest_uids, gq.first, gq.offset, gq.after
                )
                return self._finish_block(gq, node, skip_order=True)
            root = self._run_root_filtered(gq)

        node = ExecNode(gq=gq, attr=gq.attr, dest_uids=root)
        return self._finish_block(gq, node)

    def _selective_seed(self, ft: FilterTree) -> Optional[np.ndarray]:
        """A cheap rootless candidate set from the filter tree: uid(...)
        literals/vars, or uid_in over a @reverse predicate (answered from
        the targets' reverse lists). Used to invert has()-root plans
        (ref worker/task.go planning: run the selective side first)."""
        if ft.func is not None:
            fn = ft.func
            if fn.name == "uid":
                return self._runner()._run(fn, src=None)
            if fn.name == "uid_in" and fn.attr:
                su = self.st.get(fn.attr)
                if su is not None and su.directive_reverse:
                    return self._runner()._run(fn, src=None)
            return None
        if ft.op == "and":
            for c in ft.children:
                got = self._selective_seed(c)
                if got is not None:
                    return got
        return None

    def _run_root_filtered(self, gq: GraphQuery) -> np.ndarray:
        """Root + filter with plan inversion: a has() root whose filter
        carries a selective seed verifies has() per candidate instead of
        scanning the whole tablet."""
        runner = self._runner()
        if gq.func.name == "has" and gq.filter is not None and not gq.func.attr.startswith("~"):
            seed = self._selective_seed(gq.filter)
            if seed is not None:
                attr = gq.func.attr
                skeys = [
                    keys.DataKey(attr, int(u), self.ns) for u in seed
                ]
                self.cache.prefetch(skeys)
                root = _as_uids(
                    int(u)
                    for u, k in zip(seed, skeys)
                    if self.cache.has(k)
                )
                return self.eval_filter(gq.filter, root)
        root = runner.run_root(gq.func)
        if gq.filter is not None:
            root = self.eval_filter(gq.filter, root)
        return root

    def _try_reverse_only_groupby(self, gq: GraphQuery) -> Optional[ExecNode]:
        """has(X) @groupby(X) with @reverse and count-only children: the
        buckets ARE the reverse lists — zero tablet scans, one read per
        DISTINCT target (groupby.go over the index, degenerate case)."""
        if (
            gq.func is None
            or gq.func.name != "has"
            or gq.filter is not None
            or gq.order
            or gq.var_name
            or gq.first is not None
            or gq.offset
            or gq.after
            or gq.groupby_attrs != [gq.func.attr]
        ):
            return None
        if any(
            not (c.is_count and c.attr == "uid") or c.var_name
            for c in gq.children
        ):
            return None
        su = self.st.get(gq.func.attr)
        if su is None or su.value_type != TypeID.UID or not su.directive_reverse:
            return None
        attr = gq.func.attr
        buckets = []
        for k, _, _ in self.cache.kv.iterate(
            keys.ReversePrefix(attr, self.ns), self.cache.read_ts
        ):
            pk = keys.parse_key(k)
            n = len(self.cache.uids(k))
            if n:
                buckets.append(((int(pk.uid),), {attr: hex(pk.uid), "count": n}))
        node = ExecNode(gq=gq, attr=gq.attr)
        node.root_groups = [  # type: ignore[attr-defined]
            b for _, b in sorted(buckets, key=lambda kb: str(kb[0]))
        ]
        return node

    def _try_index_only_order(self, gq: GraphQuery) -> Optional[np.ndarray]:
        """has(X) ordered by X with a sortable index: every bucket member
        IS a candidate, so the ordered result comes straight off the index
        walk — no tablet scan (sortWithIndex without the intersect)."""
        if (
            gq.func is None
            or gq.func.name != "has"
            or gq.filter is not None
            or len(gq.order) != 1
            or gq.order[0].attr != gq.func.attr
            or gq.order[0].val_var
            or gq.order[0].lang
            or gq.func.attr.startswith("~")
        ):
            return None
        o = gq.order[0]
        su = self.st.get(o.attr)
        if su is None:
            return None
        tk = next((t for t in su.tokenizer_objs() if t.is_sortable), None)
        if tk is None:
            return None
        need = None
        if gq.first is not None and gq.first >= 0 and gq.after is None:
            need = (gq.offset or 0) + gq.first
        prefix = keys.IndexPrefix(o.attr, self.ns)
        ident = bytes([tk.identifier])
        bucket_keys = [
            k
            for k, _, _ in self.cache.kv.iterate(prefix, self.cache.read_ts)
            if keys.parse_key(k).term.startswith(ident)
        ]
        if o.desc:
            bucket_keys.reverse()
        out: List[int] = []
        tail: List[int] = []  # in a bucket but no untagged sort value
        emitted: set = set()
        for bk in bucket_keys:
            if need is not None and len(out) >= need:
                break
            sel = self.cache.uids(bk)
            sel = [int(u) for u in sel if int(u) not in emitted]
            if not sel:
                continue
            emitted.update(sel)
            if su.lang:
                # sorting reads the UNTAGGED value (ref worker/sort.go):
                # - lang-tagged-only nodes sort after every valued one;
                # - a node whose tagged value landed it in THIS bucket
                #   but whose untagged value tokenizes elsewhere emits
                #   from its own bucket, not here.
                # Without @lang every posting is untagged and always
                # matches its own bucket — skip the per-uid reads.
                from dgraph_tpu_torch.posting.mutation import build_tokens

                term = keys.parse_key(bk).term
                dkeys = [keys.DataKey(o.attr, u, self.ns) for u in sel]
                self.cache.prefetch(dkeys)
                valued = []
                for u, dk in zip(sel, dkeys):
                    posts = self.cache.values(dk)
                    untagged = [p for p in posts if p.lang == ""]
                    if not untagged:
                        tail.append(u)
                        continue
                    toks = build_tokens(untagged[0].val(), [tk])
                    if term not in toks:
                        emitted.discard(u)  # emits from its own bucket
                        continue
                    valued.append(u)
                if not valued:
                    continue
            else:
                valued = sel
            sel_np = np.array(valued, dtype=np.uint64)
            if tk.is_lossy and len(sel_np) > 1:
                sub = GraphQuery(attr=gq.attr)
                sub.order = [Order(attr=o.attr, desc=o.desc)]
                sel_np = self._order_uids_generic(sub, sel_np)
            out.extend(int(u) for u in sel_np)
        if need is None or len(out) < need:
            out.extend(tail)
        return np.array(out, dtype=np.uint64)

    def _finish_block(
        self, gq: GraphQuery, node: ExecNode, skip_order: bool = False
    ) -> ExecNode:
        # ordering & pagination at root (ref applyOrderAndPagination :2511);
        # @cascade defers pagination until after the subtree is pruned
        if not skip_order:
            if gq.cascade:
                if gq.order:
                    node.dest_uids = self._order_uids(
                        gq, node.dest_uids, full=True
                    )
            else:
                node.dest_uids = self._order_and_paginate(gq, node.dest_uids)

        plan = current_plan()
        if plan is not None:
            # the block's root node anchors the plan tree: level-1
            # children link to it by ExecNode identity. uids_out is the
            # post-order/pagination root set (@cascade pruning happens
            # later and is reflected in the children's own counts).
            fn = gq.func
            plan.note_node(
                {
                    "id": id(node),
                    "parent": None,
                    "attr": gq.attr or "(block)",
                    "level": 0,
                    "func": fn.name if fn is not None else None,
                    "uids_in": 0,
                    "uids_out": int(len(node.dest_uids)),
                    "read": "root",
                    "wall_ns": 0,
                    "kernels": {},
                }
            )

        if gq.var_name:
            self.uid_vars[gq.var_name] = node.dest_uids

        # `f as count(uid)`: the block's row count as a broadcast scalar
        # var (ref query.go count-uid var; math(f) sees the constant)
        if not gq.groupby_attrs:
            for c in gq.children:
                if c.is_count and c.attr == "uid" and c.var_name:
                    self.val_vars[c.var_name] = {
                        MAXUID: Val(TypeID.INT, int(len(node.dest_uids)))
                    }

        if gq.groupby_attrs:
            # root-level @groupby: group the block's own result set
            # (ref query/groupby.go processGroupBy on the root SubGraph)
            fake_parent = ExecNode(
                gq=gq, dest_uids=np.array([0], dtype=np.uint64)
            )
            fake_child = ExecNode(gq=gq, uid_matrix=[node.dest_uids])
            self._group_children(gq, fake_child, fake_parent)
            node.root_groups = fake_child.groups.get(0, [])  # type: ignore
            return node

        return self._finish_expand(gq, node)

    def _finish_expand(self, gq: GraphQuery, node: ExecNode) -> ExecNode:

        if gq.recurse:
            self._expand_recurse(node)
        else:
            self._expand_children(node)

        if gq.cascade:
            self._apply_cascade(node)
        else:
            self._apply_child_cascades(node)
        return node

    # ------------------------------------------------------------------
    # Filters (ref query.go:2355-2372) — batched set ops
    # ------------------------------------------------------------------

    def eval_filter(self, ft: FilterTree, src: np.ndarray) -> np.ndarray:
        if ft.func is not None:
            return self._runner().run_filter(ft.func, src)
        if ft.op == "not":
            inner = self.eval_filter(ft.children[0], src)
            return DISPATCHER.run_pairs("difference", [(src, inner)])[0]
        # planner-ordered AND narrowing: cheapest/most-selective arm
        # first, each arm seeing the RUNNING intersection as its
        # candidate set. Byte-identical for pure-selection subtrees
        # (query/planner.py order_and) — the whole-query lift of the
        # scan-site rarest-first heuristic. Every arm still EVALUATES
        # (against the narrowed — possibly empty — set, never more
        # work than the unordered path's full src): an arm whose
        # schema/index/argument checks raise must raise with the
        # planner on too. Which error surfaces when several arms are
        # broken is declaration-order on the unordered path, so any
        # arm failure falls back to it — re-execution is safe (pure
        # selections) and errors are rare.
        if (
            self.planner is not None
            and ft.op == "and"
            and len(ft.children) > 1
            and self.planner.tree_pure(ft)
        ):
            from dgraph_tpu_torch.query.functions import QueryBudgetError

            order = self.planner.order_and(ft.children, len(src))
            try:
                cur = np.asarray(src, np.uint64)
                for i in order:
                    cur = self.eval_filter(ft.children[i], cur)
                return np.asarray(cur, np.uint64)
            except QueryBudgetError:
                raise  # deadline trips abort immediately
            except Exception:
                # declaration-order fallback: surface the SAME error
                # the unordered path would (broad catch on purpose —
                # coercion ValueErrors etc. are part of the observable
                # error surface, not just QueryError)
                parts = [self.eval_filter(c, src) for c in ft.children]
                return DISPATCHER.run_chain("intersect", parts).astype(
                    np.uint64
                )
        # whole AND/OR chain in ONE device dispatch (intersect_many /
        # k-way merge), not k-1 sequential pairwise calls
        parts = [self.eval_filter(c, src) for c in ft.children]
        op = "intersect" if ft.op == "and" else "union"
        return DISPATCHER.run_chain(op, parts).astype(np.uint64)

    def _eval_filter_root(self, ft: FilterTree) -> np.ndarray:
        """Rootless filter-tree evaluation (the pushdown strategy's
        candidate set): every leaf runs with src=None, arms combine
        with one chained set op. Callers guarantee the tree passed
        planner.tree_pushdown_ok (no NOT, whitelisted leaves)."""
        if ft.func is not None:
            out = np.asarray(
                self._runner()._run(ft.func, src=None), np.uint64
            )
            if len(out) > 1 and not bool(np.all(out[:-1] < out[1:])):
                out = np.unique(out)  # e.g. path-ordered uid(var) roots
            return out
        parts = [self._eval_filter_root(c) for c in ft.children]
        op = "intersect" if ft.op == "and" else "union"
        return DISPATCHER.run_chain(op, parts).astype(np.uint64)

    # ------------------------------------------------------------------
    # Child expansion — the batched fan-out
    # ------------------------------------------------------------------

    def _pred_is_uid(self, attr: str) -> bool:
        su = self.st.get(attr)
        return su is not None and su.value_type == TypeID.UID

    def _expand_children(self, node: ExecNode, depth: int = 0):
        self._check_deadline()
        gqs = list(node.gq.children)
        # expand(_all_)/expand(Type) -> concrete children (ref query.go:2038)
        gqs = self._resolve_expand(gqs, node.dest_uids)
        # two phases, preserving output order: structural children (and
        # their subtrees) first so sibling math/aggregate nodes can consume
        # vars defined anywhere below (ref query.go dependency execution)
        made: Dict[int, ExecNode] = {}
        deferred = []
        structural = []
        for cgq in gqs:
            if cgq.math_expr is not None or (cgq.aggregator and cgq.val_var):
                deferred.append(cgq)
            else:
                structural.append(cgq)
        # sibling fan-out (ref query.go:2459 one goroutine per child):
        # var-FREE subtrees expand concurrently — they neither read nor
        # write uid_vars/val_vars, so any interleaving reproduces the
        # serial result bit-for-bit. Var-touching siblings stay serial in
        # declaration order (serial semantics are order-sensitive there).
        results: Dict[int, Tuple[str, Any]] = {}
        workers = self.exec_workers
        can_par = workers > 1 and not getattr(
            _EXPAND_TLS, "in_worker", False
        )
        # the O(subtree) var-dependency classification is needed only
        # by the planner and the parallel path — the plain serial
        # executor must not pay it per expansion
        var_free = (
            [not self._gq_touches_vars(cgq) for cgq in structural]
            if (self.planner is not None or can_par)
            and len(structural) > 1
            else None
        )
        # planner: var-free structural children execute cheapest-first
        # (estimated fan-out x subtree size) — var-touching children
        # keep declaration order, and output order is restored from
        # `made` below, so execution order is observation-equivalent
        # (the same commutation test_parallel_exec.py already proves
        # for the parallel path)
        exec_structural = structural
        reordered = False
        if self.planner is not None and var_free is not None:
            order = self.planner.order_siblings(
                structural, var_free, len(node.dest_uids)
            )
            reordered = order != list(range(len(structural)))
            if reordered:
                exec_structural = [structural[i] for i in order]
        # only non-worker threads submit (and wait on) futures; workers
        # expand their subtrees serially — a bounded pool whose workers
        # block on their own nested futures could self-starve
        if can_par:
            par = (
                [
                    cgq
                    for cgq, free in zip(structural, var_free)
                    if free
                ]
                if var_free is not None
                else [
                    cgq
                    for cgq in structural
                    if not self._gq_touches_vars(cgq)
                ]
            )
            if len(par) > 1:
                pool = _expand_pool(workers)
                # each subtree runs under a COPY of this context so
                # worker threads inherit the query's span parent and
                # profile instead of starting orphan traces; a full
                # pool backlog refuses the submit (fut None) and the
                # subtree expands inline on the serial path below
                futs = []
                for cgq in par:
                    fut = _submit_bounded(
                        pool, workers,
                        contextvars.copy_context().run,
                        self._expand_one_worker, node, cgq, depth,
                    )
                    if fut is not None:
                        futs.append((cgq, fut))
                METRICS.inc("exec_parallel_siblings", len(futs))
                prof = current_profile()
                if prof is not None:
                    prof.note_queue_depth(pool_backpressure()[0])
                for cgq, fut in futs:
                    try:
                        results[id(cgq)] = ("ok", fut.result())
                    except Exception as exc:  # re-raised in decl order
                        results[id(cgq)] = ("err", exc)
        # error fidelity under reordering: the declaration-order path
        # raises the FIRST failing sibling's error and never executes
        # the rest. When the planner reordered execution, collect
        # per-sibling errors and re-raise the earliest-DECLARED one —
        # the same error the unreordered path surfaces (budget trips
        # still abort immediately: they are a whole-query deadline,
        # not an arm-specific failure).
        from dgraph_tpu_torch.query.functions import QueryBudgetError

        decl_idx = {id(c): i for i, c in enumerate(structural)}
        sib_errors: Dict[int, BaseException] = {}
        for cgq in exec_structural:
            if sib_errors and decl_idx[id(cgq)] > min(sib_errors):
                # the declaration-order path never executes siblings
                # declared AFTER a failing one — skip them here too
                # (only earlier-declared siblings can still change
                # which error surfaces)
                continue
            got = results.get(id(cgq))
            if got is not None:
                status, val = got
                if status == "err":
                    if not reordered or isinstance(val, QueryBudgetError):
                        raise val
                    sib_errors[decl_idx[id(cgq)]] = val
                    continue
                cnode = val
            else:
                if not reordered:
                    cnode = self._expand_one(node, cgq, depth)
                else:
                    try:
                        cnode = self._expand_one(node, cgq, depth)
                    except QueryBudgetError:
                        raise
                    except Exception as exc:
                        sib_errors[decl_idx[id(cgq)]] = exc
                        continue
            if cnode is not None:
                made[id(cgq)] = cnode
        if sib_errors:
            raise sib_errors[min(sib_errors)]
        for cgq in deferred:
            cnode = self._make_child(node, cgq)
            if cnode is not None:
                made[id(cgq)] = cnode
        node.children.extend(
            made[id(g)] for g in gqs if id(g) in made
        )

    def _expand_one(
        self, node: ExecNode, cgq: GraphQuery, depth: int
    ) -> Optional[ExecNode]:
        """One structural child: make it, then descend its subtree
        (descend even with no dest uids — the subtree may define vars
        later blocks depend on, as empty bindings)."""
        cnode = self._make_child(node, cgq)
        if cnode is not None and cnode.is_uid_pred and cgq.children:
            self._propagate_level_vars(node, cnode)
            self._expand_children(cnode, depth + 1)
        return cnode

    def _expand_one_worker(
        self, node: ExecNode, cgq: GraphQuery, depth: int
    ) -> Optional[ExecNode]:
        _EXPAND_TLS.in_worker = True
        try:
            return self._expand_one(node, cgq, depth)
        finally:
            _EXPAND_TLS.in_worker = False

    def _gq_touches_vars(self, g: GraphQuery) -> bool:
        """True when the subtree rooted at `g` defines OR consumes query
        variables (uid vars, val vars, facet vars) anywhere — those
        children must run serially in declaration order; everything else
        is safe to expand concurrently."""

        def func_vars(fn) -> bool:
            if fn is None:
                return False
            if fn.uid_var or fn.val_var:
                return True
            # val(x) as a comparison ARGUMENT — ge(age, val(x)) — is
            # stored as a ("valarg", name) tuple in fn.args, not val_var
            return any(
                isinstance(a, tuple) and len(a) == 2 and a[0] == "valarg"
                for a in fn.args
            )

        def tree_vars(ft) -> bool:
            if ft is None:
                return False
            if hasattr(ft, "args"):  # a bare FuncSpec leaf (facet filter)
                return func_vars(ft)
            if ft.func is not None and func_vars(ft.func):
                return True
            return any(tree_vars(c) for c in ft.children)

        if (
            g.var_name
            or g.val_var
            or g.aggregator
            or g.math_expr is not None
            or g.facet_vars
            or g.expand.startswith("val:")
        ):
            return True
        if any(o.val_var for o in g.order):
            return True
        if func_vars(g.func) or tree_vars(g.filter) or tree_vars(
            g.facet_filter
        ):
            return True
        return any(self._gq_touches_vars(c) for c in g.children)

    def _propagate_level_vars(self, node: ExecNode, cnode: ExecNode):
        """Push value vars available at `node`'s level one hop down into
        `cnode`'s level, summing over all parent paths (ref query.go
        variable propagation: a var used deeper than its definition takes
        the path-sum of ancestor values)."""
        avail: Dict[str, Dict[int, Val]] = dict(node.level_vars)
        for v in node.own_vars:
            if v in self.val_vars:
                avail[v] = self.val_vars[v]
        if not avail:
            return
        src_idx = {int(u): i for i, u in enumerate(node.dest_uids)}
        for v, vmap in avail.items():
            prop: Dict[int, float] = {}
            for p, i in src_idx.items():
                pv = vmap.get(p)
                if pv is None or i >= len(cnode.uid_matrix):
                    continue
                x = pv.value
                if isinstance(x, bool) or not isinstance(x, (int, float)):
                    continue
                for d in cnode.uid_matrix[i]:
                    prop[int(d)] = prop.get(int(d), 0) + x
            cnode.level_vars[v] = {
                u: Val(
                    TypeID.INT if isinstance(x, int) else TypeID.FLOAT, x
                )
                for u, x in prop.items()
            }

    @staticmethod
    def _level_of(parent: ExecNode) -> int:
        """Depth of the parent chain (root reads are level 1)."""
        level = 1
        p = parent
        while getattr(p, "parent_node", None) is not None:
            level += 1
            p = p.parent_node
        return level

    def _record_level_task(
        self, attr: str, parent: ExecNode, parents: int, t0: float,
        uids_out: int = 0, decoded_bytes: int = 0,
    ) -> None:
        """Attribute one (predicate, level) task: always-on per-tablet
        traffic accounting (read tasks, uids, decoded bytes, latency
        EWMA — the traffic-driven rebalancer's signal) plus the active
        query profile when one is collecting."""
        ms = (time.perf_counter() - t0) * 1e3
        if observe.tablet_traffic_enabled():
            observe.TABLETS.note_read(
                self.ns, attr, 1, uids_out, decoded_bytes, 0, ms
            )
        prof = current_profile()
        if prof is None:
            return
        prof.record_level_task(
            attr, self._level_of(parent), parents, ms, self.level_batch,
        )

    def _record_plan_node(
        self, cnode: ExecNode, parent: ExecNode, attr: str,
        uids_in: int, uids_out: int, t0: float, k0, read: str,
        est_out: Optional[int] = None,
    ) -> None:
        """One EXPLAIN plan-tree node (debug-mode queries only): uids
        in/out, read strategy, wall-ns over the whole child build
        (read + filter + pagination), and this THREAD's kernel-count
        deltas since `k0` (the packed_setops counters are per-thread,
        and one child builds entirely on one thread, so the delta is
        exactly this node's kernel mix)."""
        plan = current_plan()
        if plan is None:
            return
        from dgraph_tpu_torch.ops import packed_setops

        kernels = {}
        if k0 is not None:
            k1 = packed_setops.counters()
            kernels = {
                k: k1[k] - k0.get(k, 0)
                for k in k1
                if isinstance(k1[k], (int, float)) and k1[k] != k0.get(k, 0)
            }
        plan.note_node(
            {
                "id": id(cnode),
                "parent": id(parent),
                "attr": attr,
                "level": self._level_of(parent),
                "uids_in": int(uids_in),
                "uids_out": int(uids_out),
                # planner's PRE-execution cardinality estimate (None =
                # cold CardBook) — the EXPLAIN est-vs-actual column
                "est_out": est_out,
                "read": read,
                "wall_ns": int((time.perf_counter() - t0) * 1e9),
                "kernels": kernels,
            }
        )

    def _make_child(self, parent: ExecNode, cgq: GraphQuery) -> Optional[ExecNode]:
        attr = cgq.attr
        if cgq.math_expr is not None:
            return self._make_math_child(parent, cgq)
        if cgq.aggregator and cgq.val_var:
            return self._make_agg_child(parent, cgq)
        if cgq.checkpwd_val is not None:
            return self._make_checkpwd_child(parent, cgq)
        if cgq.is_uid or cgq.aggregator or cgq.val_var or (cgq.is_count and attr == "uid"):
            if cgq.is_uid and cgq.var_name:
                # `f as uid`: bind the enclosing level's uids as a uid var
                # (ref query.go uid-var on the uid leaf)
                self.uid_vars[cgq.var_name] = parent.dest_uids
            if (
                cgq.is_count
                and attr == "uid"
                and cgq.var_name
                and not parent.gq.groupby_attrs  # groupby binds per-group
            ):
                # `s as count(uid)` at a child level: the level's row count
                # as a broadcast scalar (ref query.go:1579 count-uid var)
                self.val_vars[cgq.var_name] = {
                    MAXUID: Val(TypeID.INT, int(len(parent.dest_uids)))
                }
            return ExecNode(gq=cgq, attr=attr, src_uids=parent.dest_uids)

        reverse = attr.startswith("~")
        su = self.st.get(attr[1:] if reverse else attr)
        cnode = ExecNode(gq=cgq, attr=attr, src_uids=parent.dest_uids)
        cnode.parent_node = parent
        # EXPLAIN capture (debug queries only): wall clock + this
        # thread's kernel counters over the whole child build
        _plan = current_plan()
        _plan_t0 = time.perf_counter()
        _plan_k0 = None
        _plan_est = None
        if _plan is not None:
            from dgraph_tpu_torch.ops import packed_setops

            _plan_k0 = packed_setops.counters()
            if self.planner is not None:
                _plan_est = self.planner.estimate_level_out(
                    attr, len(parent.dest_uids)
                )
        cnode.under_cascade = (
            parent.under_cascade or parent.gq.cascade or cgq.cascade
        )
        if su is not None and (su.value_type == TypeID.UID or reverse):
            if reverse and not su.directive_reverse:
                raise QueryError(f"predicate {attr[1:]!r} has no @reverse index")
            cnode.is_uid_pred = True
            level_keys = [
                keys.ReverseKey(attr[1:], int(u), self.ns)
                if reverse
                else keys.DataKey(attr, int(u), self.ns)
                for u in parent.dest_uids
            ]
            # ONE task per (predicate, level): the whole parent list reads
            # in a single batched call returning the ragged (flat, offsets)
            # level buffer (ref worker/task.go one task per attr; the
            # per-uid loop is the DGRAPH_TPU_LEVEL_BATCH=0 escape hatch)
            t0 = time.perf_counter()
            with TRACER.span(
                "level_task", attr=attr, parents=len(level_keys)
            ):
                METRICS.inc("level_tasks_started")
                METRICS.inc("level_task_uids", len(level_keys))
                if self.level_batch:
                    if self.batcher is not None:
                        # cross-query coalescing: this level read may
                        # ride one combined dispatch with same-shape
                        # tasks from other in-flight queries
                        flat, offs, row_toks = self.batcher.read_uids(
                            attr, self.cache, level_keys
                        )
                    else:
                        flat, offs, row_toks = self.cache.uids_many(
                            level_keys
                        )
                else:
                    self.cache.prefetch(level_keys)
                    rows = []
                    row_toks = []
                    for key in level_keys:
                        r, tok = self.cache.uids_tok(key)
                        rows.append(r)
                        row_toks.append(tok)
                    flat, offs = ragged.pack_rows(rows)
            self._record_level_task(
                attr, parent, len(level_keys), t0,
                uids_out=len(flat), decoded_bytes=int(flat.nbytes),
            )
            if self.planner is not None:
                self.planner.note_level(attr, len(level_keys), len(flat))
            if cgq.filter is not None:
                # intersect-vs-filter strategy per level: when the
                # planner says the filter's match set is index-
                # answerable and smaller than the frontier, push it
                # below the fan-out — evaluate rootless and intersect
                # the ragged rows directly (no merged-frontier
                # materialization, no per-candidate verify). Sound
                # because rows ⊆ merged makes rows ∩ match identical
                # either way (query/planner.py pushdown_candidates).
                cand = None
                if self.planner is not None:
                    cand = self.planner.pushdown_candidates(
                        cgq.filter, attr, int(len(flat)),
                        self._eval_filter_root,
                    )
                if cand is None:
                    cand = self.eval_filter(
                        cgq.filter, ragged.merge_flat(flat, offs)
                    )
                flat, offs = DISPATCHER.run_rows_vs_one_ragged(
                    "intersect", flat, offs, cand, row_tokens=row_toks
                )
            lens = None
            # per-row Python features (edge facets, per-row ordering) still
            # walk rows: materialize zero-copy VIEWS into the flat buffer;
            # the plain path stays ragged end-to-end
            if cgq.facet_filter is not None or cgq.facet_order or cgq.facets or cgq.order:
                cnode.uid_matrix = ragged.row_views(flat, offs)
                if cgq.facet_filter is not None or cgq.facet_order or cgq.facets:
                    self._apply_edge_facets(cnode, cgq, parent, reverse)
                # per-row order & pagination (ref query.go:2493,2511);
                # under @cascade, order fully — bounded top-k would
                # truncate to offset+first BEFORE pruning restores the
                # window
                if cgq.order:
                    cnode.uid_matrix = [
                        self._order_uids(cgq, r, full=cnode.under_cascade)
                        for r in cnode.uid_matrix
                    ]
                if (
                    cgq.first is not None
                    or cgq.offset is not None
                    or cgq.after is not None
                ) and not cnode.under_cascade:
                    # any block inside a @cascade subtree defers pagination
                    # until after pruning (_apply_deferred_pagination; ref
                    # TestCascadeWithPaginationDeep)
                    cnode.uid_matrix = [
                        _paginate(r, cgq.first, cgq.offset, cgq.after)
                        for r in cnode.uid_matrix
                    ]
                cnode.dest_uids = _merge_rows(cnode.uid_matrix)
            else:
                if (
                    cgq.first is not None
                    or cgq.offset is not None
                    or cgq.after is not None
                ) and not cnode.under_cascade:
                    # vectorized pagination: offsets arithmetic over the
                    # flat buffer instead of n per-row _paginate calls
                    flat, offs = ragged.paginate(
                        flat, offs, cgq.first, cgq.offset, cgq.after
                    )
                cnode.uid_matrix = ragged.RaggedRows(flat, offs)
                cnode.dest_uids = ragged.merge_flat(flat, offs)
                lens = np.diff(offs)
            if cgq.groupby_attrs:
                self._group_children(cgq, cnode, parent)
            if cgq.is_count:
                # vectorized off the ragged offsets (np.diff) — no per-row
                # len() comprehension; the dict materializes only here,
                # where a count child / count-var actually consumes it
                if lens is None:
                    lens = [len(r) for r in cnode.uid_matrix]
                pu = [int(u) for u in parent.dest_uids]
                cs = [int(c) for c in lens]
                cnode.counts = dict(zip(pu, cs))
                # the level's length vector SURVIVES to encode time: the
                # streaming encoder gathers per-row counts with one
                # searchsorted over (parent dest_uids, lens) instead of
                # len(row) dict lookups; keyed by identity on the parent
                # array so cascade pruning (which reassigns dest_uids)
                # invalidates it automatically (query/streamjson.py)
                cnode.counts_vec = (
                    parent.dest_uids,
                    np.asarray(lens, np.int64),
                )
            if cgq.var_name:
                if cgq.is_count:
                    # `c as count(follow)`: a VALUE var keyed by the parent
                    # (ref query.go count-var binding)
                    self.val_vars[cgq.var_name] = {
                        u: Val(TypeID.INT, c) for u, c in zip(pu, cs)
                    }
                    parent.own_vars.add(cgq.var_name)
                    self.var_def_node[cgq.var_name] = parent
                else:
                    self.uid_vars[cgq.var_name] = cnode.dest_uids
        else:
            if attr.startswith("~"):
                raise QueryError(f"reverse on non-uid predicate {attr[1:]!r}")
            # value predicate: ONE batched read for the whole level — the
            # per-uid loop here never prefetched its DataKeys, so the LSM
            # path was N point lookups (bugfix); values_many batches the
            # memlayer/LSM probe in a single pass
            dkeys = [
                keys.DataKey(attr, int(u), self.ns)
                for u in parent.dest_uids
            ]
            t0 = time.perf_counter()
            with TRACER.span(
                "level_task", attr=attr, parents=len(dkeys)
            ):
                METRICS.inc("level_tasks_started")
                METRICS.inc("level_task_uids", len(dkeys))
                if self.level_batch:
                    if self.batcher is not None:
                        all_posts = self.batcher.read_values(
                            attr, self.cache, dkeys
                        )
                    else:
                        all_posts = self.cache.values_many(dkeys)
                else:
                    self.cache.prefetch(dkeys)
                    all_posts = [self.cache.values(k) for k in dkeys]
            self._record_level_task(
                attr, parent, len(dkeys), t0,
                uids_out=sum(1 for ps in all_posts if ps),
            )
            if self.planner is not None:
                self.planner.note_level(
                    attr, len(dkeys), sum(1 for ps in all_posts if ps)
                )
            for u, posts in zip(parent.dest_uids, all_posts):
                if cgq.lang == "*":
                    pass  # @* keeps every language; encoder fans out fields
                elif cgq.lang:
                    posts = _pick_lang(posts, cgq.lang)
                elif su is not None and su.lang:
                    # untagged read on an @lang predicate returns only the
                    # untagged value (ref lang semantics)
                    posts = [p for p in posts if p.lang == ""]
                if cgq.facet_filter is not None:
                    # @facets(eq(...)) on a VALUE edge keeps only values
                    # whose facets match; a node left with none drops the
                    # field (ref TestFacetsFilterAtValueBasic)
                    posts = [
                        p
                        for p in posts
                        if _facet_tree_match(
                            cgq.facet_filter, p.get_facets()
                        )
                    ]
                if posts:
                    cnode.values[int(u)] = posts
            if cgq.is_count:
                cnode.counts = {
                    int(u): len(cnode.values.get(int(u), []))
                    for u in parent.dest_uids
                }
            if cgq.var_name:
                self.val_vars[cgq.var_name] = {
                    u: ps[0].val() for u, ps in cnode.values.items()
                }
                parent.own_vars.add(cgq.var_name)
                self.var_def_node[cgq.var_name] = parent
        uids_out = (
            len(cnode.dest_uids) if cnode.is_uid_pred else len(cnode.values)
        )
        if observe.tablet_traffic_enabled():
            observe.TABLETS.note_result(
                self.ns, attr,
                int(cnode.dest_uids.nbytes) if cnode.is_uid_pred
                else uids_out * 8,
            )
        if _plan is not None:
            self._record_plan_node(
                cnode, parent, attr,
                uids_in=len(parent.dest_uids), uids_out=uids_out,
                t0=_plan_t0, k0=_plan_k0,
                read="batched" if self.level_batch else "per_uid",
                est_out=_plan_est,
            )
        return cnode

    def _make_checkpwd_child(self, parent: ExecNode, cgq: GraphQuery) -> ExecNode:
        """checkpwd(pred, "pw") selection field -> per-uid boolean
        (ref query.go checkpwd emission)."""
        from dgraph_tpu_torch.acl.acl import _hash_password

        import hmac as _hmac

        cnode = ExecNode(gq=cgq, attr=cgq.attr, src_uids=parent.dest_uids)
        for u in parent.dest_uids:
            got = self.cache.value(keys.DataKey(cgq.attr, int(u), self.ns))
            ok = False
            if got is not None:
                try:
                    raw = bytes.fromhex(str(got.value))
                    salt, want = raw[:16], raw[16:]
                    ok = _hmac.compare_digest(
                        _hash_password(cgq.checkpwd_val, salt), want
                    )
                except ValueError:
                    ok = False
            cnode.math_vals[int(u)] = Val(TypeID.BOOL, ok)
        if cgq.var_name:
            # `pwd as checkpwd(...)` binds a per-uid bool value var (the
            # reference's password-query rewrite filters on eq(val(pwd),1))
            self.val_vars[cgq.var_name] = dict(cnode.math_vals)
        return cnode

    def _make_agg_child(self, parent: ExecNode, cgq: GraphQuery) -> ExecNode:
        """`n as min(val(x))`: aggregate a value var (ref query.go
        valueVarAggregation). If x is keyed at this node's own level the
        result is one block-wide scalar (broadcast via key MAXUID); if x lives
        in a descendant subtree, aggregate per parent uid over the uids
        reachable from that parent at x's level."""
        cnode = ExecNode(gq=cgq, attr=cgq.aggregator, src_uids=parent.dest_uids)
        var = cgq.val_var
        vmap = self.val_vars.get(var, {})
        dnode = self.var_def_node.get(var)
        out: Dict[int, Val] = {}
        if dnode is None or dnode is parent:
            if len(parent.dest_uids):
                xs = [
                    vmap[int(u)] for u in parent.dest_uids if int(u) in vmap
                ]
            else:
                # aggregate-root (`me() { sum(val(a)) }`): the whole map;
                # a broadcast scalar (`c as count(uid)`, keyed MAXUID
                # only) IS the value to aggregate (ref auth rewrites:
                # `ProjectAggregateResult.count : max(val(countVar))`)
                xs = [v for u, v in vmap.items() if u != MAXUID]
                if not xs and MAXUID in vmap:
                    xs = [vmap[MAXUID]]
            agg = _agg_vals(cgq.aggregator, xs)
            cnode.agg_scalar = True  # type: ignore[attr-defined]
            if agg is not None:
                out[MAXUID] = agg
        else:
            chain = self._node_chain(parent, dnode)
            if chain is None:
                # var from an unrelated subtree: aggregate the whole map
                xs = list(vmap.values())
                agg = _agg_vals(cgq.aggregator, xs)
                cnode.agg_scalar = True  # type: ignore[attr-defined]
                if agg is not None:
                    out[MAXUID] = agg
            else:
                hop_idx = [
                    {int(u): j for j, u in enumerate(h.src_uids)}
                    for h in chain
                ]
                for p in parent.dest_uids:
                    uids = {int(p)}
                    for h, idx in zip(chain, hop_idx):
                        nxt: set = set()
                        for u in uids:
                            j = idx.get(u)
                            if j is not None and j < len(h.uid_matrix):
                                nxt.update(int(x) for x in h.uid_matrix[j])
                        uids = nxt
                    xs = [vmap[u] for u in uids if u in vmap]
                    agg = _agg_vals(cgq.aggregator, xs)
                    if agg is not None:
                        out[int(p)] = agg
        cnode.math_vals = out
        if cgq.var_name:
            self.val_vars[cgq.var_name] = out
            parent.own_vars.add(cgq.var_name)
            self.var_def_node[cgq.var_name] = parent
        return cnode

    def _node_chain(
        self, ancestor: ExecNode, dnode: ExecNode
    ) -> Optional[List[ExecNode]]:
        """uid-pred hops from `ancestor` down to `dnode` (inclusive),
        via parent_node links; None if dnode isn't below ancestor."""
        chain: List[ExecNode] = []
        n = dnode
        while n is not None and n is not ancestor:
            if n.is_uid_pred:
                chain.append(n)
            n = n.parent_node
        if n is None:
            return None
        chain.reverse()
        return chain

    def _make_math_child(self, parent: ExecNode, cgq: GraphQuery) -> ExecNode:
        """math(...) over value vars, per parent uid (ref query/math.go)."""
        from dgraph_tpu_torch.query.matheval import (
            MathError,
            eval_math,
            math_vars,
            to_val,
        )

        cnode = ExecNode(gq=cgq, attr="math", src_uids=parent.dest_uids)
        needed = math_vars(cgq.math_expr)
        out: Dict[int, Val] = {}
        if not len(parent.dest_uids) and needed:
            # aggregate-root math over block-wide scalar vars
            # (`me() { Sum: math(minVal + maxVal) }`, ref TestAggregateRoot4)
            env = {}
            present = 0
            for v in needed:
                val = self.val_vars.get(v, {}).get(MAXUID)
                if val is None:
                    env[v] = Val(TypeID.INT, 0)
                else:
                    present += 1
                    env[v] = val
            if present:
                try:
                    out[MAXUID] = to_val(eval_math(cgq.math_expr, env))
                except (MathError, KeyError, ValueError, OverflowError,
                        ZeroDivisionError, TypeError):
                    pass
        for u in parent.dest_uids:
            env = {}
            present = 0
            bcast = 0
            for v in needed:
                vmap = self.val_vars.get(v, {})
                # ancestor-level vars use the PROPAGATED (path-summed)
                # value — the raw map is keyed at the ancestor level and
                # may collide with this level's uids (ref query.go
                # transformTo path maps)
                val = parent.level_vars.get(v, {}).get(int(u))
                if val is None:
                    val = vmap.get(int(u))
                if val is not None:
                    present += 1
                    env[v] = val
                    continue
                val = vmap.get(MAXUID)
                if val is not None:
                    bcast += 1
                else:
                    # a uid with AT LEAST one bound var evaluates with the
                    # rest defaulting to 0 (ref math.go zero-fill); a uid
                    # with none stays out of the result entirely
                    val = Val(TypeID.INT, 0)
                env[v] = val
            # eligible when some var binds THIS uid, or when every needed
            # var is a block-wide broadcast (`score: math(f)` — ref
            # TestCountUidToVar); a uid missing from a per-uid map stays
            # out (ref TestCountUIDToVar2: valueless friend, no val(mul))
            ok = (
                present > 0
                or not needed
                or (bcast == len(needed) and bool(needed))
            )
            if not ok:
                continue
            try:
                out[int(u)] = to_val(eval_math(cgq.math_expr, env))
            except (MathError, KeyError, ValueError, OverflowError,
                    ZeroDivisionError, TypeError):
                continue  # domain/type errors drop the uid (ref math.go)
        cnode.math_vals = out
        if cgq.var_name:
            self.val_vars[cgq.var_name] = out
            parent.own_vars.add(cgq.var_name)
            self.var_def_node[cgq.var_name] = parent
        return cnode

    def _group_children(self, cgq: GraphQuery, cnode: ExecNode, parent: ExecNode):
        """@groupby: bucket each parent's child uids by the groupby attrs'
        values; aggregate count per bucket (ref query/groupby.go)."""
        single = cgq.groupby_attrs[0] if len(cgq.groupby_attrs) == 1 else None
        su_single = self.st.get(single) if single else None
        reverse_ok = (
            su_single is not None
            and su_single.value_type == TypeID.UID
            and su_single.directive_reverse
        )
        for i, pu in enumerate(parent.dest_uids):
            row = cnode.uid_matrix[i] if i < len(cnode.uid_matrix) else []
            buckets: Dict[tuple, dict] = {}
            if reverse_ok and len(row) > 256:
                # inverted fast path (ref groupby.go using the index): one
                # reverse-list ∩ row per DISTINCT target instead of one
                # uid-list read per member — a 100k-member group-by over a
                # dozen targets is a dozen batched intersects
                targets = []
                tgt_rows = []
                for k, _, _ in self.cache.kv.iterate(
                    keys.ReversePrefix(single, self.ns), self.cache.read_ts
                ):
                    pk = keys.parse_key(k)
                    targets.append(pk.uid)
                    tgt_rows.append(self.cache.uids(k))
                inters = DISPATCHER.run_rows_vs_one(
                    "intersect", tgt_rows, np.asarray(row, np.uint64)
                )
                grouped = []
                for g, members in zip(targets, inters):
                    if not len(members):
                        continue
                    buckets[(int(g),)] = {
                        single: hex(int(g)),
                        "count": int(len(members)),
                        "__members__": [int(u) for u in members],
                    }
                    grouped.append(members)
                leftover = np.setdiff1d(
                    np.asarray(row, np.uint64),
                    np.unique(np.concatenate(grouped))
                    if grouped
                    else np.zeros(0, np.uint64),
                )
                if len(leftover):
                    buckets[(None,)] = {
                        single: None,
                        "count": int(len(leftover)),
                        "__members__": [int(u) for u in leftover],
                    }
                self._finish_groupby(cgq, cnode, buckets, int(pu))
                continue
            import itertools as _it

            for cu in row:
                # a multi-valued uid groupby attr lands the entity in ONE
                # bucket PER target (ref groupby.go: each edge groups);
                # members missing ANY groupby attr fall out of the result
                # (dedupMap only collects uids with values)
                options = []
                skip = False
                for ga in cgq.groupby_attrs:
                    su = self.st.get(ga)
                    disp_key = cgq.groupby_aliases.get(ga, ga)
                    if su is not None and su.value_type == TypeID.UID:
                        tgts = self.cache.uids(
                            keys.DataKey(ga, int(cu), self.ns)
                        )
                        if not len(tgts):
                            skip = True
                            break
                        options.append(
                            [
                                (disp_key, int(t), hex(int(t)))
                                for t in tgts
                            ]
                        )
                    else:
                        v = self.cache.value(keys.DataKey(ga, int(cu), self.ns))
                        if v is None:
                            skip = True
                            break
                        options.append([(disp_key, v.value, v.value)])
                if skip:
                    continue
                cnt_key = "count"
                for cc in cgq.children:
                    if cc.is_count and cc.attr == "uid" and cc.alias:
                        cnt_key = cc.alias  # `Count: count(uid)` alias
                for combo in _it.product(*options):
                    k = tuple(kv for _, kv, _d in combo)
                    disp = {ga: d for ga, _kv, d in combo}
                    b = buckets.get(k)
                    if b is None:
                        buckets[k] = b = {
                            **disp, cnt_key: 0, "__members__": []
                        }
                    b[cnt_key] += 1
                    b["__members__"].append(int(cu))
            self._finish_groupby(cgq, cnode, buckets, int(pu))

    def _finish_groupby(self, cgq, cnode, buckets, pu: int):
        """Aggregate, order, and var-bind the filled buckets (shared by
        the inverted and per-member grouping paths)."""
        aggs = [
            c
            for c in cgq.children
            if c.aggregator and c.attr and not c.val_var
        ]
        # "count" appears only when count(uid) was requested in the
        # groupby body (ref TestGroupByAgg: max(name) alone emits no count)
        wants_count = any(
            c.is_count and c.attr == "uid" for c in cgq.children
        )
        sizes = {k: len(b["__members__"]) for k, b in buckets.items()}
        for b in buckets.values():
            members = b.pop("__members__")
            if not wants_count:
                b.pop("count", None)
            for agg in aggs:
                vals = []
                for cu in members:
                    v = self.cache.value(
                        keys.DataKey(agg.attr, cu, self.ns)
                    )
                    if v is None or isinstance(v.value, bool):
                        continue
                    if isinstance(v.value, (int, float)):
                        vals.append(v.value)
                    elif agg.aggregator in ("min", "max") and isinstance(
                        v.value, str
                    ):
                        vals.append(v.value)  # string min/max (max(name))
                key_name = agg.alias or f"{agg.aggregator}({agg.attr})"
                if not vals:
                    b[key_name] = None
                elif agg.aggregator == "min":
                    b[key_name] = min(vals)
                elif agg.aggregator == "max":
                    b[key_name] = max(vals)
                elif agg.aggregator == "sum":
                    b[key_name] = sum(vals)
                else:
                    b[key_name] = sum(vals) / len(vals)
        # determinism order: group SIZE ascending, then key values
        # ascending (ref groupby.go:385 groupLess)
        def _gk(k):
            return tuple(
                (0, float(v), "")
                if isinstance(v, (int, float)) and not isinstance(v, bool)
                else (1, 0.0, str(v))
                for v in k
            )

        ordered = [
            buckets[k]
            for k in sorted(buckets, key=lambda k: (sizes[k], _gk(k)))
        ]
        cnode.groups[pu] = ordered
        # `x as count(uid)` inside a single-uid-pred @groupby binds a
        # val var keyed by the group's target uid (the groupby-var
        # pattern, ref groupby.go + query.go var bindings)
        if len(cgq.groupby_attrs) == 1:
            ga = cgq.groupby_attrs[0]
            su = self.st.get(ga)
            if su is not None and su.value_type == TypeID.UID:
                for c in cgq.children:
                    if c.var_name and c.is_count and c.attr == "uid":
                        vals = self.val_vars.setdefault(c.var_name, {})
                        ck = c.alias or "count"
                        for k, b in buckets.items():
                            if k[0] is not None and ck in b:
                                # counts SUM across parents' groupings
                                # (ref TestGroupByFriendsMultipleParentsVar)
                                prev = vals.get(int(k[0]))
                                base = (
                                    int(prev.value)
                                    if prev is not None
                                    else 0
                                )
                                vals[int(k[0])] = Val(
                                    TypeID.INT, base + b[ck]
                                )
                    elif c.var_name and c.aggregator and c.attr:
                        # `a as max(name)` in @groupby(uidpred): bind the
                        # per-group aggregate keyed by the group target
                        # (ref groupby.go fillGroupedVars)
                        vals = self.val_vars.setdefault(c.var_name, {})
                        key_name = c.alias or f"{c.aggregator}({c.attr})"
                        for k, b in buckets.items():
                            v = b.get(key_name)
                            if k[0] is not None and v is not None:
                                vals[int(k[0])] = (
                                    Val(TypeID.INT, v)
                                    if isinstance(v, int)
                                    and not isinstance(v, bool)
                                    else Val(TypeID.FLOAT, v)
                                    if isinstance(v, float)
                                    else Val(TypeID.STRING, str(v))
                                )

    def _apply_edge_facets(self, cnode: ExecNode, cgq, parent, reverse: bool):
        """Edge-facet filtering / ordering / projection for uid predicates
        (ref worker/task.go:2291-2498 facets filtering)."""
        from dgraph_tpu_torch.query.functions import _coerce

        fmaps = []
        for i, pu in enumerate(parent.dest_uids):
            key = (
                keys.ReverseKey(cnode.attr[1:], int(pu), self.ns)
                if reverse
                else keys.DataKey(cnode.attr, int(pu), self.ns)
            )
            fmap = self.cache.edge_facets(key)
            fmaps.append(fmap)
            row = cnode.uid_matrix[i] if i < len(cnode.uid_matrix) else EMPTY
            if cgq.facet_filter is not None:
                keep = [
                    int(u)
                    for u in row
                    if _facet_tree_match(
                        cgq.facet_filter, fmap.get(int(u), {})
                    )
                ]
                row = np.array(keep, dtype=np.uint64)
            orders = cgq.facet_orders or (
                [(cgq.facet_order, cgq.facet_order_desc)]
                if cgq.facet_order
                else []
            )
            if orders:
                # multi-key sort: stable passes applied last key first;
                # edges missing a key sort after present ones per pass
                # (ref TestFacetsMultipleOrderbyMissingFacets)
                ulist = [int(u) for u in row]
                for fname, desc in reversed(orders):
                    vals = {
                        u: fmap.get(u, {}).get(fname) for u in ulist
                    }
                    present = [u for u in ulist if vals[u] is not None]
                    missing = [u for u in ulist if vals[u] is None]
                    if any(
                        isinstance(vals[u].value, bool) for u in present
                    ):
                        # bool facets are not sortable — the key is
                        # skipped entirely (ref NonsortableFacet golden)
                        continue
                    try:
                        # sorted() on a copy: a TypeError mid-sort must
                        # not leave `present` partially permuted
                        present = sorted(
                            present, key=lambda u: vals[u].value,
                            reverse=desc,
                        )
                    except TypeError:
                        # mixed facet types are not sortable — keep the
                        # edge order for this key (ref nonsortable facet)
                        pass
                    ulist = present + missing
                row = np.array(ulist, dtype=np.uint64)
            cnode.uid_matrix[i] = row
        # (dest_uids is recomputed by the caller after order/pagination)
        if cgq.facets:
            cnode.edge_facet_maps = fmaps  # type: ignore[attr-defined]
        # `w as weight` facet vars: target uid -> facet value, visible to
        # later blocks/children (ref facet var bindings in query.go)
        for var, fname in cgq.facet_vars.items():
            vals = self.val_vars.setdefault(var, {})
            for i, row in enumerate(cnode.uid_matrix):
                fmap = fmaps[i] if i < len(fmaps) else {}
                for u in row:
                    fv = fmap.get(int(u), {}).get(fname)
                    if fv is None:
                        continue
                    prev = vals.get(int(u))
                    if prev is not None and isinstance(
                        prev.value, (int, float)
                    ) and isinstance(fv.value, (int, float)) and not (
                        isinstance(prev.value, bool)
                        or isinstance(fv.value, bool)
                    ):
                        # a facet var hit via several edges SUMS
                        # (ref query.go facet var aggregation)
                        vals[int(u)] = Val(
                            TypeID.FLOAT, prev.value + fv.value
                        )
                    else:
                        vals[int(u)] = fv
            cnode.own_vars.add(var)
            self.var_def_node[var] = cnode

    def _resolve_expand(
        self, gqs: List[GraphQuery], uids: np.ndarray
    ) -> List[GraphQuery]:
        out = []
        for g in gqs:
            if not g.expand:
                out.append(g)
                continue
            preds: List[str] = []
            if g.expand == "_all_":
                # union of type fields of the uids' dgraph.type values
                for u in uids:
                    for p in self.cache.values(
                        keys.DataKey("dgraph.type", int(u), self.ns)
                    ):
                        tu = self.st.get_type(str(p.val().value))
                        if tu:
                            preds.extend(tu.fields)
            elif g.expand.startswith("val:"):
                # expand(val(x)): predicates named by the var's STRING
                # values (ref TestExpandVal)
                vmap = self.val_vars.get(g.expand[4:], {})
                preds.extend(
                    str(v.value) for v in vmap.values()
                    if isinstance(v.value, str)
                )
            else:
                for tname in g.expand.split(","):  # expand(Type1, Type2)
                    tu = self.st.get_type(tname)
                    if tu:
                        preds.extend(tu.fields)
            seen = set()
            for pname in preds:
                if pname in seen:
                    continue
                if (
                    self.allowed_preds is not None
                    and pname not in self.allowed_preds
                ):
                    continue  # silently drop unreadable preds (ref behavior)
                seen.add(pname)
                su = self.st.get(pname)
                if g.filter is not None and not (
                    su is not None and su.value_type == TypeID.UID
                ):
                    # expand(...) @filter(...) filters NODES — scalar
                    # expanded predicates drop entirely
                    # (ref TestTypeFilterAtExpand: only `owner` survives)
                    continue
                child = GraphQuery(attr=pname)
                child.children = list(g.children)
                # expand(...) @filter(...) applies to every expanded edge
                child.filter = g.filter
                # expanded fields surface every language variant and all
                # facets (ref TestTypeExpandLang model@jp,
                # TestTypeExpandFacets model|type)
                if su is not None and su.lang:
                    child.lang = "*"
                child.facets = True
                out.append(child)
        return out

    # ------------------------------------------------------------------
    # @recurse (ref query/recurse.go:19 expandRecurse)
    # ------------------------------------------------------------------

    def _expand_recurse(self, node: ExecNode):
        """@recurse: apply the query's predicates repeatedly, each uid-pred
        child recursed independently (ref query/recurse.go:19 expandRecurse
        — ALL uid predicates continue, not just the first). A shared seen
        set (loop: false) prunes revisits across the whole traversal."""
        depth = node.gq.recurse_depth or 5
        # bare `uid` rides along (emitted at every level); `a as uid`
        # only binds the visited set (handled below)
        preds = [
            c
            for c in node.gq.children
            if not (c.val_var or (c.is_uid and c.var_name))
        ]
        seen = [node.dest_uids.copy()]  # single-element holder (shared state)
        self._recurse_level(node, preds, seen, depth, node.gq.recurse_loop)
        # `a as uid` under @recurse binds every VISITED node (root + all
        # expansion levels; ref recurse.go uid-var assignment)
        for c in node.gq.children:
            if c.is_uid and c.var_name:
                self.uid_vars[c.var_name] = seen[0]

    def _recurse_level(
        self,
        frontier_node: ExecNode,
        preds: List[GraphQuery],
        seen: List[np.ndarray],
        remaining: int,
        loop: bool,
        frontier: Optional[np.ndarray] = None,
    ):
        """One recursion level. With loop:false, edges INTO already-visited
        nodes are still shown (ref recurse.go: Rick's friend Michonne
        appears), but only unvisited nodes EXPAND further — `frontier` is
        the subset of this level's uids allowed to grow uid-pred children.
        """
        if remaining <= 0 or not len(frontier_node.dest_uids):
            return
        # expand(_all_)/expand(Type) resolves per level against the
        # frontier's types (ref recurse.go preExpand); keep the original
        # unresolved list for the recursive calls
        orig_preds = preds
        preds = self._resolve_expand(preds, frontier_node.dest_uids)
        uid_children = []
        snapshot = seen[0]
        new_sets = []
        fr = (
            None
            if frontier is None
            else {int(x) for x in frontier}
        )
        for cgq in preds:
            if cgq.is_uid:
                # bare `uid` emits at every recursion level
                # (ref TestRecurseQueryLimitDepth2 golden)
                frontier_node.children.append(
                    ExecNode(
                        gq=cgq, attr="uid",
                        src_uids=frontier_node.dest_uids,
                    )
                )
                continue
            c2 = GraphQuery(
                attr=cgq.attr,
                alias=cgq.alias,
                filter=cgq.filter,
                lang=cgq.lang,
                first=cgq.first,
                offset=cgq.offset,
                var_name=cgq.var_name,
                facets=cgq.facets,
                facet_names=list(cgq.facet_names),
                facet_aliases=dict(cgq.facet_aliases),
                facet_orders=list(cgq.facet_orders),
                facet_order=cgq.facet_order,
                facet_order_desc=cgq.facet_order_desc,
                facet_filter=cgq.facet_filter,
            )
            prev_vals = (
                dict(self.val_vars.get(cgq.var_name, {}))
                if cgq.var_name
                else None
            )
            prev_uids = (
                self.uid_vars.get(cgq.var_name, EMPTY)
                if cgq.var_name
                else None
            )
            cnode = self._make_child(frontier_node, c2)
            if cnode is None:
                continue
            # vars under @recurse accumulate across ALL levels
            # (ref recurse.go variable assignment per expansion)
            if cgq.var_name and prev_vals is not None and \
                    cgq.var_name in self.val_vars:
                merged = prev_vals
                merged.update(self.val_vars[cgq.var_name])
                self.val_vars[cgq.var_name] = merged
            frontier_node.children.append(cnode)
            if cnode.is_uid_pred:
                if fr is not None:
                    # visited parents stop expanding: blank their rows
                    cnode.uid_matrix = [
                        row if int(pu) in fr else EMPTY
                        for pu, row in zip(
                            frontier_node.dest_uids, cnode.uid_matrix
                        )
                    ]
                    cnode.dest_uids = _merge_rows(cnode.uid_matrix)
                if cgq.var_name:
                    self.uid_vars[cgq.var_name] = np.union1d(
                        prev_uids, cnode.dest_uids
                    ).astype(np.uint64)
                if not loop:
                    new = DISPATCHER.run_pairs(
                        "difference", [(cnode.dest_uids, snapshot)]
                    )[0]
                    new_sets.append(new)
                    uid_children.append((cnode, new))
                else:
                    uid_children.append((cnode, cnode.dest_uids))
        if not loop and new_sets:
            seen[0] = DISPATCHER.run_chain("union", [seen[0]] + new_sets)
        for cnode, nxt in uid_children:
            self._recurse_level(
                cnode, orig_preds, seen, remaining - 1, loop,
                frontier=None if loop else nxt,
            )

    # ------------------------------------------------------------------
    # @cascade: prune uids missing any child (ref query.go cascade)
    # ------------------------------------------------------------------

    def _cascade_compute(
        self, n: ExecNode, valids: Dict[int, set], fields=None
    ) -> set:
        """Bottom-up valid sets: an entity survives only if every queried
        field at its level is present — including uid-pred children whose
        own subtrees survived (ref query.go applyCascade). A parameterized
        @cascade(f1, f2) requires only the listed predicates; the list
        propagates to child levels unless a child declares its own
        (ref query.go Params.Cascade)."""
        fields = n.gq.cascade_fields or fields or []
        for c in n.children:
            if c.is_uid_pred and c.children:
                self._cascade_compute(c, valids, fields)
        valid = set()
        for i, u in enumerate(n.dest_uids):
            ok = True
            for c in n.children:
                gq = c.gq
                if fields and not (
                    gq.attr in fields or (gq.alias and gq.alias in fields)
                ):
                    continue
                if (
                    gq.is_uid
                    or gq.is_count
                    or gq.aggregator
                    or gq.val_var
                    or gq.math_expr is not None
                    or gq.checkpwd_val is not None
                ):
                    continue
                if c.is_uid_pred:
                    row = (
                        c.uid_matrix[i]
                        if i < len(c.uid_matrix)
                        else ()
                    )
                    cv = valids.get(id(c))
                    if not any(
                        cv is None or int(v) in cv for v in row
                    ):
                        ok = False
                        break
                elif int(u) not in c.values:
                    ok = False
                    break
            if ok:
                valid.add(int(u))
        valids[id(n)] = valid
        return valid

    def _cascade_prune(
        self, n: ExecNode, n_valid: set, valids: Dict[int, set]
    ):
        """Prune matrix CONTENTS by the valid sets (row alignment with
        each parent's dest list is preserved; dest stays a superset, which
        the encoder tolerates — it walks rows, not dest)."""
        for c in n.children:
            if not c.is_uid_pred:
                continue
            cv = valids.get(id(c))
            rows = []
            for i, row in enumerate(c.uid_matrix):
                pu = (
                    int(n.dest_uids[i])
                    if i < len(n.dest_uids)
                    else None
                )
                if pu is not None and pu not in n_valid:
                    rows.append(EMPTY)  # parent itself was pruned
                elif cv is not None:
                    rows.append(
                        _as_uids(v for v in row if int(v) in cv)
                    )
                else:
                    rows.append(row)
            c.uid_matrix = rows
            # uid vars bound in a cascaded subtree see the PRUNED set
            # (ref TestUseVarsMultiCascade golden)
            if c.gq.var_name and not c.gq.is_count:
                self.uid_vars[c.gq.var_name] = _merge_rows(
                    c.uid_matrix
                )
            if c.children:
                self._cascade_prune(
                    c,
                    cv
                    if cv is not None
                    else {int(x) for x in c.dest_uids},
                    valids,
                )

    def _apply_deferred_pagination(self, node: ExecNode):
        """Pagination for blocks inside a @cascade subtree, applied AFTER
        pruning (ref TestCascadeWithPaginationDeep: first/offset count
        only surviving entities)."""
        for c in node.children:
            if not c.is_uid_pred:
                continue
            gq = c.gq
            if c.under_cascade and (
                gq.first is not None
                or gq.offset is not None
                or gq.after is not None
            ):
                c.uid_matrix = [
                    _paginate(r, gq.first, gq.offset, gq.after)
                    for r in c.uid_matrix
                ]
                c.dest_uids = _merge_rows(c.uid_matrix)
            self._apply_deferred_pagination(c)

    def _apply_child_cascades(self, node: ExecNode):
        """`friend @cascade { ... }` on a SUBQUERY: prune that subtree the
        same way a root @cascade does, then apply the subtree's deferred
        pagination (ref TestCascadeSubQuery*)."""
        for c in node.children:
            if not c.is_uid_pred:
                continue
            if c.gq.cascade and c.children:
                valids: Dict[int, set] = {}
                valid = self._cascade_compute(c, valids)
                c.uid_matrix = [
                    _as_uids(v for v in row if int(v) in valid)
                    for row in c.uid_matrix
                ]
                self._cascade_prune(c, valid, valids)
                gq = c.gq
                if (
                    gq.first is not None
                    or gq.offset is not None
                    or gq.after is not None
                ):
                    c.uid_matrix = [
                        _paginate(r, gq.first, gq.offset, gq.after)
                        for r in c.uid_matrix
                    ]
                c.dest_uids = _merge_rows(c.uid_matrix)
                if gq.var_name and not gq.is_count:
                    self.uid_vars[gq.var_name] = c.dest_uids
                self._apply_deferred_pagination(c)
            else:
                self._apply_child_cascades(c)

    def _apply_cascade(self, node: ExecNode):
        """Root @cascade (ref query.go applyCascade bottom-up pruning)."""
        valids: Dict[int, set] = {}
        root_valid = self._cascade_compute(node, valids)
        self._cascade_prune(node, root_valid, valids)

        # root pagination was deferred for cascade blocks: apply it now,
        # preserving any ordering already applied to dest_uids
        gq = node.gq
        kept = np.array(
            [int(u) for u in node.dest_uids if int(u) in root_valid],
            dtype=np.uint64,
        )
        kept = _paginate(kept, gq.first, gq.offset, gq.after)
        idx = {int(u): i for i, u in enumerate(node.dest_uids)}
        for c in node.children:
            if c.uid_matrix:
                c.uid_matrix = [c.uid_matrix[idx[int(u)]] for u in kept]
            c.src_uids = kept
        node.dest_uids = kept
        if gq.var_name:
            # the block's own uid var must see the pruned set too
            self.uid_vars[gq.var_name] = kept
        self._apply_deferred_pagination(node)

    # ------------------------------------------------------------------
    # Ordering / pagination
    # ------------------------------------------------------------------

    def _order_and_paginate(self, gq: GraphQuery, uids: np.ndarray) -> np.ndarray:
        if gq.order:
            uids = self._order_uids(gq, uids)
        return _paginate(uids, gq.first, gq.offset, gq.after)

    def _order_uids_indexed(
        self, gq: GraphQuery, o: Order, uids: np.ndarray
    ) -> Optional[np.ndarray]:
        """Index-walk ordering (ref worker/sort.go:189 sortWithIndex): walk
        the attr's sortable index buckets in token order — token bytes are
        order-preserving for exact/int/datetime tokenizers — intersecting
        each bucket with the candidates, early-stopping at offset+first.
        One KV read per DISTINCT value instead of one per uid. Returns
        None when no sortable index applies (caller falls back)."""
        if o.val_var or o.lang:
            return None
        su = self.st.get(o.attr)
        if su is None:
            return None
        tk = next(
            (t for t in su.tokenizer_objs() if t.is_sortable), None
        )
        if tk is None:
            return None
        need = None
        if gq.first is not None and gq.first >= 0 and gq.after is None:
            need = (gq.offset or 0) + gq.first
        prefix = keys.IndexPrefix(o.attr, self.ns)
        ident = bytes([tk.identifier])
        bucket_keys = [
            k
            for k, _, _ in self.cache.kv.iterate(prefix, self.cache.read_ts)
            if keys.parse_key(k).term.startswith(ident)
        ]
        if o.desc:
            bucket_keys.reverse()
        out: List[int] = []
        emitted: set = set()  # a uid with several indexed values (langs,
        # list preds) appears in several buckets — first bucket wins
        cand = uids
        for bk in bucket_keys:
            if need is not None and len(out) >= need:
                break
            bucket = self.cache.uids(bk)
            if not len(bucket):
                continue
            sel = np.intersect1d(bucket, cand, assume_unique=True)
            sel = np.array(
                [u for u in sel if int(u) not in emitted], dtype=np.uint64
            )
            if not len(sel):
                continue
            emitted.update(int(u) for u in sel)
            if tk.is_lossy and len(sel) > 1:
                # lossy buckets (float@int, year/...) order between buckets
                # only: sort inside by actual value (sortWithoutIndex per
                # bucket in the reference)
                sub = GraphQuery(attr=gq.attr)
                sub.order = [Order(attr=o.attr, desc=o.desc, lang=o.lang)]
                sel = self._order_uids_generic(sub, sel)
            out.extend(int(u) for u in sel)
        # uids with no indexed value sort AFTER every valued one, uid
        # order matching the key's direction — same tail the generic
        # comparator produces (ref TestNegativeOffset)
        if need is None or len(out) < need:
            out.extend(
                sorted(
                    (int(u) for u in uids if int(u) not in emitted),
                    reverse=o.desc,
                )
            )
        return np.array(out, dtype=np.uint64)

    def _order_uids_topk(
        self, gq: GraphQuery, o: Order, uids: np.ndarray
    ) -> Optional[np.ndarray]:
        """Device top-k for `first: N` over a numeric value-var ordering:
        one lax.top_k instead of a host sort (ref pagination path in
        query/outputnode.go + worker/sort.go)."""
        if not o.val_var or gq.first is None or gq.first < 0 or gq.after is not None:
            return None
        vals = self.val_vars.get(o.val_var, {})
        need = (gq.offset or 0) + gq.first
        if len(uids) < 4096 or need >= len(uids):
            return None  # host sort wins below dispatch overhead
        scores = np.zeros((len(uids),), np.float64)
        present_mask = np.zeros((len(uids),), bool)
        for i, u in enumerate(uids):
            v = vals.get(int(u))
            if v is None:
                continue  # missing values sink to the end
            if not isinstance(v.value, (int, float)) or isinstance(v.value, bool):
                return None  # non-numeric ordering: host path
            scores[i] = float(v.value)
            present_mask[i] = True
        import torch

        from dgraph_tpu_torch.ops import vector_topk

        sc = np.where(
            present_mask,
            scores if o.desc else -scores,
            -np.inf,  # missing rank last, then get dropped below
        ).astype(np.float32)
        k = min(need, int(present_mask.sum()))
        if k == 0:
            return np.zeros((0,), np.uint64)
        # lax.top_k(sc, k) is KV1's ascending top-k of -sc: both order by
        # the IEEE total order (NaN past inf, -0.0 below 0.0), ties to the
        # lower index, and flipping the sign bit reverses that order
        neg = (sc.view(np.uint32) ^ np.uint32(0x80000000)).view(np.float32)
        row = torch.from_numpy(neg[None, :]).to(DISPATCHER.device)
        _, idx = vector_topk.topk(row, k, "distance")
        idx = idx[0].cpu().numpy()
        top = uids[idx]
        present = uids[present_mask]
        if len(top) < len(present):
            rest = np.setdiff1d(present, top, assume_unique=False)
            # rest order is unspecified beyond the pagination window
            return np.concatenate([top, rest])
        return top

    def _order_uids(
        self, gq: GraphQuery, uids: np.ndarray, full: bool = False
    ) -> np.ndarray:
        """full=True keeps EVERY uid ordered (no first/offset-bounded
        top-k / index early stop) — required when pruning happens after
        ordering, e.g. @cascade (ref TestCascadeWithSort)."""
        if not len(uids) or not gq.order:
            return uids
        if any(o.lang and o.lang != "." for o in gq.order):
            # lang-tagged sorts need collation — only the generic path
            # applies it (index walks are byte-ordered)
            return self._order_uids_generic(gq, uids)
        if len(gq.order) == 1 and not full:
            o = gq.order[0]
            got = self._order_uids_topk(gq, o, uids)
            if got is not None:
                return got
            got = self._order_uids_indexed(gq, o, uids)
            if got is not None:
                return got
        return self._order_uids_generic(gq, uids)

    def _order_uids_generic(self, gq: GraphQuery, uids: np.ndarray) -> np.ndarray:
        if not len(uids) or not gq.order:
            return uids

        def key_of(o: Order, u):
            if o.val_var:
                return self.val_vars.get(o.val_var, {}).get(int(u))
            return self.cache.value(
                keys.DataKey(o.attr, int(u), self.ns), o.lang
            )

        # multi-key ordering: ONE composite comparator (ref query.go
        # multiSort/sortWithValues semantics, pinned by the goldens):
        # - a node missing a key's value sorts after every valued one,
        #   in asc AND desc (ref TestNegativeOffset);
        # - sorting by a val(..) var EXCLUDES uids outside the var map
        #   (ref QueryVarValAgg*) — the var map IS the candidate set;
        # - full ties break by uid, in the LAST key's direction
        #   (ref TestMultiSort5: Bob/Elizabeth pairs order uid-desc
        #   under orderasc:name, orderdesc:salary);
        # - lang-tagged string keys use that language's collation
        #   (ref LanguageOrderIndexed goldens).
        import functools

        from dgraph_tpu_torch.tok.collate import collate_key

        orders = gq.order
        ordered = [int(u) for u in uids]
        vals_per_key = [
            {u: key_of(o, u) for u in ordered} for o in orders
        ]
        if orders[0].val_var:
            ordered = [
                u for u in ordered if vals_per_key[0][u] is not None
            ]

        def skey(o, v):
            if (
                o.lang
                and o.lang != "."
                and isinstance(v.value, str)
            ):
                return collate_key(v.value, o.lang)
            return _sort_key_of(v)

        def cmp(a, b):
            for o, vals in zip(orders, vals_per_key):
                va, vb = vals[a], vals[b]
                if va is None and vb is None:
                    continue
                if va is None:
                    return 1  # missing always last
                if vb is None:
                    return -1
                ka, kb = skey(o, va), skey(o, vb)
                if ka == kb:
                    continue
                lt = -1 if ka < kb else 1
                return -lt if o.desc else lt
            if a == b:
                return 0
            # uid tiebreak: val(..) sorts are stable over uid-asc input
            # (ref TestQueryVarValAggMul equal-value runs); predicate
            # sorts break ties in the LAST key's direction
            # (ref TestMultiSort5 Bob/Elizabeth pairs)
            lt = -1 if a < b else 1
            if orders[-1].val_var:
                return lt
            return -lt if orders[-1].desc else lt

        try:
            ordered.sort(key=functools.cmp_to_key(cmp))
        except TypeError:
            names = ", ".join(o.attr or o.val_var for o in orders)
            raise QueryError(f"unorderable values for {names}") from None
        return np.array(ordered, dtype=np.uint64)

    # ------------------------------------------------------------------
    # shortest path (ref query/shortest.go:457 shortestPath)
    # ------------------------------------------------------------------

    def _shortest_block(self, gq: GraphQuery) -> ExecNode:
        from dgraph_tpu_torch.query.shortest import k_shortest_paths

        src = self._resolve_endpoint(gq.shortest_from)
        dst = self._resolve_endpoint(gq.shortest_to)
        if src is None or dst is None:
            # unmatched endpoint var: no paths (ref shortest.go empty-from)
            node = ExecNode(gq=gq, attr="_path_", dest_uids=EMPTY)
            node.paths = []  # type: ignore[attr-defined]
            node.path_weights = []  # type: ignore[attr-defined]
            if gq.var_name:
                self.uid_vars[gq.var_name] = EMPTY
            return node
        preds = [c.attr for c in gq.children]
        # @facets(<name>) on a path predicate names its edge-cost facet
        # (ref shortest.go:141 expandOut facet costs)
        wfacets = [
            (c.facet_names[0] if c.facet_names else None) for c in gq.children
        ]
        # each path predicate's own @filter prunes the nodes reached VIA
        # that predicate (except the destination, which always completes
        # a path — ref shortest.go per-subgraph filters, filter2 golden)
        def mk_nf(ftree, _dst=dst):
            def nf(uids, _f=ftree):
                kept = self.eval_filter(_f, uids)
                if _dst in uids and _dst not in kept:
                    kept = np.sort(
                        np.append(kept, np.uint64(_dst))
                    ).astype(np.uint64)
                return kept

            return nf

        nfs = [
            mk_nf(c.filter) if c.filter is not None else None
            for c in gq.children
        ]
        routes = k_shortest_paths(
            self.cache,
            self.st,
            src,
            dst,
            preds,
            gq.num_paths,
            self.ns,
            max_depth=gq.recurse_depth or 10,
            weight_facets=wfacets,
            min_weight=gq.min_weight,
            max_weight=gq.max_weight,
            node_filters=nfs,
        )
        node = ExecNode(gq=gq, attr="_path_")
        node.dest_uids = _as_uids(routes[0][0]) if routes else EMPTY
        node.paths = [p for p, _ in routes]  # type: ignore[attr-defined]
        node.path_weights = [w for _, w in routes]  # type: ignore[attr-defined]
        # per-hop predicate + facet cost for the nested _path_ encoding
        # (ref outputnode: {"uid": A, "pred": {"uid": B, "pred|f": w}})
        from dgraph_tpu_torch.query.shortest import annotate_hops

        node.path_hops = [  # type: ignore[attr-defined]
            annotate_hops(self.cache, self.st, p, preds, wfacets, self.ns)
            for p, _ in routes
        ]
        node.path_facet_names = {  # type: ignore[attr-defined]
            c.attr: (c.facet_names[0] if c.facet_names else None)
            for c in gq.children
        }
        if gq.var_name:
            # path var holds the BEST path's uids in PATH order (ref
            # shortest.go; TestShortestPathRev + TestTwoShortestPath)
            best = [int(u) for u in routes[0][0]] if routes else []
            self.uid_vars[gq.var_name] = np.array(best, dtype=np.uint64)
            self.ordered_uid_vars.add(gq.var_name)
        return node

    def _resolve_endpoint(self, ep) -> Optional[int]:
        if isinstance(ep, tuple) and ep[0] == "var":
            uids = self.uid_vars.get(ep[1], EMPTY)
            if not len(uids):
                return None  # no match -> empty path result (ref behavior)
            return int(uids[0])
        if ep is None:
            raise QueryError("shortest requires from: and to:")
        return int(ep)


def _merge_rows(rows: List[np.ndarray]) -> np.ndarray:
    nonempty = [r for r in rows if len(r)]
    if not nonempty:
        return EMPTY
    if len(nonempty) > 64:
        # many tiny rows: one concat+unique beats the k-way merge's
        # per-list marshaling
        return np.unique(np.concatenate(nonempty)).astype(np.uint64)
    from dgraph_tpu_torch import native

    return native.merge_sorted(nonempty).astype(np.uint64)


def _paginate(uids: np.ndarray, first, offset, after) -> np.ndarray:
    if after is not None:
        uids = uids[uids > np.uint64(after)]
    if offset and offset > 0:  # negative offset = 0 (ref TestNegativeOffset)
        uids = uids[offset:]
    if first is not None:
        if first >= 0:
            uids = uids[:first]
        else:
            uids = uids[first:]
    return uids


def _facet_tree_match(ft: FilterTree, facets: Dict[str, Val]) -> bool:
    """Evaluate an @facets(...) boolean filter tree against one edge's
    facet map (ref worker/task.go facets filtering with AND/OR/NOT)."""
    if ft.func is not None:
        ff = ft.func
        fv = facets.get(ff.attr)
        if fv is None:
            return False
        if ff.name in ("allofterms", "anyofterms"):
            from dgraph_tpu_torch.tok.tok import _normalize, _word_re

            have = set(_word_re.findall(_normalize(str(fv.value))))
            want_terms = set(_word_re.findall(_normalize(str(ff.args[0]))))
            return (
                want_terms <= have
                if ff.name == "allofterms"
                else bool(want_terms & have)
            )
        from dgraph_tpu_torch.query.functions import _coerce

        try:
            want = _coerce(ff.args[0], fv.tid)
            c = compare_vals(convert(fv, want.tid), want)
        except (ValueError, TypeError):
            return False
        return {
            "eq": c == 0, "le": c <= 0, "lt": c < 0,
            "ge": c >= 0, "gt": c > 0,
        }.get(ff.name, False)
    if ft.op == "and":
        return all(_facet_tree_match(c, facets) for c in ft.children)
    if ft.op == "or":
        return any(_facet_tree_match(c, facets) for c in ft.children)
    if ft.op == "not":
        return not _facet_tree_match(ft.children[0], facets)
    return False


def _agg_vals(op: str, xs: List[Val]) -> Optional[Val]:
    """min/max/sum/avg over value-var Vals (ref query.go aggregations)."""
    if not xs:
        return None
    if op == "min":
        return min(xs, key=_sort_key_of)
    if op == "max":
        return max(xs, key=_sort_key_of)
    nums = [
        x.value
        for x in xs
        if isinstance(x.value, (int, float)) and not isinstance(x.value, bool)
    ]
    if not nums:
        return None
    if op == "sum":
        t = sum(nums)
        return Val(TypeID.INT if isinstance(t, int) else TypeID.FLOAT, t)
    if op == "avg":
        return Val(TypeID.FLOAT, sum(nums) / len(nums))
    return None


def _pick_lang(posts: List[Posting], chain: str) -> List[Posting]:
    """Language preference list: name@en:fr:. — first language in the chain
    with values wins; '.' accepts any (ref dql lang list semantics)."""
    for lang in chain.split(":"):
        if lang == ".":
            # '.' prefers the untagged value, then any language
            # (ref TestFilterHas golden: lossy@. -> "Badger")
            untagged = [p for p in posts if p.lang == ""]
            if untagged:
                return untagged[:1]
            if posts:
                return posts[:1]
            continue
        got = [p for p in posts if p.lang == lang]
        if got:
            return got
    return []


def _sort_key_of(v: Val):
    x = v.value
    import datetime as _dt

    if isinstance(x, _dt.datetime) and x.tzinfo is None:
        return x.replace(tzinfo=_dt.timezone.utc)
    return x


def _vals_equal(v: Val, arg) -> bool:
    from dgraph_tpu_torch.query.functions import _coerce, _val_eq

    try:
        return _val_eq(v, _coerce(arg, v.tid))
    except ValueError:
        return False
