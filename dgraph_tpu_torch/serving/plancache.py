"""Parsed-query plan cache keyed on normalized query shape.

High-QPS traffic repeats a small set of query *shapes* with varying
literal values. `normalize()` tokenizes the query with the dql lexer
and strips every literal token (strings, numbers, regexes) out of the
shape key — so two textually different queries that differ only in
values (or whitespace/comments) share one shape. The cache is a
two-level structure:

  shape  -> ShapeEntry     (LRU over shapes, DGRAPH_TPU_PLAN_CACHE_SIZE)
  ShapeEntry.variants:
    (literals, query-vars) -> parsed blocks   (bounded per shape)

A variant hit returns the cached GraphQuery tree directly — parse is
skipped entirely. Reuse without copying is safe because the executor
never mutates the parsed tree (it builds ExecNodes beside it; expand/
recurse construct *new* GraphQuery children) — a regression test runs
one cached tree through the executor repeatedly and asserts identical
output. A shape hit with a new literal binding still re-parses (one
miss) but accrues to the same per-shape statistics.

Commit-epoch invalidation: every commit/alter bumps the engine epoch;
an entry stamped with an older epoch is discarded on access. Parse
output is data-independent today, so this is deliberately conservative
— the cache contract is "no plan survives a commit unrevalidated",
which keeps the door open for stats-fed planning decisions to move
into the cached plan without a correctness cliff. Read-heavy steady
state (the serving regime this cache exists for) is unaffected.

Per-shape statistics (hits and a latency EWMA fed by the entry points)
are the admission controller's cost model: a shape that has been
observed slow admits as expensive *before* it runs.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config

# literal token kinds stripped from the shape (dql/parser.py tokenizer)
_LITERAL_KINDS = frozenset({"string", "num", "regex"})
# distinct literal bindings cached per shape before LRU eviction
_VARIANTS_PER_SHAPE = 16
# EWMA weight of the newest cost observation
_COST_ALPHA = 0.2


def normalize(text: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """(shape, literals) for a query: the dql token stream with literal
    tokens replaced by `?` (joined with single spaces), plus the raw
    literal texts in source order. None when the text does not lex —
    the caller falls through to a plain parse for the real error."""
    from dgraph_tpu_torch.dql.parser import ParseError, tokenize

    try:
        toks = tokenize(text)
    except ParseError:
        return None
    shape: List[str] = []
    lits: List[str] = []
    for t in toks:
        if t.kind in _LITERAL_KINDS:
            shape.append("?")
            lits.append(t.text)
        elif t.kind != "eof":
            shape.append(t.text)
    return " ".join(shape), tuple(lits)


class ShapeEntry:
    __slots__ = ("epoch", "variants", "hits", "misses", "cost_ms")

    def __init__(self, epoch: int):
        self.epoch = epoch
        # (literals, vars_key) -> parsed blocks
        self.variants: "OrderedDict[tuple, list]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.cost_ms: Optional[float] = None  # latency EWMA


class PlanCache:
    """LRU plan cache + per-shape cost statistics. Thread-safe; nothing
    blocking runs under its lock (parse happens at the call sites)."""

    def __init__(self, size: Optional[int] = None):
        self._lock = threading.Lock()
        self._size = size
        self._shapes: "OrderedDict[str, ShapeEntry]" = OrderedDict()
        self.epoch = 0

    def capacity(self) -> int:
        """Configured shape capacity; 0 = caching (and the per-shape
        cost stats built on it) disabled."""
        if self._size is not None:
            return max(0, int(self._size))
        return max(0, int(config.get("PLAN_CACHE_SIZE")))

    _capacity = capacity  # internal alias

    @staticmethod
    def _vars_key(variables) -> tuple:
        if not variables:
            return ()
        return tuple(sorted((str(k), repr(v)) for k, v in variables.items()))

    # -- lookups -------------------------------------------------------------

    def get(self, shape: str, literals: tuple, variables=None):
        """Cached parsed blocks for this exact binding, or None. Counts
        plan_cache_{hit,miss}_total; epoch-stale entries are dropped."""
        cap = self._capacity()
        vk = self._vars_key(variables)
        with self._lock:
            e = self._shapes.get(shape)
            if e is not None and e.epoch != self.epoch:
                # commit-epoch invalidation: plans don't survive a
                # commit; the shape's cost stats do (they describe the
                # shape, not the snapshot)
                e.variants.clear()
                e.epoch = self.epoch
            if cap == 0 or e is None:
                if e is not None:
                    e.misses += 1
                METRICS.inc("plan_cache_miss_total")
                return None
            self._shapes.move_to_end(shape)
            blocks = e.variants.get((literals, vk))
            if blocks is None:
                e.misses += 1
                METRICS.inc("plan_cache_miss_total")
                return None
            e.variants.move_to_end((literals, vk))
            e.hits += 1
            METRICS.inc("plan_cache_hit_total")
            return blocks

    def put(self, shape: str, literals: tuple, blocks, variables=None):
        cap = self._capacity()
        if cap == 0:
            return
        vk = self._vars_key(variables)
        with self._lock:
            e = self._shapes.get(shape)
            if e is None:
                e = self._shapes[shape] = ShapeEntry(self.epoch)
            elif e.epoch != self.epoch:
                e.variants.clear()
                e.epoch = self.epoch
            self._shapes.move_to_end(shape)
            e.variants[(literals, vk)] = blocks
            e.variants.move_to_end((literals, vk))
            while len(e.variants) > _VARIANTS_PER_SHAPE:
                e.variants.popitem(last=False)
            while len(self._shapes) > cap:
                self._shapes.popitem(last=False)

    # -- invalidation ---------------------------------------------------------

    def invalidate(self) -> None:
        """Bump the commit epoch: every cached plan is stale (dropped
        lazily on next access). Called from the commit and alter paths."""
        with self._lock:
            self.epoch += 1

    # -- statistics (admission's cost model) ----------------------------------

    def observe_cost(self, shape: str, took_ms: float) -> None:
        """Feed one completed execution's latency into the shape's EWMA
        (creates the stats-bearing entry even when plans aren't cached)."""
        with self._lock:
            e = self._shapes.get(shape)
            if e is None:
                cap = self._capacity()
                if cap == 0:
                    return
                e = self._shapes[shape] = ShapeEntry(self.epoch)
                while len(self._shapes) > cap:
                    self._shapes.popitem(last=False)
            if e.cost_ms is None:
                e.cost_ms = float(took_ms)
            else:
                e.cost_ms += _COST_ALPHA * (float(took_ms) - e.cost_ms)

    def estimated_cost_ms(self, shape: Optional[str]) -> Optional[float]:
        if shape is None:
            return None
        with self._lock:
            e = self._shapes.get(shape)
            return None if e is None else e.cost_ms

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "shapes": len(self._shapes),
                "hits": sum(e.hits for e in self._shapes.values()),
                "misses": sum(e.misses for e in self._shapes.values()),
                "epoch": self.epoch,
            }
