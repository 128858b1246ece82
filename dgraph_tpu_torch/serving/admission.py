"""Token-based admission control for the query entry points.

The failure mode admission exists for: offered load crosses the
service capacity, queues build, every query's latency grows without
bound, and the server ends up doing work for clients that have long
since timed out. The policy here is the standard one — bound the work
in flight, shed the excess *fast* with a retryable error, and when the
slow-query signal says the server is already saturated, degrade
(bounded budget, partial response) rather than queue.

Cost model: one admitted query consumes `cost` tokens out of
`DGRAPH_TPU_MAX_INFLIGHT`. Cost is estimated BEFORE execution from
what the serving front already knows:

  - the plan cache's per-shape latency EWMA (a shape observed at 80ms
    admits as 8x the cost of an 10ms shape), normalized so a
    cheap-or-unknown shape costs 1 token;
  - StatsHolder selectivity of the root function (an eq() whose index
    term matches millions of uids is charged more than a point
    lookup) — the same sketch that drives the packed-kernel crossover;
  - real executor backpressure: the exec-worker pool's queue depth
    (query/subgraph.pool_backpressure) is added on top, so admission
    tightens exactly when the pool is the bottleneck instead of
    guessing from counts alone.

Shedding raises TooManyRequestsError (`too_many_requests`) — mapped to
HTTP 429 by the front-ends and marked retryable so clients back off
and retry (conn/retry.retrying_call). Degradation is decided here but
executed by the caller: `Ticket.degrade` tells the entry point to run
with a bounded time budget and return a partial/degraded response on
budget exhaustion (PR 3's partial-result shape) instead of joining the
queue at full budget.

The in-flight gauge is tracked even when admission is off
(DGRAPH_TPU_ADMISSION=0): the micro-batcher uses it to skip the window
when the server is idle.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config

# saturation signal: this many slow queries inside the sliding window
_SLOW_WINDOW_S = 10.0
_SLOW_SATURATED = 5
# pool queue depth at/above which admission degrades new arrivals
_QUEUE_SATURATED = 8


class TooManyRequestsError(Exception):
    """Admission gate refusal: the server is over its in-flight budget.
    Retryable — clients should back off and resend (HTTP 429)."""

    code = "too_many_requests"
    retryable = True


class Ticket:
    __slots__ = ("cost", "degrade")

    def __init__(self, cost: float, degrade: bool):
        self.cost = cost
        self.degrade = degrade


class AdmissionController:
    def __init__(self, plan_cache=None, stats=None, schema_fn=None):
        self._lock = threading.Lock()
        self.plan_cache = plan_cache
        self.stats = stats  # StatsHolder (selectivity sketch)
        # schema GETTER, not the State object: engines rebind their
        # schema wholesale (Server.alter drop_all), and a captured
        # reference would consult the dropped schema forever
        self.schema_fn = schema_fn
        self.inflight_cost = 0.0
        self.inflight = 0
        self._slow_at: deque = deque()  # monotonic stamps of slow queries

    # -- config ---------------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        return bool(config.get("ADMISSION"))

    @staticmethod
    def max_inflight() -> float:
        return max(1.0, float(config.get("MAX_INFLIGHT")))

    # -- cost estimation ------------------------------------------------------

    def estimate_cost(self, shape: Optional[str], blocks=None) -> float:
        """Tokens this query is expected to consume (>= 1)."""
        cost = 1.0
        if self.plan_cache is not None:
            ms = self.plan_cache.estimated_cost_ms(shape)
            if ms is not None:
                # 10ms of observed latency per token
                cost = max(cost, ms / 10.0)
        if self.stats is not None and blocks:
            try:
                cost += self._selectivity_cost(blocks)
            except Exception:
                pass  # stats are advisory; never fail admission on them
        return cost

    def _selectivity_cost(self, blocks) -> float:
        """Extra tokens from StatsHolder root-function selectivity: eq()
        args are keyed the same way the index feeds the sketch (the
        predicate's own tokenizers), +1 token per 100k estimated uids."""
        from dgraph_tpu_torch.tok.tok import build_tokens
        from dgraph_tpu_torch.types.types import TypeID, Val

        schema = self.schema_fn() if self.schema_fn is not None else None
        extra = 0.0
        for b in blocks:
            fn = getattr(b, "func", None)
            if fn is None or fn.name != "eq" or not fn.attr:
                continue
            su = schema.get(fn.attr) if schema is not None else None
            if su is None:
                continue
            tokenizers = su.tokenizer_objs()
            for a in fn.args:
                if isinstance(a, tuple):
                    continue  # val(x) args have no static selectivity
                try:
                    toks = build_tokens(
                        Val(TypeID.STRING, str(a)), tokenizers
                    )
                except Exception:
                    continue
                n = max(
                    (self.stats.estimate(fn.attr, t) for t in toks),
                    default=0,
                )
                if n:
                    extra += min(64.0, n / 1e5)
        return extra

    # -- saturation signal ----------------------------------------------------

    def note_slow(self) -> None:
        """Called by the entry points when a query crossed the
        slow-query threshold (the slow-query log's signal)."""
        now = time.monotonic()
        with self._lock:
            self._slow_at.append(now)
            while self._slow_at and self._slow_at[0] < now - _SLOW_WINDOW_S:
                self._slow_at.popleft()

    def saturated(self) -> bool:
        """True when the slow-query log or the exec pool's queue says
        the server is already past its comfortable operating point."""
        now = time.monotonic()
        with self._lock:
            while self._slow_at and self._slow_at[0] < now - _SLOW_WINDOW_S:
                self._slow_at.popleft()
            slow = len(self._slow_at)
        if slow >= _SLOW_SATURATED:
            return True
        from dgraph_tpu_torch.query.subgraph import pool_backpressure

        queued, _ = pool_backpressure()
        return queued >= _QUEUE_SATURATED

    # -- the gate -------------------------------------------------------------

    def admit(self, shape: Optional[str], blocks=None) -> Ticket:
        """Admit one query or raise TooManyRequestsError. Always call
        `release(ticket)` in a finally block."""
        cost = self.estimate_cost(shape, blocks)
        enabled = self.enabled()
        # the saturation signal is advisory and reads its own state, so
        # it is sampled OUTSIDE the budget lock; the budget check and
        # the charge happen in ONE lock hold — a burst of concurrent
        # arrivals must not all pass the check before any of them
        # charges (that would blow the budget exactly under the load
        # the gate exists for)
        degrade = enabled and self.saturated()
        self._charge(cost, enabled, "retry with backoff")
        if degrade:
            METRICS.inc("admission_degraded_total")
        return Ticket(cost, degrade)

    def _charge(self, cost: float, enabled: bool, retry_hint: str) -> None:
        """The locked check-and-charge shared by the query and write
        gates: the budget check and the charge happen in ONE lock hold
        (a burst of arrivals must not all pass the check before any of
        them charges)."""
        with self._lock:
            if enabled:
                limit = self.max_inflight()
                if self.inflight_cost + cost > limit and self.inflight > 0:
                    METRICS.inc("admission_shed_total")
                    raise TooManyRequestsError(
                        f"server over in-flight budget "
                        f"({self.inflight_cost:.0f}+{cost:.0f} > "
                        f"{limit:.0f} tokens); {retry_hint}"
                    )
            self.inflight += 1
            self.inflight_cost += cost
            METRICS.set_gauge("admission_inflight_queries", self.inflight)

    # one token per this many postings in a write's delta set (a small
    # txn costs 1 token like a cheap query; a bulk-ish live ingest
    # charges proportionally — writes compete for the same budget
    # instead of riding under the gate while queries are shed)
    _EDGES_PER_TOKEN = 50.0

    def admit_write(self, n_edges: int) -> Ticket:
        """Admit one commit or raise TooManyRequestsError (retryable,
        HTTP 429). Writes charge the SAME in-flight token budget as
        queries: under overload a server that sheds reads but admits
        unlimited mutations just moves the queue to the write path.
        Always call `release(ticket)` in a finally block."""
        cost = max(1.0, float(n_edges) / self._EDGES_PER_TOKEN)
        self._charge(cost, self.enabled(), "retry the commit with backoff")
        return Ticket(cost, False)

    def release(self, ticket: Ticket) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
            self.inflight_cost = max(0.0, self.inflight_cost - ticket.cost)
            METRICS.set_gauge("admission_inflight_queries", self.inflight)

    def inflight_count(self) -> int:
        return self.inflight
