"""ServingFront: the per-engine bundle of plan cache, result cache,
micro-batcher, and admission controller.

One instance per engine (api/server.Server, worker/harness.ProcCluster).
The entry points drive it in four places:

    blocks, shape, lits = front.parse(q, variables)  # plan cache
    ticket = front.admit(shape, blocks)         # admission gate (raises)
    ...result-cache probe (shape, lits, watermark), else execute with
       batcher=front.batcher_for(cache)...
    front.finish(ticket, shape, took_ms, slow)  # stats + release

`on_commit()` hooks the engine's commit/alter paths: it bumps the plan
cache epoch so no cached plan survives a commit unrevalidated. The
result cache needs no hook — its keys carry the snapshot watermark,
which every commit/alter advances (serving/resultcache.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

from dgraph_tpu_torch.serving.admission import AdmissionController, Ticket
from dgraph_tpu_torch.serving.microbatch import MicroBatcher, window_us
from dgraph_tpu_torch.serving.plancache import PlanCache, normalize
from dgraph_tpu_torch.serving.resultcache import ResultCache


class ServingFront:
    def __init__(self, stats=None, schema_fn=None, last_commit_fn=None):
        self.plan_cache = PlanCache()
        # snapshot-keyed whole-response reuse (watermark-keyed; off by
        # default via DGRAPH_TPU_RESULT_CACHE_SIZE=0)
        self.results = ResultCache()
        # schema_fn: a getter, so engines that rebind their schema
        # wholesale (drop_all) are always read fresh
        self.admission = AdmissionController(
            plan_cache=self.plan_cache, stats=stats, schema_fn=schema_fn
        )
        # last_commit_fn: the engine's last-commit watermark (published
        # before the commit's apply barrier) — the batcher's snapshot
        # identity; None = exact-ts grouping (never coalesces)
        self.batcher = MicroBatcher(
            inflight_fn=self.admission.inflight_count,
            last_commit_fn=last_commit_fn,
        )

    # -- plan cache -----------------------------------------------------------

    def parse(
        self, q: str, variables=None, info: Optional[dict] = None
    ) -> Tuple[list, Optional[str], Optional[tuple]]:
        """dql.parse through the plan cache. Returns (blocks, shape,
        literals); shape is None when the query doesn't lex (parse
        raises the real error) — such queries bypass both caches. The
        literal tuple is the result cache's binding component (shape +
        literals + variables reconstruct the query modulo whitespace).
        With the plan cache disabled (PLAN_CACHE_SIZE=0) but the
        result cache on, normalization still runs — the result cache
        needs the shape key; with BOTH disabled the second tokenize is
        skipped outright.

        `info`, when given (debug/EXPLAIN requests), is filled with the
        plan-cache outcome: {"hit": bool, "shape": normalized-key,
        "enabled": bool} — the entry point folds it into
        extensions.plan."""
        from dgraph_tpu_torch import dql

        plan_on = self.plan_cache.capacity() > 0
        if not plan_on and self.results.capacity() == 0:
            if info is not None:
                info.update(enabled=False, hit=False, shape=None)
            return dql.parse(q, variables), None, None
        norm = normalize(q)
        if norm is None:
            if info is not None:
                info.update(enabled=plan_on, hit=False, shape=None)
            return dql.parse(q, variables), None, None
        shape, literals = norm
        if not plan_on:
            if info is not None:
                info.update(enabled=False, hit=False, shape=shape)
            return dql.parse(q, variables), shape, literals
        blocks = self.plan_cache.get(shape, literals, variables)
        hit = blocks is not None
        if blocks is None:
            blocks = dql.parse(q, variables)
            self.plan_cache.put(shape, literals, blocks, variables)
        if info is not None:
            info.update(enabled=True, hit=hit, shape=shape)
        return blocks, shape, literals

    # -- result cache ---------------------------------------------------------

    def result_probe(
        self, shape, literals, variables, ns: int, watermark: int,
        debug: bool = False,
    ):
        """Key + lookup for one result-cache-ELIGIBLE query — callers
        gate the entry-point-specific conditions first (no pinned
        read_ts, no ACL, cluster not degraded). Returns (key, raw_hit,
        would_hit): key None when the cache is off, the query didn't
        normalize, or nothing has committed yet; debug probes presence
        WITHOUT serving (EXPLAIN always executes). One implementation
        for both engines so key composition can never drift between
        them."""
        rc = self.results
        if shape is None or not watermark or rc.capacity() == 0:
            return None, None, False
        key = rc.key(
            shape, literals, variables, int(ns), int(watermark),
            epoch=self.plan_cache.epoch,
        )
        if debug:
            return key, None, rc.peek(key)
        return key, rc.get(key), False

    # -- admission ------------------------------------------------------------

    def admit(self, shape: Optional[str], blocks=None) -> Ticket:
        return self.admission.admit(shape, blocks)

    def admit_write(self, n_edges: int) -> Ticket:
        """Admission for the commit path: writes cost tokens out of the
        same in-flight budget queries draw from (raises the retryable
        TooManyRequestsError over budget). Pair with release_write."""
        return self.admission.admit_write(n_edges)

    def release_write(self, ticket: Ticket) -> None:
        self.admission.release(ticket)

    def finish(
        self,
        ticket: Optional[Ticket],
        shape: Optional[str],
        took_ms: float,
        slow: bool = False,
    ) -> None:
        """End-of-query bookkeeping. Callers pass shape=None for
        anything that did NOT run to clean completion (shed, error,
        budget-truncated) — those latencies describe the failure mode,
        not the shape, and would decay the cost EWMA exactly when
        admission depends on it. A degraded-admission query's slowness
        likewise must not refresh the saturation signal that degraded
        it (self-latch), so its `slow` is suppressed."""
        if shape is not None:
            self.plan_cache.observe_cost(shape, took_ms)
        if slow and (ticket is None or not ticket.degrade):
            self.admission.note_slow()
        if ticket is not None:
            self.admission.release(ticket)

    def degrade_budget_s(self) -> float:
        """The bounded time budget a degraded-admission query runs
        under: the slow-query threshold (a degraded query must never
        itself become a slow query)."""
        from dgraph_tpu_torch.x import config

        return max(0.01, float(config.get("SLOW_QUERY_MS")) / 1e3)

    # -- read-plane context ---------------------------------------------------

    def read_context(self):
        """Fresh per-query ReadContext for the resilient read plane:
        ONE RetryBudget (DGRAPH_TPU_READ_RETRY_BUDGET tokens) that every
        group-read retry and hedge of the query draws from, plus the
        leaderless-serving notes the entry point surfaces as the
        `degraded: leaderless` extension. Budget 0 disables budgeting
        (never exhausted)."""
        from dgraph_tpu_torch.conn.retry import RetryBudget
        from dgraph_tpu_torch.worker.remote import ReadContext
        from dgraph_tpu_torch.x import config

        n = int(config.get("READ_RETRY_BUDGET"))
        return ReadContext(budget=RetryBudget(n) if n > 0 else None)

    # -- micro-batcher --------------------------------------------------------

    def batcher_for(self, cache) -> Optional[MicroBatcher]:
        """The batcher, or None when batching is off or this cache is
        ineligible (txn-local deltas make its reads private). Window 0
        must restore today's exact path, so the executor sees no
        batcher at all then."""
        if window_us() <= 0 or cache.deltas:
            return None
        return self.batcher

    # -- invalidation ----------------------------------------------------------

    def on_commit(self) -> None:
        self.plan_cache.invalidate()
