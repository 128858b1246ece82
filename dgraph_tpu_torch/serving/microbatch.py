"""Cross-query micro-batcher for (predicate, level) tasks.

Every query level in this engine is already ONE vectorized task (PR 2:
`LocalCache.uids_many` / `values_many` — a single MemoryLayer pass plus
one native decode of the whole level into a ragged `(flat, offsets)`
buffer). Under high QPS many concurrent queries issue the *same-shape*
task — same predicate, same read snapshot — within microseconds of each
other, each paying the fixed dispatch cost (memlayer lock pass, native
call marshaling, decode setup) separately.

The MicroBatcher coalesces them *behind the running dispatch* (the
natural-batching shape, not an artificial delay): a task whose group
key is idle dispatches IMMEDIATELY — zero added latency — while a task
arriving during an in-flight same-key dispatch opens (or joins) the
NEXT batch, which fires as soon as the runner completes (bounded by
`DGRAPH_TPU_BATCH_WINDOW_US`, the cap on how long a batch waits behind
its runner; 0 disables the batcher entirely — callers never reach
submit). Under load, same-shape arrivals therefore pile into combined
dispatches exactly when dispatches are the bottleneck; when the server
is idle nothing ever waits. The batch leader runs ONE combined read
over the concatenation of every member's keys and demuxes per-member
row slices of the shared ragged buffer — row i of a combined
`uids_many` is computed exactly as row i of a solo call, so the
demuxed slices are byte-identical to what each member would have read
alone (the same argument test_parallel_exec.py makes for the worker
pool: a pure performance knob).

Group keys bind members to one read SNAPSHOT, not one read timestamp:
every query allocates a fresh read_ts, so keying on the ts would never
coalesce anything. Instead the engine exposes its last-commit
watermark (`last_commit_fn`, published BEFORE the commit's apply
barrier): two queries whose read timestamps both cover the same
watermark see byte-identical stores — any commit between their
timestamps would have advanced the watermark before either of them got
past the read_ts apply-wait, and any commit after the younger token
read carries a commit_ts above both timestamps (timestamps are
allocated monotonically) and is invisible to both. A watermark ABOVE a
query's read_ts means the snapshot is genuinely ts-dependent; that
query falls back to exact-ts grouping (no coalescing, never
incorrectness). The argument covers only FRESH engine-allocated
timestamps — caller-pinned read_ts queries never receive a batcher at
the entry points — and inherits the oracle's own caveat: a read_ts
issued after the bounded applied-wait gave up (30s, staleness over
deadlock) already reads best-effort; coalescing such queries keeps
them consistent with each other. Only delta-free caches are eligible
(the executor routes txn-snapshot reads around the batcher), so any
member's cache can execute the combined read for all of them.

Locking: two small, strictly-layered domains. The batcher lock guards
the group/runner maps and group MEMBERSHIP (joins, close, snapshot) —
only ever held for pointer work, never across a wait or a read. Each
group owns an independent Condition guarding its RESULT hand-off
(done/go/results/error); every wait happens under that cv with the
batcher lock already released, and wakeups stay scoped to one group's
waiters (a shared condvar was a measurable thundering herd at 16
clients). The combined read — the blocking, native-calling part —
runs under no lock at all, so the lock-discipline analyzer passes this
module with no allowlist entry.

Tracing: the leader wraps the combined read in a `batch_dispatch` span
carrying every member's traceparent as span links (`link.N` attrs).
Each member still records its own `level_task` span under its own
query's trace — one trace per query survives coalescing; the links are
how a coalesced dispatch is attributed to all of its queries.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.utils.observe import METRICS, TRACER, format_traceparent
from dgraph_tpu_torch.x import config


def window_us() -> int:
    """Current batching window (µs); 0 = batcher off. Re-read per call
    so tests and operators can flip it without rebuilding engines."""
    return max(0, int(config.get("BATCH_WINDOW_US")))


class _Group:
    """One open coalescing group. Membership fields (members, contexts,
    closed) are guarded by the BATCHER lock; hand-off fields (done, go,
    results, error) by the group's own `cv` — waiters never hold the
    batcher lock (see the module docstring's locking contract)."""

    __slots__ = (
        "cv", "members", "caches", "contexts", "closed", "done", "go",
        "results", "error",
    )

    def __init__(self):
        self.cv = threading.Condition()
        self.members: List[list] = []  # per-member keys_list
        self.caches: List[object] = []  # per-member LocalCache
        self.contexts: List[Optional[object]] = []  # member trace ctxs
        self.closed = False  # no further joins (leader is dispatching)
        self.done = False  # results/error populated
        self.go = False  # the running dispatch ahead of us finished
        self.results: List[object] = []
        self.error: Optional[BaseException] = None


# members per batch before new arrivals dispatch on their own: a batch
# the width of the whole client population convoys every thread onto
# one dispatch and releases them in a stampede — worse tail latency
# than the dispatch it saved (measured at 16 closed-loop clients)
_MAX_MEMBERS = 4


class MicroBatcher:
    """Behind-the-runner coalescer for level-task reads.

    `inflight_fn` reports the engine's in-flight query count (the
    admission controller's gauge): with zero or one query in flight the
    batcher steps aside entirely (direct path, not even a lock touch
    beyond the count read), so an idle server and `BATCH_WINDOW_US=0`
    behave identically."""

    def __init__(
        self,
        inflight_fn: Optional[Callable[[], int]] = None,
        last_commit_fn: Optional[Callable[[], int]] = None,
    ):
        self._lock = threading.Lock()
        self._pending: Dict[tuple, _Group] = {}
        self._running: Dict[tuple, int] = {}  # key -> dispatches in flight
        self._inflight_fn = inflight_fn
        self._last_commit_fn = last_commit_fn

    def _snapshot_token(self, cache) -> tuple:
        """Snapshot identity of a delta-free cache: the engine's
        last-commit watermark when it is covered by this cache's
        read_ts (see the module docstring for why that is sound), else
        the exact read_ts (sound but never coalesces)."""
        if self._last_commit_fn is not None:
            snap = int(self._last_commit_fn())
            if snap <= cache.read_ts:
                return ("commit", snap)
        return ("ts", cache.read_ts)

    # -- public read API ----------------------------------------------------

    @staticmethod
    def _kv_identity(cache):
        """Store identity for the group key: kvs may advertise a stable
        `coalesce_key` (per-query RemoteKV facades over one cluster are
        read-interchangeable); otherwise object identity."""
        return getattr(cache.kv, "coalesce_key", None) or id(cache.kv)

    def read_uids(self, attr: str, cache, keys_list: list):
        """Coalesced `cache.uids_many(keys_list)`: returns the member's
        own (flat, offsets, toks) slice of the combined level read."""
        key = (
            "uids", attr, self._kv_identity(cache), id(cache.mem),
            self._snapshot_token(cache),
        )
        return self._submit(
            key, cache, keys_list, self._run_uids, self._split_uids
        )

    def read_values(self, attr: str, cache, keys_list: list):
        """Coalesced `cache.values_many(keys_list)`: returns the
        member's aligned postings lists."""
        key = (
            "values", attr, self._kv_identity(cache), id(cache.mem),
            self._snapshot_token(cache),
        )
        return self._submit(
            key, cache, keys_list, self._run_values, self._split_values
        )

    def read_similar(self, attr: str, cache, index, qvec, k: int):
        """Coalesced plain (unfiltered) `similar_to`: concurrent vector
        searches against the same index, same k, same snapshot become
        ONE `index.search_batch` dispatch; each member gets its own row.
        Rows of a batch are scored independently by the same kernels
        (models/vector.py search_one), so the demuxed row is
        byte-identical to the member's solo search — the same argument
        read_uids makes for level reads. k joins the group key (a
        combined dispatch has one k); the snapshot token binds members
        to one store state, which covers the index too: vector-index
        mutations happen at commit apply, behind the same watermark."""
        key = (
            "similar", attr, self._kv_identity(cache), id(index), int(k),
            self._snapshot_token(cache),
        )

        def run(_cache, all_vecs):
            return index.search_batch(np.stack(all_vecs), k)

        def split(combined, spans):
            return [combined[r0:r1] for r0, r1 in spans]

        return self._submit(key, cache, [qvec], run, split)[0]

    # -- combined executors (leader only, lock NOT held) ----------------------

    @staticmethod
    def _run_uids(cache, all_keys: list):
        return cache.uids_many(all_keys)

    @staticmethod
    def _run_values(cache, all_keys: list):
        return cache.values_many(all_keys)

    @staticmethod
    def _split_uids(combined, spans: List[Tuple[int, int]]):
        flat, offs, toks = combined
        out = []
        for r0, r1 in spans:
            base = offs[r0]
            out.append(
                (
                    flat[base : offs[r1]],
                    offs[r0 : r1 + 1] - base,
                    toks[r0:r1],
                )
            )
        return out

    @staticmethod
    def _split_values(combined, spans: List[Tuple[int, int]]):
        return [combined[r0:r1] for r0, r1 in spans]

    # -- core ----------------------------------------------------------------

    @staticmethod
    def _note_plan(members: int) -> None:
        """EXPLAIN capture: this member's coalescing outcome (solo vs
        coalesced dispatch and the batch width) — debug queries only."""
        from dgraph_tpu_torch.utils.observe import current_plan

        plan = current_plan()
        if plan is not None:
            plan.note_microbatch(members)

    def _submit(self, key, cache, keys_list, run, split):
        win = window_us()
        inflight = (
            self._inflight_fn() if self._inflight_fn is not None else 0
        )
        if win <= 0 or inflight <= 1:
            # off switch / nobody to coalesce with: today's direct path
            self._note_plan(1)
            return run(cache, keys_list)
        lead = False
        with self._lock:
            g = self._pending.get(key)
            if (
                g is not None
                and not g.closed
                and len(g.members) < _MAX_MEMBERS
            ):
                # a batch is already forming behind the running
                # dispatch: join it (membership under the batcher
                # lock), then wait for its leader on the group cv
                idx = len(g.members)
                g.members.append(keys_list)
                g.caches.append(cache)
                g.contexts.append(TRACER.current_context())
            elif g is not None or not self._running.get(key):
                # idle key — dispatch IMMEDIATELY, the batcher adds
                # zero latency when there is nothing to coalesce with —
                # or the forming batch is already full: dispatch alone
                # rather than grow the convoy (correct either way;
                # dispatches for one key may overlap freely)
                self._running[key] = self._running.get(key, 0) + 1
                g = None
            else:
                # a same-key dispatch is in flight: open the next batch
                # and lead it; it fires the moment the runner completes
                # (the window only caps how long we wait for that)
                lead = True
                g = _Group()
                g.members.append(keys_list)
                g.caches.append(cache)
                g.contexts.append(TRACER.current_context())
                self._pending[key] = g
        if g is not None and not lead:
            # follower: batcher lock released; wait on the group cv —
            # but never past the follower's OWN ambient deadline (a
            # stalled leader must not convert a tight-deadline query
            # into a full-budget one). On expiry, bail out to a solo
            # read at the same snapshot; the group slice is ignored.
            from dgraph_tpu_torch.conn.retry import current_deadline

            dl = current_deadline()
            bailed = False
            with g.cv:
                while not g.done:
                    if dl is not None and dl.expired():
                        bailed = True
                        break
                    g.cv.wait(
                        timeout=(
                            None
                            if dl is None
                            else max(0.001, min(0.05, dl.remaining()))
                        )
                    )
            if bailed:
                self._note_plan(1)
                return run(cache, keys_list)
            if g.error is not None:
                # the LEADER failed (its deadline, its RPC fault) — that
                # must not fail healthy members that would have
                # succeeded solo; re-read alone at the same snapshot
                # and let any genuine store error surface as our own
                self._note_plan(1)
                return run(cache, keys_list)
            self._note_plan(len(g.results))
            return g.results[idx]
        if g is not None:
            # batch leader: wait (bounded) for the runner ahead of us,
            # then close the group and take over the key
            end = time.monotonic() + win / 1e6
            with g.cv:
                while not g.go:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    g.cv.wait(timeout=remaining)
            with self._lock:
                g.closed = True
                if self._pending.get(key) is g:
                    del self._pending[key]
                self._running[key] = self._running.get(key, 0) + 1
                members = list(g.members)
        try:
            if g is None:
                self._note_plan(1)
                return run(cache, keys_list)
            spans: List[Tuple[int, int]] = []
            row = 0
            for m in members:
                spans.append((row, row + len(m)))
                row += len(m)
            all_keys = [k for m in members for k in m]
            # partial-read degradation (PR 3) must reach every member:
            # the combined read runs on the LEADER's kv, so any group
            # it finds unreachable is copied to the other members' kvs
            # before their entry points inspect degraded_groups
            lead_dg = getattr(cache.kv, "degraded_groups", None)
            pre_dg = set(lead_dg) if lead_dg is not None else set()
            try:
                if len(members) > 1:
                    METRICS.inc("batch_coalesced_total", len(members))
                    attrs = {
                        "members": len(members), "rows": len(all_keys)
                    }
                    for i, ctx in enumerate(g.contexts):
                        if ctx is not None:
                            attrs[f"link.{i}"] = format_traceparent(ctx)
                    with TRACER.span("batch_dispatch", **attrs):
                        combined = run(cache, all_keys)
                else:
                    combined = run(cache, all_keys)
                results = split(combined, spans)
                if lead_dg is not None:
                    new_dg = set(lead_dg) - pre_dg
                    if new_dg:
                        for mc in g.caches:
                            mdg = getattr(
                                mc.kv, "degraded_groups", None
                            )
                            if mdg is not None and mc.kv is not cache.kv:
                                mdg.update(new_dg)
            except BaseException as exc:
                with g.cv:
                    g.error = exc
                    g.done = True
                    g.cv.notify_all()
                raise
            with g.cv:
                g.results = results
                g.done = True
                g.cv.notify_all()
            self._note_plan(len(members))
            return results[0]
        finally:
            # hand the key to the batch that formed behind us
            with self._lock:
                n = self._running.get(key, 1) - 1
                if n > 0:
                    self._running[key] = n
                else:
                    self._running.pop(key, None)
                nxt = self._pending.get(key)
                if nxt is not None and nxt.closed:
                    nxt = None
            if nxt is not None:
                with nxt.cv:
                    if not nxt.go:
                        nxt.go = True
                        nxt.cv.notify_all()
