"""Coordinator-side view of a multi-process cluster.

Mirrors the reference's query-side fan-out (worker/task.go:2224
ProcessTaskOverNetwork -> group pick -> gRPC) and mutation forwarding
(worker/mutation.go proposeOrSend): reads route by tablet to a healthy
replica of the owning group with request hedging (task.go:60 — a backup
request fires if the primary is slow; first answer wins), proposals go to
the group leader with not-leader retry.

Failure semantics (PR 3 resilience layer):
  - every retry loop here runs the shared RetryPolicy (full-jitter
    backoff) under the ambient Deadline stamped by the query/commit
    entry point (conn/retry.py) instead of fixed 50ms sleeps and
    per-layer 5s/15s budgets;
  - proposals go out `idem=True`, so a transport-level resend after a
    lost ack dedupes in the server's idempotency LRU;
  - a group whose every replica has an open circuit fails fast with
    GroupUnavailableError instead of burning the caller's deadline, and
    RemoteKV (in `partial_ok` mode, used by queries) converts that into
    an empty read plus a degraded marker the entry point surfaces in
    the response extensions;
  - hedged reads run on one shared bounded executor; losing futures are
    cancelled or reaped via done-callbacks (never abandoned), with
    `hedge_wins` / `hedge_losses_joined` counters. When every pool
    worker is busy the hedge is SKIPPED (`hedge_skipped_saturated_
    total`) — a queued hedge fires after its deadline and only wastes
    a replica read.

Resilient read plane (this PR):
  - follower read routing under the PR 11 watermark rule: each group
    tracks a read FLOOR (the max raft index any completed proposal
    returned — recorded before the snapshot watermark advances), and
    any replica whose TTL-fresh applied index covers the floor serves
    provably identical bytes at the watermark. The floor is TRI-STATE:
    it starts UNKNOWN (a freshly started or restarted coordinator), and
    while unknown NO follower is eligible — a zero floor would
    otherwise "cover" pre-restart writes this process knows nothing
    about, letting a lagging follower serve stale bytes at a watermark
    the caller already observed. The first leader health reply or
    completed proposal establishes a real floor and re-enables follower
    serving. A leaderless group (election, SIGKILL, partition) keeps
    serving watermark reads; the query surfaces `degraded: leaderless`
    instead of erroring.
  - candidates are ordered by the health-aware ReplicaPicker
    (worker/replicapick.py): latency EWMA + per-replica circuit
    breaker, replacing the blind leader-then-one-follower hedge order,
    and one failed attempt rotates through ALL remaining candidates
    before the outer loop backs off.
  - retries and hedges draw from ONE per-query RetryBudget carried on
    the ReadContext; exhaustion raises RetryBudgetExhausted, a
    retryable 503 at the HTTP edge — brownouts shed instead of
    retry-storming.

The RemoteKV satisfies the same KV read interface the executor uses, so
the whole query engine runs unchanged against OS-process alphas.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import threading
import time
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.conn.frame import pack_body
from dgraph_tpu_torch.conn.messages import GetRequest, IterateRequest, Proposal
from dgraph_tpu_torch.conn.retry import (
    Deadline, RetryBudget, RetryPolicy, effective_deadline,
)
from dgraph_tpu_torch.conn.rpc import PeerDownError, RpcError, RpcPool
from dgraph_tpu_torch.storage.kv import KV
from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.worker.replicapick import ReplicaPicker
from dgraph_tpu_torch.x import config, keys


class GroupUnavailableError(RpcError):
    """No replica of a raft group is reachable (all circuits open or the
    deadline ran out probing). Queries degrade; commits surface it."""

    def __init__(self, gid: int, detail: str = ""):
        super().__init__(f"group {gid} unavailable: {detail}")
        self.gid = gid


class RetryBudgetExhausted(RpcError):
    """The query's shared retry/hedge budget ran dry mid-read. Retryable
    by contract: the CLIENT backs off and re-issues with a fresh budget;
    this process refuses to amplify a brownout any further."""

    retryable = True
    code = "retry_budget_exhausted"

    def __init__(self, gid: int, detail: str = ""):
        super().__init__(
            f"group {gid}: read retry budget exhausted: {detail}"
        )
        self.gid = gid


class ReadContext:
    """Per-query read-plane state, shared by every group read the query
    fans out to: ONE RetryBudget (retries and hedges all draw from it)
    plus degradation notes the entry point surfaces in the response
    extensions. Thread-safe — sibling executor workers and hedge
    threads share it."""

    __slots__ = ("budget", "leaderless_gids", "follower_reads", "_lock")

    def __init__(self, budget: Optional[RetryBudget] = None):
        self.budget = budget
        self.leaderless_gids: set = set()
        self.follower_reads = 0
        self._lock = threading.Lock()

    def charge(self, n: int = 1) -> bool:
        """Spend budget for a re-issue (retry or hedge). True when no
        budget is installed — budgeting off means never exhausted."""
        if self.budget is None:
            return True
        return self.budget.try_spend(n)

    def note_leaderless(self, gid: int):
        with self._lock:
            self.leaderless_gids.add(gid)

    def note_follower_read(self):
        with self._lock:
            self.follower_reads += 1


_HEDGE_LOCK = threading.Lock()
_HEDGE_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_HEDGE_WORKERS = 16
# free hedge-pool slots: acquired non-blocking before every submit, so a
# saturated pool SKIPS the hedge instead of queueing it behind 16 slow
# reads (released by the future's done-callback)
_HEDGE_SLOTS = threading.BoundedSemaphore(_HEDGE_WORKERS)


def _hedge_pool() -> concurrent.futures.ThreadPoolExecutor:
    """One shared bounded executor for hedge requests (the old
    per-read ThreadPoolExecutor leaked its threads via
    shutdown(wait=False) whenever the loser was still in flight)."""
    global _HEDGE_POOL
    with _HEDGE_LOCK:
        if _HEDGE_POOL is None:
            _HEDGE_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=_HEDGE_WORKERS, thread_name_prefix="hedge"
            )
        return _HEDGE_POOL


_SWEEP_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _sweep_pool() -> concurrent.futures.ThreadPoolExecutor:
    """Dedicated executor for background health sweeps, separate from
    the hedge pool for two reasons: hedge-slot accounting stays
    truthful (a hedge that won a _HEDGE_SLOTS slot must never queue
    behind a sweep), and sweep latency stays bounded — queued behind 16
    slow hedged reads, a sweep could let every health row age past the
    TTL and silently disable follower reads exactly when an overloaded
    cluster needs them."""
    global _SWEEP_POOL
    with _HEDGE_LOCK:
        if _SWEEP_POOL is None:
            _SWEEP_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="healthsweep"
            )
        return _SWEEP_POOL


def _reap_loser(f: concurrent.futures.Future):
    """Done-callback joining a losing hedge future: consume its result
    or exception so nothing dangles on the client locks unobserved."""
    try:
        f.result()
    except Exception:
        pass
    METRICS.inc("hedge_losses_joined")


class RemoteGroup:
    """Client handle for one raft group of alpha processes."""

    retry = RetryPolicy(base=0.02, cap=0.5)

    def __init__(self, gid: int, rpc_addrs: List[Tuple[str, int]], pool: RpcPool):
        self.gid = gid
        self.addrs = [tuple(a) for a in rpc_addrs]
        self.pool = pool
        self._leader: Optional[Tuple[str, int]] = None
        self._leader_at = 0.0
        self.picker = ReplicaPicker(gid, self.addrs)
        # read floor: the highest raft index any completed proposal
        # returned (plus any applied index seen ON the leader). Recorded
        # before the coordinator advances its snapshot watermark, so by
        # the time a watermark is visible to queries the floor covering
        # it is too — a follower with applied >= floor provably serves
        # identical bytes at that watermark. UNKNOWN until the first
        # leader reply / completed proposal (`_floor_known`): a fresh
        # coordinator must not treat 0 as a floor, because watermarks
        # from persisted Zero state can cover pre-restart writes that
        # a behind follower at "applied >= 0" does not hold.
        self._floor = 0
        self._floor_known = False
        self._floor_lock = threading.Lock()
        self._refresh_gate = threading.Lock()  # one health refresh in flight

    def healthy_addrs(self) -> List[Tuple[str, int]]:
        healthy = [a for a in self.addrs if self.pool.healthy(a)]
        return healthy or list(self.addrs)

    def all_down(self) -> bool:
        return not any(self.pool.healthy(a) for a in self.addrs)

    def read_floor(self) -> Optional[int]:
        """The verified read floor, or None while it is UNKNOWN (no
        leader reply / completed proposal yet on this process). None
        makes every follower ineligible in the picker."""
        return self._floor if self._floor_known else None

    def note_floor(self, idx: int):
        """Record a verified floor source: a completed proposal's index
        or a leader's applied index. Marks the floor KNOWN — this is
        the only way follower serving turns on."""
        with self._floor_lock:
            self._floor_known = True
            if idx > self._floor:
                self._floor = idx

    def _note_health(self, addr, h):
        """Feed one health reply into the picker; a LEADER reply also
        establishes/raises the floor from its applied index — after a
        coordinator restart (floor UNKNOWN, followers ineligible) the
        first leader probe restores a floor that covers all pre-restart
        data, so a snapshotting-behind follower cannot serve it stale;
        until that reply arrives no follower serves at all."""
        try:
            applied = int(getattr(h, "applied", 0) or 0)
        except (TypeError, ValueError):
            return
        self.picker.note_health(addr, applied, bool(h.is_leader))
        if h.is_leader:
            self.note_floor(applied)

    def leader_addr(self, timeout: float = 5.0,
                    deadline: Optional[Deadline] = None) -> Optional[Tuple[str, int]]:
        # short-lived cache: reads are leader-first (committed writes wait
        # only for the leader's apply, so followers may lag) and probing
        # health on every read would double RPC traffic
        if self._leader is not None and time.time() - self._leader_at < 1.0:
            if self.pool.healthy(self._leader):
                return self._leader
        dl = deadline or effective_deadline(timeout)
        attempt = 0
        while True:
            all_failfast = True
            found: Optional[Tuple[str, int]] = None
            # probe the WHOLE replica set even after the leader answers:
            # each reply feeds the picker's applied-index cache, which is
            # what makes followers eligible under the watermark rule
            for a in self.healthy_addrs():
                try:
                    h = self.pool.call(
                        a, "health", timeout=1.0,
                        deadline=Deadline.after(dl.clamp(1.0)),
                    )
                except PeerDownError:
                    continue
                except RpcError:
                    all_failfast = False
                    continue
                all_failfast = False
                self._note_health(a, h)
                if h.is_leader and found is None:
                    found = a
            if found is not None:
                self._leader = found
                self._leader_at = time.time()
                return found
            if all_failfast:
                return None  # every probe hit an open circuit: bail now
            attempt += 1
            if dl.remaining() <= 0:
                return None
            self.retry.sleep(attempt, dl)
            if dl.expired():
                return None

    def propose(self, data, timeout: float = 15.0):
        """Leader-routed proposal with retry across elections. Runs under
        the ambient deadline (commit entry point) and sends `idem=True`
        so a transport-level resend after a lost ack dedupes in the
        server's LRU. A retry of THIS loop (fresh logical call, e.g.
        after the server's apply-wait timed out post-append) may re-add
        the entry to the raft log — safe because delta/drop proposals
        apply idempotently (same-ts puts); Zero-side ops get their
        exactly-once verdicts from the state machine itself
        (ZeroStateMachine.txn_verdicts)."""
        dl = effective_deadline(timeout)
        last = "no leader found"
        attempt = 0
        while not dl.expired():
            addr = self.leader_addr(deadline=dl)
            if addr is None:
                if self.all_down():
                    raise GroupUnavailableError(
                        self.gid, f"no reachable replica for propose: {last}"
                    )
                attempt += 1
                self.retry.sleep(attempt, dl)
                continue
            # the server-side apply wait gets the remaining budget (the
            # wire deadline), not a fixed 5s
            wait_s = dl.clamp(8.0, floor=0.1)
            try:
                out = self.pool.call(
                    addr, "propose",
                    Proposal(
                        data=pack_body({"data": data, "timeout": wait_s})
                    ),
                    timeout=wait_s + 2.0,
                    idem=True,
                    deadline=dl,
                )
            except RpcError as e:
                last = str(e)
                attempt += 1
                self.retry.sleep(attempt, dl)
                continue
            if out.ok:
                try:
                    self.note_floor(int(out.index or 0))
                except (TypeError, ValueError):
                    pass
                return {"ok": True, "index": out.index}
            last = f"not leader / timeout from {addr}: {out}"
            self._leader = None  # force re-discovery next attempt
            attempt += 1
            self.retry.sleep(attempt, dl)
        raise TimeoutError(f"proposal to group {self.gid} failed: {last}")

    def read(self, method: str, args: dict, hedge_after: float = 0.15,
             deadline: Optional[Deadline] = None, timeout: float = 5.0,
             leader_only: bool = False,
             ctx: Optional[ReadContext] = None):
        """Hedged read (worker/task.go:60) with replica rotation: single
        attempts fail fast (refusals, open circuits), and this loop
        re-discovers the leader and retries with jittered backoff until
        the deadline — so one dead/rebooting replica costs milliseconds,
        not a stacked per-layer timeout. Each retry (like each hedge
        inside an attempt) spends one token from `ctx`'s per-query
        RetryBudget; a dry budget raises RetryBudgetExhausted
        (retryable) instead of amplifying a brownout.

        `leader_only=True` (the tablet-move copy stream) never touches
        a follower: a follower may lag the leader's applied index, and
        a missed committed version there would be LOST after the source
        drop — queries tolerate that staleness, a move must not. Leader
        failures still rotate via this loop's re-discovery."""
        dl = deadline or effective_deadline(timeout)
        attempt = 0
        last: Optional[Exception] = None
        while True:
            if self.all_down():
                METRICS.inc("group_unavailable_failfast_total")
                raise GroupUnavailableError(
                    self.gid, f"every replica circuit is open ({last})"
                )
            try:
                return self._read_once(
                    method, args, hedge_after, dl,
                    leader_only=leader_only, ctx=ctx,
                )
            except GroupUnavailableError:
                raise
            except RetryBudgetExhausted:
                raise
            except RpcError as e:
                last = e
                attempt += 1
                if dl.remaining() <= 0:
                    break
                if ctx is not None and not ctx.charge():
                    METRICS.inc("read_retry_budget_exhausted_total")
                    raise RetryBudgetExhausted(self.gid, str(e))
                self._leader = None  # re-discover before the next try
                self.retry.sleep(attempt, dl)
                if dl.expired():
                    break
        raise RpcError(
            f"read {method} on group {self.gid} failed after "
            f"{attempt} attempts: {last}"
        )

    def _refresh_health_async(self):
        """Keep the picker's applied-index cache fresh without blocking
        reads: when any replica's health row has aged past half the TTL,
        kick ONE background probe sweep (gated; runs on the dedicated
        sweep thread so it neither consumes a hedge slot nor queues
        behind slow hedged reads)."""
        ttl = float(config.get("FOLLOWER_READ_TTL_S"))
        if not self.picker.refresh_due(self.addrs, ttl):
            return
        if not self._refresh_gate.acquire(blocking=False):
            return

        def sweep():
            try:
                for a in self.addrs:
                    if not self.pool.healthy(a):
                        continue
                    try:
                        h = self.pool.call(a, "health", timeout=0.5)
                    except RpcError:
                        continue
                    self._note_health(a, h)
            finally:
                self._refresh_gate.release()

        _sweep_pool().submit(sweep)

    def _timed_call(self, addr, method, args, call_dl):
        """One replica call, its outcome + latency fed to the picker."""
        t0 = time.monotonic()
        try:
            out = self.pool.call(addr, method, args, deadline=call_dl)
        except Exception:
            self.picker.observe(addr, ok=False)
            raise
        self.picker.observe(addr, ok=True, lat_s=time.monotonic() - t0)
        return out

    def _served(self, addr, lead, ctx: Optional[ReadContext]):
        """Winner bookkeeping: a read answered by anyone other than the
        known leader is a (watermark-verified) follower read."""
        if lead is not None and tuple(addr) == tuple(lead):
            return
        METRICS.inc("follower_reads_total")
        if ctx is not None:
            ctx.note_follower_read()

    def _read_once(self, method: str, args: dict, hedge_after: float,
                   dl: Deadline, leader_only: bool = False,
                   ctx: Optional[ReadContext] = None):
        """One picker-ordered attempt: fire the best candidate; if it
        hasn't answered within `hedge_after`, race the next one; any
        failure immediately rotates to the NEXT candidate until the
        whole plan is exhausted (a 3-replica group never fails a read
        with a healthy replica untried). Losing futures are cancelled or
        reaped, never abandoned. With `leader_only` the follower
        fallback/hedge is disabled entirely (a no-leader window raises
        for the outer loop to retry)."""
        follower_ok = (not leader_only) and bool(
            config.get("FOLLOWER_READS")
        )
        # with follower serving available, leader discovery gets ONE fast
        # probe round (which also refreshes the picker's applied cache) —
        # an election window must not stall reads that a verified
        # follower could answer right now
        lead = self.leader_addr(
            deadline=Deadline.after(dl.clamp(0.35 if follower_ok else 2.0))
        )
        if leader_only:
            if lead is None:
                raise RpcError(
                    f"group {self.gid}: no leader for leader-only read"
                )
            addrs = [lead]
        else:
            if follower_ok:
                self._refresh_health_async()
                addrs = self.picker.plan(
                    self.addrs, lead, self.read_floor(),
                    healthy=self.pool.healthy,
                )
                if not addrs and lead is not None:
                    addrs = [lead]  # breaker never locks out the leader
            else:
                # legacy order: leader first, blind follower hedge
                addrs = self.healthy_addrs()
                if lead is not None:
                    addrs = [lead] + [a for a in addrs if a != lead]
            if not addrs:
                floor = self.read_floor()
                raise RpcError(
                    f"group {self.gid}: no leader and no watermark-"
                    f"verified follower (floor="
                    f"{'unknown' if floor is None else floor})"
                )
            if lead is None:
                METRICS.inc("leaderless_reads_total")
                if ctx is not None:
                    ctx.note_leaderless(self.gid)
        if dl.expired():
            raise GroupUnavailableError(self.gid, "deadline exhausted")
        # one attempt never gets the whole read budget — the outer retry
        # loop owns backoff between rotations
        call_dl = Deadline.after(dl.clamp(self.pool.timeout))
        if len(addrs) == 1:
            out = self._timed_call(addrs[0], method, args, call_dl)
            self._served(addrs[0], lead, ctx)
            return out
        return self._hedged_rotation(
            addrs, lead, method, args, hedge_after, call_dl, dl, ctx
        )

    def _sequential_rotation(self, addrs, lead, method, args, call_dl,
                             ctx: Optional[ReadContext]):
        """Hedge-pool-saturated fallback: walk the plan on the calling
        thread, no parallelism. Re-issues past the first still spend
        retry budget."""
        errs: List[Exception] = []
        for i, addr in enumerate(addrs):
            if call_dl.expired():
                break
            if i > 0 and ctx is not None and not ctx.charge():
                METRICS.inc("read_retry_budget_exhausted_total")
                raise RetryBudgetExhausted(self.gid, str(errs[-1]))
            try:
                out = self._timed_call(addr, method, args, call_dl)
            except Exception as e:
                errs.append(e)
                continue
            self._served(addr, lead, ctx)
            return out
        raise RpcError(
            f"read {method} on group {self.gid} failed on all "
            f"{len(addrs)} candidates: {errs or 'deadline exhausted'}"
        )

    def _hedged_rotation(self, addrs, lead, method, args, hedge_after,
                         call_dl, dl, ctx: Optional[ReadContext]):
        ex = _hedge_pool()
        pending: Dict[concurrent.futures.Future, Tuple[str, int]] = {}
        # futures launched BY THE HEDGE TIMER, as opposed to failure
        # rotations: only these count toward hedge_wins, so
        # hedge_wins <= hedge_fired_total holds and the metric measures
        # hedge effectiveness, not ordinary failover
        hedge_futs: set = set()
        errs: List[Exception] = []
        nxt = 0

        def launch(charge: bool, is_hedge: bool = False) -> str:
            """Submit the next candidate; returns ok | saturated |
            budget | exhausted."""
            nonlocal nxt
            if nxt >= len(addrs):
                return "exhausted"
            if charge and ctx is not None and not ctx.charge():
                return "budget"
            if not _HEDGE_SLOTS.acquire(blocking=False):
                METRICS.inc("hedge_skipped_saturated_total")
                return "saturated"
            addr = addrs[nxt]
            nxt += 1
            # hedge futures run under a COPY of this context so the rpc
            # layer sees the same trace parent + query profile the
            # calling thread holds (pool workers otherwise start orphan
            # traces)
            f = ex.submit(
                contextvars.copy_context().run,
                self._timed_call, addr, method, args, call_dl,
            )
            f.add_done_callback(lambda _f: _HEDGE_SLOTS.release())
            pending[f] = addr
            if is_hedge:
                hedge_futs.add(f)
            return "ok"

        if launch(False) != "ok":
            # saturated before the primary even launched: degrade to a
            # plain sequential walk on the calling thread
            return self._sequential_rotation(
                addrs, lead, method, args, call_dl, ctx
            )
        hedged = False
        while pending:
            if not hedged:
                wait_s = min(dl.clamp(hedge_after),
                             call_dl.clamp(self.pool.timeout))
            else:
                wait_s = call_dl.clamp(self.pool.timeout)
            done, _ = concurrent.futures.wait(
                pending, timeout=wait_s,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            if not done:
                if not hedged:
                    # hedge timer fired with the primary still in flight
                    hedged = True
                    if launch(True, is_hedge=True) == "ok":
                        METRICS.inc("hedge_fired_total")
                    continue
                if call_dl.expired() or dl.expired():
                    break  # deadline exhausted with calls in flight
                continue
            won = None
            for f in done:
                addr = pending.pop(f)
                try:
                    out = f.result()
                except Exception as e:
                    errs.append(e)
                    continue
                won = (f, addr, out)
                break
            if won is not None:
                wf, addr, out = won
                if wf in hedge_futs:
                    METRICS.inc("hedge_wins")
                for loser in pending:
                    if not loser.cancel():
                        loser.add_done_callback(_reap_loser)
                self._served(addr, lead, ctx)
                return out
            # everything that completed failed: rotate to the next
            # candidate (don't wait for the hedge timer)
            st = launch(True)
            if st == "budget" and not pending:
                METRICS.inc("read_retry_budget_exhausted_total")
                raise RetryBudgetExhausted(self.gid, str(errs[-1]))
            if st in ("exhausted", "saturated") and not pending:
                break
        for f in pending:
            if not f.cancel():
                f.add_done_callback(_reap_loser)
        raise RpcError(
            f"hedged read {method} on group {self.gid} failed: "
            f"{errs or 'deadline exhausted'}"
        )


class RemoteKV(KV):
    """Read-only KV routing each key to its tablet's owning group over RPC
    (the ServeTask seam made real across OS processes).

    With `partial_ok=True` (the query path) an unreachable group yields
    EMPTY results instead of an exception; the group id is recorded in
    `degraded_groups` so the entry point can mark the response
    degraded/partial — queries over healthy predicates keep answering
    while one group is partitioned. RetryBudgetExhausted is NEVER
    swallowed into a partial result: a dry budget means the cluster is
    browning out and the client must back off (retryable 503), not get
    silently empty data.

    Every group read shares the one per-query ReadContext (`ctx`): its
    RetryBudget bounds total re-issues across the whole fan-out, and
    its leaderless notes drive the `degraded: leaderless` extension."""

    def __init__(self, cluster, partial_ok: bool = False,
                 ctx: Optional[ReadContext] = None):
        self.cluster = cluster
        self.partial_ok = partial_ok
        self.ctx = ctx
        self.degraded_groups: set = set()

    def _group_for(self, attr: str) -> Optional[RemoteGroup]:
        gid = self.cluster.zero.belongs_to(attr)
        if gid is None:
            return None
        return self.cluster.remote_groups[gid]

    def _degrade(self, g: RemoteGroup):
        self.degraded_groups.add(g.gid)
        METRICS.inc("degraded_group_reads_total")

    def get(self, key, read_ts):
        g = self._group_for(keys.parse_key(key).attr)
        if g is None:
            return None
        try:
            got = g.read("kv.get", GetRequest(key=key, ts=read_ts),
                         ctx=self.ctx)
        except RetryBudgetExhausted:
            raise
        except RpcError:
            if not self.partial_ok:
                raise
            self._degrade(g)
            return None
        return None if not got.found else (got.ts, got.value)

    def versions(self, key, read_ts):
        g = self._group_for(keys.parse_key(key).attr)
        if g is None:
            return []
        try:
            got = g.read("kv.versions", GetRequest(key=key, ts=read_ts),
                         ctx=self.ctx)
        except RetryBudgetExhausted:
            raise
        except RpcError:
            if not self.partial_ok:
                raise
            self._degrade(g)
            return []
        return [(r.ts, r.value) for r in got.kv]

    def iterate(self, prefix, read_ts):
        attr = keys.attr_of(prefix)
        groups = (
            [self._group_for(attr)]
            if attr is not None
            else list(self.cluster.remote_groups.values())
        )
        for g in groups:
            if g is None:
                continue
            try:
                got = g.read(
                    "kv.iterate", IterateRequest(prefix=prefix, ts=read_ts),
                    ctx=self.ctx,
                )
            except RetryBudgetExhausted:
                raise
            except RpcError:
                if not self.partial_ok:
                    raise
                self._degrade(g)
                continue
            for r in got.kv:
                yield (r.key, r.ts, r.value)

    def iterate_versions(self, prefix, read_ts):
        for g in self.cluster.remote_groups.values():
            try:
                got = g.read(
                    "kv.iterate_versions",
                    IterateRequest(prefix=prefix, ts=read_ts),
                    ctx=self.ctx,
                )
            except RetryBudgetExhausted:
                raise
            except RpcError:
                if not self.partial_ok:
                    raise
                self._degrade(g)
                continue
            cur_key = None
            vers = []
            for r in got.kv:
                if r.key != cur_key:
                    if cur_key is not None:
                        yield (cur_key, vers)
                    cur_key, vers = r.key, []
                vers.append((r.ts, r.value))
            if cur_key is not None:
                yield (cur_key, vers)

    def put(self, key, ts, value):
        raise RuntimeError("RemoteKV is read-only; commit via cluster txns")
