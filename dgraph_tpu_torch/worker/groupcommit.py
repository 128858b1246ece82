"""Group-commit coalescer: the write-side twin of the PR 7 micro-batcher.

Mirrors the reference's TxnWriter batching model (posting/oracle.go +
worker/draft.go proposal batching): concurrent committers coalesce into
batches that share ONE oracle verdict exchange and ONE bounded raft
proposal per owning group, with proposals pipelined ahead of the
previous batch's apply barrier.

Shape: ONE leader-combining queue per engine. A committer enqueues its
txn and either becomes the batch leader (drains up to
DGRAPH_TPU_GROUP_COMMIT_MAX_TXNS waiters and runs the batch on its own
thread — an idle engine commits immediately with zero added latency,
exactly the PR 7 "natural batching" rule) or parks on the shared
condition until a leader finishes its batch. The engine supplies one
`propose_fn(members)`:

  - decides every member (fence bounce / oracle abort / commit_ts) —
    per-member outcomes, an aborted member never fails its batchmates;
  - writes or proposes the batch's deltas (bounded per proposal);
  - returns a `barrier_fn` that completes the apply barrier (wait for
    group applies, advance the snapshot watermark, `zero.applied`).

Pipelining: the leader releases leadership BEFORE running its barrier,
so the next batch's oracle exchange and proposals are in flight while
the previous batch's apply barrier is still outstanding. Barriers run
in strict ticket (FIFO) order — commit timestamps are assigned by the
single in-flight propose phase, so ticket order IS commit-ts order and
the engine's snapshot watermark only ever advances monotonically (the
PR 7 snapshot-grouping proof depends on that).

Lock discipline: nothing blocking runs under the coalescer's lock —
draining and ticketing are pure bookkeeping; propose_fn, the window
sleep, and barrier_fn all run outside it (cv waits use the lock's own
condition, which is the sanctioned wait shape).

`DGRAPH_TPU_GROUP_COMMIT=0` keeps the engines on their serial per-txn
paths; this module is never constructed then.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional

from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config


class Member:
    """One committer's seat in a batch: its txn plus the outcome slot
    the leader fills (commit_ts or a per-member error)."""

    __slots__ = ("txn", "commit_ts", "error", "done")

    def __init__(self, txn):
        self.txn = txn
        self.commit_ts: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.done = False


def assign_verdicts(members, verdicts):
    """Fold a commit_batch verdict list back onto its members: aborted
    members get their TxnConflictError, committed members get their
    commit_ts. Returns the committed members in verdict (= commit-ts)
    order. Shared by every engine's propose_fn so the abort contract
    cannot drift between them."""
    from dgraph_tpu_torch.zero.zero import TxnConflictError

    committed = []
    for m, v in zip(members, verdicts):
        if v[0] == "abort":
            m.error = TxnConflictError(
                f"conflict (committed at {v[1]} > start {m.txn.start_ts})"
            )
        else:
            m.commit_ts = int(v[1])
            committed.append(m)
    return committed


def columnar_writes(committed):
    """Batch-level columnar encode, shared by every engine's
    propose_fn: ONE native batch_apply call (posting/colwrite) turns
    every committed member's collected edge columns into ready-to-put
    (key, record, attr) triples, returned as {member: [...]} — members
    whose columns had to materialize keep their Python deltas and are
    simply absent. MUST run before the per-member encode_deltas loop:
    a materialized member's writes come out of txn.cache.deltas."""
    from dgraph_tpu_torch.posting import colwrite  # lazy: engines without
    # group commit never pay the columnar module (and its native load)

    return colwrite.batch_encode(committed)


def commit_phase_ns(oracle: int = 0, propose: int = 0, apply: int = 0):
    """Commit-phase wall-time split (ns): where a group-commit batch
    spent its time — the oracle verdict exchange, the encode+propose
    (or put_batch) phase, and the apply barrier. qps_loadgen stamps
    the deltas of these counters into every BENCH_QPS row so the
    residual write-path bound is visible in-capture."""
    if oracle:
        METRICS.inc("commit_oracle_ns_total", oracle)
    if propose:
        METRICS.inc("commit_propose_ns_total", propose)
    if apply:
        METRICS.inc("commit_apply_ns_total", apply)


def chunk_group_writes(plans, frame_budget: int):
    """Merge per-member per-group writes into bounded proposal chunks:
    yields (gid, writes, members) with the summed record bytes of each
    chunk held under `frame_budget` (so a wide batch can never trip the
    DGRAPH_TPU_MAX_FRAME_BYTES cap one giant proposal would). `plans`
    is [(member, {gid: [(key, ts, rec)]})] in commit-ts order; write
    order within a chunk preserves that order, and every chunk tracks
    the members whose writes it carries (a failed chunk fails exactly
    those members)."""
    out = []
    acc: dict = {}  # gid -> [writes, byte_estimate, member_set]
    for m, per_group in plans:
        for gid, writes in per_group.items():
            slot = acc.get(gid)
            if slot is None:
                slot = acc[gid] = [[], 0, set()]
            for w in writes:
                slot[0].append(w)
                slot[1] += len(w[0]) + len(w[2]) + 24
            slot[2].add(m)
            if slot[1] >= frame_budget:
                out.append((gid, slot[0], slot[2]))
                del acc[gid]
    for gid, slot in acc.items():
        if slot[0]:
            out.append((gid, slot[0], slot[2]))
    return out


_BYPASS_WIDTH = 1.05  # EWMA batch width below which cv handoffs lose
_EWMA_ALPHA = 0.2


class GroupCommit:
    def __init__(
        self,
        propose_fn: Callable[[List[Member]], Optional[Callable[[], None]]],
        serial_fn: Optional[Callable] = None,
    ):
        self._propose_fn = propose_fn
        # the engine's serial per-txn commit (its GROUP_COMMIT=0
        # semantics): the adaptive bypass target. None disables the
        # bypass for engines that haven't wired one.
        self._serial_fn = serial_fn
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._leader_busy = False
        self._next_ticket = 0  # propose-phase order == commit-ts order
        self._proposed = 0  # propose phases whose proposals are dispatched
        self._barrier_done = 0  # barriers completed (FIFO)
        self._width_ewma = 1.0  # realized batch width (coalesced only)
        self._bypassing = 0  # serial-path commits currently in flight

    def mark_proposed(self) -> None:
        """Called by a cluster engine's propose_fn WHILE STILL HOLDING
        the engine commit lock, after its last proposal is dispatched:
        publishes this batch into the drain() accounting before the
        lock releases. Without this there is a window — propose_fn's
        lock scope has exited but _lead's finally hasn't run — where
        the tablet mover could acquire the commit lock and see a stale
        _proposed, letting drain() return while this batch's proposals
        are still airborne (the lost-delta hazard drain exists for).
        Idempotent; _lead's finally is the backstop for engines
        without a mover."""
        with self._cv:
            if self._proposed < self._next_ticket:
                self._proposed = self._next_ticket
                self._cv.notify_all()

    # -- public commit entry --------------------------------------------------

    def commit(self, txn) -> int:
        """Commit through the coalescer: returns the member's commit_ts
        or raises its per-member error (conflict abort, fence bounce,
        proposal failure). Blocks until this txn's apply barrier has
        completed — same post-conditions as the serial path.

        Adaptive bypass (PR 16 capture: at realized batch width ~1.05
        the coalescer's cv handoffs measurably LOSE to serial
        commits): when the width EWMA says no batchmate ever waits and
        the coalescer is completely idle — no leader, empty queue, no
        pipelined barrier outstanding, no other bypass in flight — the
        commit runs the engine's serial path directly. Any form of
        concurrency fails the idle check, so the first simultaneous
        committer re-engages coalescing and the EWMA (fed only by
        coalesced batches) re-opens the bypass when traffic thins
        again. Idle-pipeline precondition keeps the ordering story
        trivial: no batch barrier is outstanding, so the serial path's
        watermark/applied advance cannot pass an unapplied batch."""
        if (
            self._serial_fn is not None
            and self._width_ewma <= _BYPASS_WIDTH
            and bool(config.get("GROUP_COMMIT_BYPASS"))
        ):
            took = False
            with self._cv:
                if (
                    not self._leader_busy
                    and not self._queue
                    and self._bypassing == 0
                    and self._next_ticket == self._barrier_done
                ):
                    self._bypassing = 1
                    took = True
            if took:
                try:
                    METRICS.inc("group_commit_bypass_total")
                    # a bypassed commit is still a txn admitted through
                    # the group-commit front — keep the txn accounting
                    # complete (batch count + width histogram stay
                    # coalesce-only by design)
                    METRICS.inc("group_commit_txns_total")
                    return self._serial_fn(txn)
                finally:
                    with self._cv:
                        self._bypassing = 0
                        self._cv.notify_all()
        m = Member(txn)
        with self._cv:
            self._queue.append(m)
        while True:
            batch: Optional[List[Member]] = None
            with self._cv:
                if m.done:
                    break
                if not self._leader_busy and self._queue:
                    self._leader_busy = True
                    batch = self._drain_locked()
                else:
                    # parked: a leader is running (our txn may be in its
                    # batch) — woken on leadership release or completion
                    self._cv.wait(timeout=0.5)
                    continue
            self._lead(batch)
        if m.error is not None:
            raise m.error
        assert m.commit_ts is not None
        return m.commit_ts

    def drain(self) -> None:
        """Wait until every batch whose propose phase has COMPLETED has
        also completed its apply barrier. The caller holds the engine's
        commit lock (which every propose phase acquires), so no new
        proposals can enter flight meanwhile — the tablet mover's
        Phase-2 fence uses this to guarantee the delta catch-up stream
        starts with zero commit proposals in the air (a pipelined
        proposal landing on the source after the catch-up passed it
        would be destroyed by the source drop)."""
        with self._cv:
            while self._barrier_done < self._proposed:
                self._cv.wait(timeout=0.5)

    # -- leader path ----------------------------------------------------------

    def _drain_locked(self) -> List[Member]:
        cap = max(1, int(config.get("GROUP_COMMIT_MAX_TXNS")))
        batch: List[Member] = []
        while self._queue and len(batch) < cap:
            batch.append(self._queue.popleft())
        return batch

    def _lead(self, batch: List[Member]) -> None:
        window_us = int(config.get("GROUP_COMMIT_WINDOW_US"))
        cap = max(1, int(config.get("GROUP_COMMIT_MAX_TXNS")))
        with self._lock:
            pipeline_busy = self._next_ticket != self._barrier_done
        if window_us > 0 and pipeline_busy and len(batch) < cap:
            # an earlier batch's barrier is still in flight: arrivals are
            # piling up anyway, so a bounded wait widens this batch at no
            # cost to an idle engine (which never takes this branch)
            time.sleep(window_us / 1e6)
            with self._cv:
                while self._queue and len(batch) < cap:
                    batch.append(self._queue.popleft())
        with self._cv:
            # a bypassed commit is effectively a width-1 batch already
            # holding the serial path: it must lease its ts AND publish
            # before this batch's propose phase leases a later ts, or
            # the CDC stream / watermark could observe commit
            # timestamps out of order
            while self._bypassing:
                self._cv.wait(timeout=0.5)
            ticket = self._next_ticket
            self._next_ticket += 1
            METRICS.set_gauge(
                "commit_pipeline_depth", self._next_ticket - self._barrier_done
            )
        barrier_fn: Optional[Callable[[], None]] = None
        try:
            barrier_fn = self._propose_fn(batch)
        except BaseException as e:  # engine-level failure: whole batch
            for m in batch:
                if m.error is None:
                    m.error = e
        finally:
            # release leadership BEFORE the barrier: the next batch's
            # oracle exchange + proposals overlap this batch's apply wait
            with self._cv:
                if self._proposed < ticket + 1:
                    self._proposed = ticket + 1
                self._leader_busy = False
                self._cv.notify_all()
        # width EWMA feeds the adaptive bypass: only coalesced batches
        # count (bypass commits are width-1 by construction and would
        # pin the estimate at 1 forever)
        self._width_ewma += _EWMA_ALPHA * (
            len(batch) - self._width_ewma
        )
        METRICS.inc("group_commit_total")
        METRICS.inc("group_commit_txns_total", len(batch))
        METRICS.observe(
            "group_commit_batch_size", float(len(batch)),
            buckets=[1, 2, 4, 8, 16, 32, 64, 128],
        )
        # in-order apply barrier: watermark advances in commit-ts order
        with self._cv:
            while self._barrier_done != ticket:
                self._cv.wait(timeout=0.5)
        try:
            if barrier_fn is not None:
                barrier_fn()
        except BaseException as e:
            for m in batch:
                if m.error is None and m.commit_ts is not None:
                    m.error = e
        finally:
            with self._cv:
                self._barrier_done = ticket + 1
                METRICS.set_gauge(
                    "commit_pipeline_depth",
                    self._next_ticket - self._barrier_done,
                )
                for m in batch:
                    m.done = True
                self._cv.notify_all()
