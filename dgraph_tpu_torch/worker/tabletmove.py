"""Crash-safe live tablet moves: one phased driver for both clusters.

Mirrors the reference's Zero tablet-assignment protocol
(worker/predicate_move.go:115 movePredicate — non-blocking stream then a
short blocking phase — and zero/tablet.go:53 rebalanceTablets). The old
movers (worker/harness.py + worker/groups.py) were stop-the-world and
crash-unsafe: the global commit lock was held for the whole copy, the
tablet shipped as ONE raft proposal (tripping the frame cap for any
large tablet), and a coordinator death between the destination delta
and the Zero flip — or between the flip and the source drop — left the
cluster with duplicated or unroutable data forever.

The phased protocol, shared by DistributedCluster (in-process) and
ProcCluster (multi-OS-process) so the two paths cannot drift:

  Phase 1 — background copy (NO lock): the tablet streams out of the
    source group at a pinned, complete read_ts in bounded-size
    ("delta", chunk) proposals (DGRAPH_TPU_MOVE_CHUNK_BYTES; every
    chunk fits the frame cap). Writes keep flowing to the source the
    whole time; commits on other predicates are never blocked.

  Phase 2 — bounded fence (commit lock + MOVE_FENCE_DEADLINE_S): the
    tablet enters a replicated `moving` state in Zero (commits that
    still reach a fenced tablet bounce with a RETRYABLE
    TabletFencedError — never wrong data; reads keep serving from the
    source), the delta since the pinned ts streams over (versions with
    ts > read_ts only), then ownership flips through Zero's raft
    atomically with the journal advancing to the `drop` phase.

  Deferred — the source drop runs after the fence lifted; the journal
    entry clears last.

Every transition is journaled durably BEFORE its effects: through the
replicated Zero state machine (zero/replicated.py `moves`) when Zero is
raft-backed, or through the `MoveJournal` append-only file otherwise.
Recovery (`TabletMover.recover`, driven by the clusters'
`recover_moves()` at startup and by the auto-rebalance loop) resolves
any journal state to exactly-once placement:

  copy / fence  -> roll BACK: drop the partial copy at the destination,
                   lift the fence, clear the journal (source untouched)
  drop          -> roll FORWARD: re-assert the flip, finish the source
                   drop, clear the journal (both idempotent)

Chaos coverage drives `conn/faults.syncpoint` crash rules at every
boundary (move.begin/copy/fence/delta/flip/drop) under the bank
workload — tests/test_tablet_move.py.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from dgraph_tpu_torch.conn import faults
from dgraph_tpu_torch.conn.retry import Deadline, deadline_scope, poll_policy
from dgraph_tpu_torch.utils.observe import METRICS, TRACER
from dgraph_tpu_torch.x import config, keys

PHASE_COPY = "copy"
PHASE_FENCE = "fence"
PHASE_DROP = "drop"


class TabletFencedError(RuntimeError):
    """The commit touched a predicate inside a move's Phase-2 fence (or
    a crashed move's fence awaiting recovery). Retryable by contract:
    the fence is bounded (MOVE_FENCE_DEADLINE_S) and recovery lifts a
    stale one, so clients back off and resend (conn/retry.retrying_call
    honors the `retryable` attribute; HTTP maps it to 503)."""

    code = "tablet_fenced"
    retryable = True


class MoveFenceTimeout(RuntimeError):
    """Phase 2 overran MOVE_FENCE_DEADLINE_S; the move rolls back so the
    fence cannot wedge writers indefinitely."""


class AppendLog:
    """Shared append-only pickle record log — ONE durable-log format
    for the commit IntentLog (worker/groups.py) and the MoveJournal
    below, so the two cannot drift. Records are `<BI>(kind, len)` +
    pickle payload. A torn tail (crash mid-append) is physically
    truncated to the last complete-record boundary at open, so
    post-crash appends never land after garbage bytes. `sync=True`
    fsyncs every append (journal transitions must be durable BEFORE
    their effects); the intent log keeps flush-only semantics (the
    process-crash durability model its tests pin)."""

    _HDR = struct.Struct("<BI")  # kind, payload len

    def __init__(self, path: str, kinds, sync: bool = False):
        self.path = path
        self._kinds = frozenset(kinds)
        self._sync = sync
        self._lock = threading.Lock()
        self._repair()
        self._f = open(path, "ab")

    def _repair(self):
        """Truncate a torn tail to the last complete-record boundary."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos, n = 0, len(data)
        while pos + self._HDR.size <= n:
            kind, plen = self._HDR.unpack_from(data, pos)
            end = pos + self._HDR.size + plen
            if kind not in self._kinds or end > n:
                break
            try:
                pickle.loads(data[pos + self._HDR.size : end])
            except Exception:
                break
            pos = end
        if pos < n:
            with open(self.path, "r+b") as f:
                f.truncate(pos)

    def _append(self, kind: int, obj):
        blob = pickle.dumps(obj)
        with self._lock:
            self._f.write(self._HDR.pack(kind, len(blob)))
            self._f.write(blob)
            self._f.flush()
            if self._sync:
                os.fsync(self._f.fileno())

    def _scan(self):
        """Yield (kind, payload) up to the first incomplete/corrupt
        record (a torn tail ends the replay, never crashes it)."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        pos, n = 0, len(data)
        while pos + self._HDR.size <= n:
            kind, plen = self._HDR.unpack_from(data, pos)
            end = pos + self._HDR.size + plen
            if kind not in self._kinds or end > n:
                return
            try:
                obj = pickle.loads(data[pos + self._HDR.size : end])
            except Exception:
                return
            pos = end
            yield kind, obj

    def close(self):
        with self._lock:
            self._f.close()


class MoveJournal(AppendLog):
    """Durable journal of in-flight tablet moves — the
    non-replicated-Zero durability backend (with a raft-backed Zero the
    journal lives in the replicated state machine instead). One SET
    record per phase transition, one CLEAR when the move completes or
    aborts; `pending()` folds the log into {pred: entry}."""

    _K_SET = 1
    _K_CLEAR = 2

    def __init__(self, path: str):
        super().__init__(
            path, kinds=(self._K_SET, self._K_CLEAR), sync=True
        )

    def record(self, pred: str, entry: dict):
        self._append(self._K_SET, (pred, dict(entry)))

    def clear(self, pred: str):
        self._append(self._K_CLEAR, pred)

    def pending(self) -> Dict[str, dict]:
        """{pred: latest entry} for moves with no CLEAR yet."""
        out: Dict[str, dict] = {}
        for kind, obj in self._scan():
            if kind == self._K_SET:
                pred, entry = obj
                out[pred] = entry
            else:
                out.pop(obj, None)
        return out


def reshard_intent(zero, per_group) -> Dict[int, list]:
    """Regroup a journaled commit intent's writes by the CURRENT tablet
    owner (shared by both clusters' recover_intents): a move completed
    between the intent and its replay invalidates the group ids
    recorded at commit time — replaying to the old owner would strand
    the writes on a dropped tablet."""
    regrouped: Dict[int, list] = {}
    for _gid, writes in per_group.items():
        for k, ts, v in writes:
            attr = keys.parse_key(bytes(k)).attr
            cur = int(zero.should_serve(attr))
            regrouped.setdefault(cur, []).append(
                (bytes(k), int(ts), bytes(v))
            )
    return regrouped


def check_fences(zero, delta_keys) -> None:
    """Bounce a commit that touches any fenced (moving) predicate with
    the retryable TabletFencedError — called by both engines' commit
    paths BEFORE the oracle decides, so no commit verdict is burned.
    The no-move common path costs one empty-set check."""
    if not zero._fenced:
        return
    touched = {keys.parse_key(k).attr for k in delta_keys}
    fenced = sorted(p for p in touched if zero.fenced(p))
    if fenced:
        METRICS.inc("tablet_fence_rejected_total")
        raise TabletFencedError(
            f"tablet(s) {fenced} are inside a move fence; "
            f"retry with backoff"
        )


# ---------------------------------------------------------------------------
# rebalance picking (pure; unit-tested over adversarial distributions)
# ---------------------------------------------------------------------------


def pick_rebalance_move(
    sizes: Dict[str, int],
    tablets: Dict[str, int],
    group_ids: Iterable[int],
    min_move_bytes: int,
) -> Optional[Tuple[str, int]]:
    """(pred, dst_group) for the single move that best narrows the
    load gap, or None (ref zero/tablet.go:53 rebalanceTablets).
    Fully deterministic: ties on group load break toward the smallest
    gid, ties on tablet weight break lexicographically — the old picker
    (`load[big][0]`) depended on dict insertion order and tablet count
    rather than bytes. Every tablet weighs its byte size PLUS ONE, so a
    byte-empty skew still spreads by tablet count while bytes dominate
    everywhere else."""
    load: Dict[int, int] = {g: 0 for g in group_ids}
    if not load:
        return None
    weight = {p: int(sizes.get(p, 0)) + 1 for p in tablets}
    for p, g in tablets.items():
        load[g] = load.get(g, 0) + weight[p]
    big = min(load, key=lambda g: (-load[g], g))
    small = min(load, key=lambda g: (load[g], g))
    gap = load[big] - load[small]
    if big == small or gap < max(1, int(min_move_bytes)):
        return None
    for p in sorted(
        (p for p, g in tablets.items() if g == big),
        key=lambda p: (-weight[p], p),
    ):
        w = weight[p]
        new_gap = abs((load[big] - w) - (load[small] + w))
        if new_gap < gap:
            return (p, small)
    return None


# how many stored bytes one byte of observed traffic is worth in the
# traffic-weighted score: served (decoded + result) bytes count 1:1
# against resident bytes, and one mutation edge is charged as a ~64-byte
# record write. Deliberately a constant, not a knob — the score must be
# reproducible from /debug/tablets alone.
_TRAFFIC_EDGE_BYTES = 64


def traffic_score(size_bytes: int, row: Optional[dict]) -> int:
    """Traffic-weighted load score of one tablet: its resident bytes
    plus the traffic it has served (decoded + result bytes read off it,
    mutation edges written into it). A hot small tablet can outweigh a
    cold giant one — exactly the case byte-only balancing gets wrong
    (a 1-byte tablet serving 1M reads is the group's real load)."""
    score = int(size_bytes)
    if row:
        score += int(row.get("decoded_bytes", 0))
        score += int(row.get("result_bytes", 0))
        score += int(row.get("mutation_edges", 0)) * _TRAFFIC_EDGE_BYTES
    return score


def pick_rebalance_move_by_traffic(
    sizes: Dict[str, int],
    traffic: Dict[str, dict],
    tablets: Dict[str, int],
    group_ids: Iterable[int],
    min_move_bytes: int,
) -> Optional[Tuple[str, int]]:
    """The traffic-weighted analog of pick_rebalance_move: same
    deterministic gap-narrowing picker (ties → smallest gid /
    lexicographic pred, +1-per-tablet floor), but every tablet weighs
    its traffic_score instead of raw bytes. `traffic` maps predicate →
    a /debug/tablets row (cluster-merged); missing rows score as cold.
    Behind DGRAPH_TPU_REBALANCE_BY_TRAFFIC — size-based stays the
    default."""
    scores = {
        p: traffic_score(sizes.get(p, 0), traffic.get(p))
        for p in tablets
    }
    return pick_rebalance_move(scores, tablets, group_ids, min_move_bytes)


_TRAFFIC_FIELDS = (
    "decoded_bytes", "result_bytes", "mutation_edges", "reads",
)


def cluster_traffic_by_pred(cluster) -> Dict[str, dict]:
    """Cluster-wide per-predicate traffic rows for the rebalancer:
    merged /debug/tablets when the cluster aggregates (ProcCluster),
    else the local accumulator. Namespaces collapse — a tablet moves
    as a whole across namespaces."""
    from dgraph_tpu_torch.utils import observe

    getter = getattr(cluster, "merged_tablets", None)
    rows = (
        getter()["tablets"]
        if getter is not None
        else observe.TABLETS.snapshot()
    )
    out: Dict[str, dict] = {}
    for r in rows:
        agg = out.setdefault(
            r["predicate"], {k: 0 for k in _TRAFFIC_FIELDS}
        )
        for k in agg:
            agg[k] += int(r.get(k, 0))
    return out


def _traffic_window(cluster) -> Dict[str, dict]:
    """Per-predicate traffic accrued SINCE the previous rebalance step
    on this cluster. The accumulator's totals are cumulative-for-life;
    scoring on them would chase stale hotspots (a tablet that served
    10GB in hour one and is now idle must not out-score the tablet
    serving real load NOW). Each call diffs against — and then
    advances — a per-cluster baseline, so an auto-rebalance loop's
    ticks see one window of recent traffic each. The first call (no
    baseline yet) sees the lifetime totals: the bootstrap window."""
    current = cluster_traffic_by_pred(cluster)
    baseline = getattr(cluster, "_tabletmove_traffic_base", None)
    cluster._tabletmove_traffic_base = {
        p: dict(v) for p, v in current.items()
    }
    if baseline is None:
        return current
    window: Dict[str, dict] = {}
    for p, cur in current.items():
        base = baseline.get(p, {})
        window[p] = {
            k: max(0, cur.get(k, 0) - base.get(k, 0))
            for k in _TRAFFIC_FIELDS
        }
    return window


def tablet_size(cluster, pred: str) -> int:
    """Record bytes of one tablet (data + split parts) on its owning
    group — the rebalancer's load signal (ref zero/tablet.go size
    stream, draft.go calculateTabletSizes). Sized server-side when the
    cluster offers `_move_prefix_size` (one small reply per prefix);
    the fallback streams and counts."""
    gid = cluster.zero.belongs_to(pred)
    if gid is None:
        return 0
    sizer = getattr(cluster, "_move_prefix_size", None)
    total = 0
    for prefix in (
        keys.PredicatePrefix(pred),
        keys.SplitPredicatePrefix(pred),
    ):
        if sizer is not None:
            total += int(sizer(gid, prefix))
            continue
        for _key, vers in cluster._move_iter(gid, prefix, 1 << 62, 0, 8 << 20):
            for _ts, rec in vers:
                total += len(rec)
    return total


def _move_state(cluster):
    """(lock, active_set) for this cluster's in-process move registry.
    recover_moves must never treat a live move's journal entry as a
    crashed one — a concurrent rollback would clear the journal under
    the mover, its flip would silently no-op, and the source drop would
    destroy the tablet. The lock makes registration atomic (two racing
    movers of one predicate cannot both start) and freezes the registry
    while recovery resolves dead-coordinator entries: a mover finishing
    mid-recovery blocks on deregistration, so its predicate stays
    visibly active until recovery's pass is over."""
    got = getattr(cluster, "_tabletmove_state", None)
    if got is None:
        got = cluster._tabletmove_state = (threading.Lock(), set())
    return got


def recover_all(cluster) -> int:
    """Resolve every journaled move whose coordinator is dead. Holds
    the registry lock for the whole pass: the journal snapshot is taken
    under it, in-flight movers cannot deregister (or start) mid-pass,
    so a live or just-completed move can never be mistaken for a
    crashed one and rolled back. Shared by both clusters'
    recover_moves()."""
    lock, active = _move_state(cluster)
    n = 0
    with lock:
        for pred, entry in sorted(cluster.zero.moves().items()):
            if pred in active:
                continue
            TabletMover(cluster).recover(pred, entry)
            n += 1
    return n


def run_rebalance(
    cluster, min_move_bytes: int = 1 << 10,
    by_traffic: Optional[bool] = None,
) -> Optional[str]:
    """One rebalance step: pick deterministically, move. Returns the
    moved predicate or None. Predicates already moving (in flight here
    or journaled) are not candidates. Scoring is size-based by default;
    DGRAPH_TPU_REBALANCE_BY_TRAFFIC (or an explicit by_traffic=True)
    weighs each tablet by its observed traffic on top of bytes
    (pick_rebalance_move_by_traffic)."""
    lock, active = _move_state(cluster)
    with lock:  # movers mutate the registry under this lock
        busy = set(active)
    busy |= set(cluster.zero.moves_hint())
    tablets = {
        p: g for p, g in cluster.zero.tablets.items() if p not in busy
    }
    sizes = {p: cluster.tablet_size_bytes(p) for p in tablets}
    if by_traffic is None:
        by_traffic = bool(config.get("REBALANCE_BY_TRAFFIC"))
    if by_traffic:
        pick = pick_rebalance_move_by_traffic(
            sizes, _traffic_window(cluster), tablets,
            cluster._move_group_ids(), min_move_bytes,
        )
    else:
        pick = pick_rebalance_move(
            sizes, tablets, cluster._move_group_ids(), min_move_bytes
        )
    if pick is None:
        return None
    pred, dst = pick
    cluster.move_tablet(pred, dst)
    return pred


def start_rebalance_loop(cluster, interval_s: Optional[float] = None):
    """Jittered auto-rebalance driver (ref zero/tablet.go's 8-minute
    Run loop): every ~interval (uniform(0, 2i) via poll_policy — fleet
    de-synchronization), heal any journaled half-move, then take one
    size-based rebalance step. Returns (stop_event, thread)."""
    stop = threading.Event()
    interval = float(
        interval_s
        if interval_s is not None
        else config.get("REBALANCE_INTERVAL_S")
    )
    poll = poll_policy(interval)

    def loop():
        while not stop.is_set():
            if stop.wait(poll.backoff(1)):
                break
            try:
                cluster.recover_moves()
                cluster.rebalance_by_size()
            except faults.InjectedCrash:
                return  # simulated coordinator death: the loop dies too
            except Exception:
                continue  # next tick retries (incl. healing a half-move)

    th = threading.Thread(target=loop, daemon=True, name="rebalance")
    th.start()
    return stop, th


# ---------------------------------------------------------------------------
# the phase driver
# ---------------------------------------------------------------------------


def _entry_bytes(key: bytes, val: bytes) -> int:
    return len(key) + len(val) + 16  # ts + framing overhead estimate


class TabletMover:
    """Shared phased mover. The cluster provides four primitives —
    everything else (phases, journal, chunking, fence, recovery,
    metrics/spans) lives here so the in-process and multi-process paths
    cannot drift:

      zero                 ZeroService (move journal + tablet map)
      mem                  MemoryLayer (prefix invalidation)
      _commit_lock         the engine's commit serialization lock
      _move_iter(gid, prefix, ts, since_ts, page_bytes)
                           yields (key, versions newest-first), keys
                           ascending, each response bounded
      _move_propose(gid, data)
                           raft proposal to one group (idempotent apply)
      _move_group_ids()    group ids (rebalance)
      _move_bump_snapshot() optional: advance the serving watermark
    """

    def __init__(self, cluster):
        self.c = cluster

    # -- the move -----------------------------------------------------------

    def move(self, pred: str, dst_group: int) -> bool:
        zero = self.c.zero
        lock, active = _move_state(self.c)
        with lock:  # atomic check-then-register: no racing double move
            if pred in active:
                raise RuntimeError(
                    f"a move of {pred!r} is already in flight"
                )
            active.add(pred)
        try:
            stale = zero.moves().get(pred)
            if stale is not None:
                # an earlier move of this tablet never finished: heal
                # first (we own the registration, so recover_moves
                # can't race us on this entry)
                self.recover(pred, stale)
            src = zero.belongs_to(pred)
            if src is None or src == int(dst_group) or int(
                dst_group
            ) not in self.c._move_group_ids():
                return False
            dst = int(dst_group)
            chunk = max(1, int(config.get("MOVE_CHUNK_BYTES")))
            return self._move_inner(pred, src, dst, chunk)
        finally:
            with lock:
                active.discard(pred)

    def _move_inner(self, pred: str, src: int, dst: int, chunk: int) -> bool:
        zero = self.c.zero
        with TRACER.span("tablet_move"):
            # a COMPLETE snapshot point: read_ts() waits out commits
            # leased below it, so phase 1 + the ts>read_ts delta cover
            # every committed version with no gap
            read_ts = zero.zero.read_ts()
            zero.move_begin(pred, src, dst, read_ts)
            try:
                faults.syncpoint("move.begin", pred)
                # phase 1: chunked background copy at the pinned ts —
                # NO lock held; writes keep flowing to the source
                with TRACER.span("move_copy"):
                    self._stream(pred, src, dst, read_ts, 0, chunk)
                faults.syncpoint("move.copy", pred)
                # phase 2: bounded fence
                with self.c._commit_lock:
                    # group commit pipelines proposals past its propose
                    # phase (which holds the commit lock we now own):
                    # wait out every proposal already in flight, or the
                    # delta catch-up below could pass a key an airborne
                    # commit then lands on — destroyed by the source
                    # drop
                    gc = getattr(self.c, "_group_commit", None)
                    if gc is not None:
                        gc.drain()
                    # and the apply-shard rings: a shard request runs
                    # inside the propose phase (commit lock held), but
                    # the explicit fence makes "no write-set is ring-
                    # resident when the delta catch-up starts" a
                    # checked invariant, not an inference
                    from dgraph_tpu_torch.worker import applyshard

                    applyshard.drain()
                    with METRICS.timer("tablet_move_fence_seconds"):
                        zero.move_fence(pred)
                        faults.syncpoint("move.fence", pred)
                        dl = Deadline.after(
                            float(config.get("MOVE_FENCE_DEADLINE_S"))
                        )
                        # the scope clamps every paged read/propose
                        # under the delta to the remaining fence budget
                        # — a flaky replica cannot stretch the fence
                        # past the deadline one 30s read at a time
                        with TRACER.span("move_delta"), deadline_scope(dl):
                            self._stream(
                                pred, src, dst, 1 << 62, read_ts, chunk,
                                deadline=dl,
                            )
                        faults.syncpoint("move.delta", pred)
                        # ownership flips atomically with the journal
                        # advancing to the drop phase; the fence lifts
                        zero.move_flip(pred)
                        faults.syncpoint("move.flip", pred)
                    self._after_flip(pred)
            except faults.InjectedCrash:
                raise  # simulated coordinator death: journal untouched
            except Exception:
                METRICS.inc("tablet_move_failed_total")
                try:
                    # rollback is only safe while the flip has NOT
                    # committed. A failure AFTER it (flip RPC timed out
                    # but committed; _after_flip persist error) leaves
                    # the journal in the drop phase with tablets[pred]
                    # already at dst — dropping dst then would wipe the
                    # new owner. On any uncertainty (journal
                    # unreadable), leave the journal for recovery.
                    cur = zero.moves().get(pred)
                    if cur is not None and cur.get("phase") != PHASE_DROP:
                        self._rollback(pred, dst)
                except Exception:
                    pass  # journal survives; recover_moves() finishes
                raise
        # deferred: the source drop runs after the fence lifted
        self._drop(src, pred)
        faults.syncpoint("move.drop", pred)
        zero.move_done(pred)
        METRICS.inc("tablet_move_total")
        return True

    # -- recovery -----------------------------------------------------------

    def recover(self, pred: str, entry: dict) -> str:
        """Resolve one journaled move to exactly-once placement.
        copy/fence roll back; drop rolls forward. Idempotent — safe to
        re-run if recovery itself dies midway."""
        zero = self.c.zero
        phase = entry.get("phase")
        src, dst = int(entry["src"]), int(entry["dst"])
        if phase == PHASE_DROP:
            # the flip committed before the crash: complete the move
            zero.move_flip(pred)  # idempotent re-assert (tablets[pred]=dst)
            self._after_flip(pred)
            self._drop(src, pred)
            zero.move_done(pred)
            METRICS.inc("tablet_move_recovered_total")
            return "completed"
        # copy or fence: the flip never happened — roll back (drop the
        # partial destination copy, lift the fence; source is intact)
        self._drop(dst, pred)
        zero.move_abort(pred)
        self._invalidate(pred)
        METRICS.inc("tablet_move_recovered_total")
        return "rolled_back"

    # -- internals ----------------------------------------------------------

    def _stream(
        self,
        pred: str,
        src: int,
        dst: int,
        ts: int,
        since_ts: int,
        chunk: int,
        deadline: Optional[Deadline] = None,
    ) -> int:
        """Stream the tablet's versions (ts in (since_ts, ts]) from src
        into dst as bounded ("delta", chunk) proposals. Versions apply
        oldest-first per key; re-proposing after a crash is idempotent
        (same-ts puts)."""
        page = min(chunk, 8 << 20)
        writes: List[Tuple[bytes, int, bytes]] = []
        size = total = 0

        def flush():
            nonlocal writes, size, total
            if not writes:
                return
            self.c._move_propose(dst, ("delta", writes))
            METRICS.inc("tablet_move_chunks_total")
            METRICS.inc("tablet_move_bytes_total", size)
            total += size
            writes, size = [], 0

        for prefix in (
            keys.PredicatePrefix(pred),
            keys.SplitPredicatePrefix(pred),
        ):
            for key, vers in self.c._move_iter(
                src, prefix, ts, since_ts, page
            ):
                if deadline is not None and deadline.expired():
                    raise MoveFenceTimeout(
                        f"move of {pred!r}: delta stream overran the "
                        f"fence deadline; rolling back"
                    )
                for t, val in reversed(vers):  # oldest first
                    writes.append((bytes(key), int(t), bytes(val)))
                    size += _entry_bytes(key, val)
                if size >= chunk:
                    flush()
                    faults.syncpoint("move.chunk", pred)
        flush()
        return total

    def _drop(self, gid: int, pred: str):
        self.c._move_propose(gid, ("drop", keys.PredicatePrefix(pred)))
        self.c._move_propose(gid, ("drop", keys.SplitPredicatePrefix(pred)))

    def _rollback(self, pred: str, dst: int):
        # order matters: clear the partial copy BEFORE clearing the
        # journal — if the drop fails (dst partitioned) the journal
        # survives and the next recover_moves() retries the cleanup
        self._drop(dst, pred)
        self.c.zero.move_abort(pred)
        self._invalidate(pred)

    def _invalidate(self, pred: str):
        # only the moved tablet's cache entries — an unrelated
        # predicate's decoded lists survive the move (the old movers
        # nuked the whole MemoryLayer)
        self.c.mem.invalidate_prefix(
            (keys.PredicatePrefix(pred), keys.SplitPredicatePrefix(pred))
        )

    def _after_flip(self, pred: str):
        self._invalidate(pred)
        bump = getattr(self.c, "_move_bump_snapshot", None)
        if bump is not None:
            bump()
        # the flipped tablet map must be durable BEFORE move_done
        # clears the journal: with a non-replicated Zero the map lives
        # in zero.json, which is otherwise only rewritten on the next
        # alter/close — a hard crash after the clear would reload a
        # stale map routing the tablet to the already-dropped source.
        # (Raft-backed Zeros persist the flip in the state machine;
        # recovery re-runs this hook on the roll-forward path.)
        persist = getattr(self.c, "_move_persist_zero", None)
        if persist is not None:
            persist()
