"""Raft-replicated Zero: the coordinator as a consensus state machine.

Mirrors dgraph/dgraph/cmd/zero (raft-backed Zero quorum:
zero/raft.go applies proposals to the shared state, oracle.go decides
commits, assign.go leases in blocks, zero.go:680 ShouldServe assigns
tablets): every coordinator decision — timestamp/uid leases, tablet
assignment, commit-or-abort — is a raft proposal applied deterministically
on every Zero replica, so the cluster survives Zero crashes and restarts
with no lost leases or split-brain commit decisions.

The state machine is deterministic: `commit` re-runs conflict detection
inside apply, so every replica reaches the same verdict. The client-side
wrapper (`ReplicatedZero`) keeps the ZeroLite interface (begin_txn /
read_ts / commit(track)/applied / assign_uids), leasing timestamps in
blocks (assign.go's lease batching) so the common path doesn't pay one
consensus round per timestamp.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from dgraph_tpu_torch.conn.retry import poll_policy
from dgraph_tpu_torch.raft.raft import RaftNode
from dgraph_tpu_torch.zero.zero import TxnConflictError


class ZeroStateMachine:
    """Deterministic coordinator state, mutated only by raft apply."""

    def __init__(self):
        self.max_ts = 0
        self.max_uid = 1
        self.commits: Dict[int, int] = {}  # conflict fp -> commit_ts
        self.aborted: Set[int] = set()
        self.tablets: Dict[str, int] = {}
        # in-flight tablet moves: pred -> {src, dst, phase, read_ts}.
        # The durable move journal (worker/tabletmove.py): every phase
        # transition is a raft op, so a coordinator death at any
        # boundary leaves a recoverable record in the quorum.
        self.moves: Dict[str, dict] = {}
        self.n_groups = 1
        # proposal results keyed by (proposer, req_id): the proposing
        # node's wrapper reads its own result after apply
        self.results: Dict[Tuple[int, int], object] = {}
        # start_ts -> final commit/abort verdict. A txn's verdict is
        # decided EXACTLY once: a commit op re-proposed through a
        # different server (e.g. the first server applied it but timed
        # out waiting, so the client retried elsewhere with a fresh
        # request id) returns the recorded verdict instead of re-running
        # conflict detection — which could flip commit into abort.
        self.txn_verdicts: Dict[int, tuple] = {}

    def apply(self, op: tuple):
        kind = op[0]
        if kind == "config":
            self.n_groups = int(op[1])
            return None
        _, proposer, req_id, *args = op
        key = (proposer, req_id)
        if key in self.results:
            # a client that re-proposed across a leader change: the first
            # committed copy decided; re-applying (e.g. a commit op) would
            # flip the verdict (dedup, ref zero proposal keys)
            return self.results[key]
        out = self._apply_inner(kind, args)
        self.results[(proposer, req_id)] = out
        # bound the results map: entries are read once by the proposer
        if len(self.results) > 10_000:
            self.results.clear()
        return out

    def _apply_inner(self, kind: str, args):
        if kind == "lease_ts":
            (count,) = args
            first = self.max_ts + 1
            self.max_ts += count
            return first
        if kind == "lease_uid":
            (count,) = args
            first = self.max_uid + 1
            self.max_uid += count
            return first
        if kind == "commit":
            start_ts, cks = args
            return self._commit_one(start_ts, cks)
        if kind == "commit_batch":
            # ONE consensus round deciding N txns, verdicts per member
            # (an aborted member never fails its batchmates). Members
            # decide in list order — the serial order back-to-back
            # "commit" ops would have produced — and each verdict is
            # recorded in txn_verdicts, so a member re-proposed solo
            # (or in a different batch) after a lost ack replays its
            # original verdict instead of re-running conflict checks.
            (batch,) = args
            items = batch["b"] if isinstance(batch, dict) else batch
            return [
                self._commit_one(int(start_ts), cks)
                for start_ts, cks in items
            ]
        if kind == "abort":
            (start_ts,) = args
            self.aborted.add(start_ts)
            self.txn_verdicts.setdefault(start_ts, ("abort", 0))
            return ("ok",)
        if kind == "tablet":
            (pred,) = args
            gid = self.tablets.get(pred)
            if gid is None:
                load = {g: 0 for g in range(1, self.n_groups + 1)}
                for g in self.tablets.values():
                    load[g] = load.get(g, 0) + 1
                gid = min(load, key=lambda g: (load[g], g))
                self.tablets[pred] = gid
            return gid
        if kind == "move_tablet":
            pred, gid = args
            self.tablets[pred] = int(gid)
            return ("ok",)
        if kind == "move_begin":
            pred, src, dst, read_ts = args
            self.moves[pred] = {
                "src": int(src), "dst": int(dst),
                "phase": "copy", "read_ts": int(read_ts),
            }
            return ("ok",)
        if kind == "move_fence":
            (pred,) = args
            m = self.moves.get(pred)
            if m is not None and m["phase"] == "copy":
                self.moves[pred] = dict(m, phase="fence")
            return ("ok",)
        if kind == "move_flip":
            # the atomic ownership change: tablets[pred]=dst and the
            # journal advancing to the drop phase land in ONE apply
            # (idempotent: recovery re-asserts it)
            (pred,) = args
            m = self.moves.get(pred)
            if m is not None:
                self.tablets[pred] = int(m["dst"])
                self.moves[pred] = dict(m, phase="drop")
            return ("ok",)
        if kind == "move_clear":
            (pred,) = args
            self.moves.pop(pred, None)
            return ("ok",)
        if kind == "moves":
            # linearizable journal read: riding the raft log means the
            # answer reflects every committed transition — recovery
            # decisions from a lagging follower's state could roll
            # back a move whose flip already committed
            return {p: dict(m) for p, m in self.moves.items()}
        if kind == "gc":
            (floor,) = args
            for ck in [c for c, ts in self.commits.items() if ts <= floor]:
                del self.commits[ck]
            self.aborted = {t for t in self.aborted if t >= floor}
            self.txn_verdicts = {
                t: v for t, v in self.txn_verdicts.items() if t >= floor
            }
            return ("ok",)
        raise ValueError(f"unknown zero op {kind!r}")

    def _commit_one(self, start_ts: int, cks) -> tuple:
        """Deterministic per-txn commit-or-abort (shared by the solo
        and batched ops)."""
        prior = self.txn_verdicts.get(start_ts)
        if prior is not None:
            return prior
        if start_ts in self.aborted:
            return ("abort", 0)
        for ck in cks:
            if self.commits.get(ck, 0) > start_ts:
                self.aborted.add(start_ts)
                return self._record_verdict(
                    start_ts, ("abort", self.commits[ck])
                )
        self.max_ts += 1
        for ck in cks:
            self.commits[ck] = self.max_ts
        return self._record_verdict(start_ts, ("commit", self.max_ts))

    def _record_verdict(self, start_ts: int, verdict: tuple) -> tuple:
        self.txn_verdicts[start_ts] = verdict
        if len(self.txn_verdicts) > 20_000:
            # deterministic bound (applied at the same op on every
            # replica): keep the newest half by start_ts
            cut = sorted(self.txn_verdicts)[len(self.txn_verdicts) // 2]
            self.txn_verdicts = {
                t: v for t, v in self.txn_verdicts.items() if t >= cut
            }
        return verdict

    # -- snapshot support ----------------------------------------------------

    def dump(self) -> bytes:
        import pickle

        return pickle.dumps(
            (
                self.max_ts,
                self.max_uid,
                self.commits,
                self.aborted,
                self.tablets,
                self.n_groups,
                self.txn_verdicts,
                self.moves,
            )
        )

    def load(self, blob: bytes):
        import pickle

        state = pickle.loads(blob)
        (
            self.max_ts,
            self.max_uid,
            self.commits,
            self.aborted,
            self.tablets,
            self.n_groups,
        ) = state[:6]
        # snapshots from before verdict dedup carry 6 fields; before
        # the move journal, 7
        self.txn_verdicts = state[6] if len(state) > 6 else {}
        self.moves = state[7] if len(state) > 7 else {}
        self.results = {}


class ZeroReplica:
    """One Zero raft member: state machine + raft node."""

    def __init__(self, node_id: int, peer_ids: List[int], net, wal=None,
                 compact_every: int = 0):
        self.id = node_id
        self.net = net
        self.sm = ZeroStateMachine()
        net.register(node_id)
        self.raft = RaftNode(
            node_id,
            peer_ids,
            net,
            lambda idx, data: self.sm.apply(tuple(data)),
            wal=wal,
            snapshot_cb=self.sm.dump,
            restore_cb=lambda blob, idx: self.sm.load(blob),
            compact_every=compact_every,
        )


class ReplicatedZero:
    """ZeroLite-compatible client over a quorum of ZeroReplica nodes.

    Timestamps lease in blocks (TS_BLOCK) from consensus and are handed
    out locally; every other decision (uids, commits, tablets) is one
    proposal. The read_ts visibility barrier (pending commits) is
    client-side volatile state, exactly like the oracle's MaxAssigned
    wait — it gates reads, not safety."""

    TS_BLOCK = 128

    def __init__(self, replicas: List[ZeroReplica], pump=None):
        self.replicas = replicas
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._req_id = 0
        self._ts_next = 0
        self._ts_end = -1  # exhausted
        # highest commit_ts this client observed: block remnants below it
        # are stale for snapshot purposes (a "fresh" ts must order after
        # every acknowledged commit, like Zero's Timestamps() contract)
        self._floor = 0
        self._active: Set[int] = set()
        self._pending: Set[int] = set()
        self._client_id = 10_000 + id(self) % 10_000

    # -- consensus plumbing --------------------------------------------------

    def _leader(self, timeout: float = 5.0) -> ZeroReplica:
        deadline = time.time() + timeout
        poll = poll_policy(0.002)
        while time.time() < deadline:
            down = getattr(self.replicas[0].net, "down", set())
            live = [
                r
                for r in self.replicas
                if r.raft.is_leader() and r.id not in down
            ]
            if live:
                # highest term wins: a partitioned stale leader lingers
                # until it hears the new term
                return max(live, key=lambda r: r.raft.term)
            poll.sleep(1)
        raise TimeoutError("no zero leader")

    def _propose(self, kind: str, *args, timeout: float = 10.0):
        """Propose and wait until OUR replica set applies it; read the
        deterministic result from the leader's state machine."""
        with self._lock:
            self._req_id += 1
            rid = self._req_id
        op = (kind, self._client_id, rid, *args)
        key = (self._client_id, rid)
        deadline = time.time() + timeout
        while time.time() < deadline:
            leader = self._leader(timeout=max(0.01, deadline - time.time()))
            if not leader.raft.propose(op):
                continue
            # bounded wait per attempt: if leadership flips mid-flight we
            # re-propose; the state machine dedups by (client, req_id)
            attempt_end = min(deadline, time.time() + 1.5)
            apply_poll = poll_policy(0.001)
            while time.time() < attempt_end:
                if key in leader.sm.results:
                    return leader.sm.results[key]
                # the op may have committed via a NEW leader
                for r in self.replicas:
                    if key in r.sm.results and r.raft.is_leader():
                        return r.sm.results[key]
                apply_poll.sleep(1)
        raise TimeoutError(f"zero proposal {kind} timed out")

    # -- ZeroLite interface --------------------------------------------------

    def next_ts(self, count: int = 1) -> int:
        with self._lock:
            if (
                count == 1
                and self._ts_next <= self._ts_end
                and self._ts_next > self._floor
            ):
                ts = self._ts_next
                self._ts_next += 1
                return ts
        if count == 1:
            first = self._propose("lease_ts", self.TS_BLOCK)
            with self._lock:
                self._ts_next = first + 1
                self._ts_end = first + self.TS_BLOCK - 1
                return first
        return self._propose("lease_ts", count)

    def begin_txn(self) -> int:
        # waits out in-flight commits below the start ts, like
        # read_ts(): a txn snapshot must be complete or SSI misses the
        # lost update (see zero/zero.py begin_txn)
        from dgraph_tpu_torch.zero.zero import wait_applied_below

        ts = self.next_ts()
        with self._cv:
            self._active.add(ts)
            wait_applied_below(self._cv, self._pending, ts)
        return ts

    def read_ts(self) -> int:
        from dgraph_tpu_torch.zero.zero import wait_applied_below

        ts = self.next_ts()
        with self._cv:
            wait_applied_below(self._cv, self._pending, ts)
        return ts

    def assign_uids(self, count: int) -> int:
        return self._propose("lease_uid", count)

    @property
    def max_assigned(self) -> int:
        try:
            return self._leader(timeout=1.0).sm.max_ts
        except TimeoutError:
            return max(r.sm.max_ts for r in self.replicas)

    @property
    def _max_uid(self) -> int:
        try:
            return self._leader(timeout=1.0).sm.max_uid
        except TimeoutError:
            return max(r.sm.max_uid for r in self.replicas)

    def commit(self, start_ts: int, conflict_keys, track: bool = False) -> int:
        verdict = self._propose("commit", start_ts, sorted(conflict_keys))
        with self._lock:
            self._active.discard(start_ts)
        if verdict[0] == "abort":
            with self._lock:
                self._floor = max(self._floor, verdict[1])
            raise TxnConflictError(
                f"conflict (committed at {verdict[1]} > start {start_ts})"
            )
        commit_ts = verdict[1]
        with self._lock:
            self._floor = max(self._floor, commit_ts)
            if track:
                self._pending.add(commit_ts)
        # opportunistic conflict-map GC below the oldest active txn
        with self._lock:
            floor = min(self._active) if self._active else None
        if floor is not None:
            try:
                self._propose("gc", floor, timeout=1.0)
            except TimeoutError:
                pass
        return commit_ts

    def commit_batch(self, items, track: bool = False):
        """ONE consensus round deciding N txns (group commit): returns
        a ("commit", ts) / ("abort", last_ts) verdict per member in
        order — an aborted member never fails its batchmates."""
        payload = [
            [int(s), sorted(int(c) for c in cks)] for s, cks in items
        ]
        verdicts = self._propose("commit_batch", {"b": payload})
        with self._lock:
            for (s, _), v in zip(items, verdicts):
                self._active.discard(int(s))
                if int(v[1]):
                    self._floor = max(self._floor, int(v[1]))
                if v[0] == "commit" and track:
                    self._pending.add(int(v[1]))
            floor = min(self._active) if self._active else None
        if floor is not None:
            try:
                self._propose("gc", floor, timeout=1.0)
            except TimeoutError:
                pass
        return [tuple(v) for v in verdicts]

    def applied(self, commit_ts: int):
        with self._cv:
            self._pending.discard(commit_ts)
            self._cv.notify_all()

    def abort(self, start_ts: int):
        with self._lock:
            self._active.discard(start_ts)
        try:
            self._propose("abort", start_ts, timeout=2.0)
        except TimeoutError:
            pass  # aborts are advisory bookkeeping

    # -- tablet ops (ZeroService face) ---------------------------------------

    def should_serve(self, pred: str) -> int:
        return int(self._propose("tablet", pred))

    def move_tablet(self, pred: str, gid: int):
        self._propose("move_tablet", pred, gid)

    # -- move journal (worker/tabletmove.py phase driver) --------------------

    def move_begin(self, pred: str, src: int, dst: int, read_ts: int):
        self._propose("move_begin", pred, int(src), int(dst), int(read_ts))

    def move_fence(self, pred: str):
        self._propose("move_fence", pred)

    def move_flip(self, pred: str):
        self._propose("move_flip", pred)

    def move_clear(self, pred: str):
        self._propose("move_clear", pred)

    @property
    def moves(self) -> Dict[str, dict]:
        # journal reads drive DESTRUCTIVE recovery decisions, so they
        # go through consensus like the writes — never a follower's
        # possibly-stale state machine
        return dict(self._propose("moves"))

    @property
    def tablets(self) -> Dict[str, int]:
        try:
            return dict(self._leader(timeout=1.0).sm.tablets)
        except TimeoutError:
            return dict(self.replicas[0].sm.tablets)
