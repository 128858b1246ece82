"""Raft consensus: leader election + log replication + commit + snapshots.

The reference embeds etcd/raft (SURVEY.md §2.7(4)) and drives it from
worker/draft.go / conn/node.go. Consensus is host-side work, so this is a
from-scratch Python Raft sized for the framework's needs: elections with
randomized timeouts, AppendEntries replication with consistency checks and
backtracking, commit-index advancement by majority match, log compaction
with snapshot installation for lagging peers (snap_req, ref
worker/snapshot.go InstallSnapshot + raftwal deleteUntil), and durable
hardstate/log/snapshot via raft/wal.py (ref raftwal/storage.go:60) —
persisted BEFORE vote/append responses leave the node.

Transport is pluggable: InProcNetwork for deterministic tests (the
dgraphtest analog) and a TCP transport (raft/tcp.py) for multi-process
clusters.

Time is injected (tick(now_ms)) so tests run deterministically with
virtual clocks — no sleeps, no flaky elections.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


@dataclass
class LogEntry:
    term: int
    data: Any


@dataclass
class Message:
    kind: str  # vote_req, vote_resp, append_req, append_resp, snap_req
    frm: int
    to: int
    term: int
    payload: dict = field(default_factory=dict)
    # W3C traceparent of the sender's ambient span, carried on the TCP
    # plane (conn/messages.RaftEnvelope.trace); "" for untraced traffic
    trace: str = ""


class InProcNetwork:
    """Deterministic in-process message bus with fault injection
    (the jepsen-nemesis analog for tests)."""

    def __init__(self):
        self.inboxes: Dict[int, List[Message]] = {}
        self.partitions: set = set()  # pairs (a, b) that cannot talk
        self.down: set = set()
        self.lock = threading.Lock()

    def register(self, node_id: int):
        self.inboxes[node_id] = []

    def send(self, msg: Message):
        with self.lock:
            if msg.to not in self.inboxes or msg.to in self.down or msg.frm in self.down:
                return
            if (msg.frm, msg.to) in self.partitions or (
                msg.to,
                msg.frm,
            ) in self.partitions:
                return
            self.inboxes[msg.to].append(msg)

    def drain(self, node_id: int) -> List[Message]:
        with self.lock:
            msgs = self.inboxes.get(node_id, [])
            self.inboxes[node_id] = []
            return msgs

    def partition(self, a: int, b: int):
        self.partitions.add((a, b))

    def heal(self):
        self.partitions.clear()
        self.down.clear()


class RaftNode:
    def __init__(
        self,
        node_id: int,
        peers: List[int],
        network,
        apply_cb: Callable[[int, Any], None],
        election_timeout: Tuple[int, int] = (150, 300),
        heartbeat: int = 50,
        seed: Optional[int] = None,
        wal=None,
        snapshot_cb: Optional[Callable[[], bytes]] = None,
        restore_cb: Optional[Callable[[bytes, int], None]] = None,
        compact_every: int = 0,
        learner: bool = False,
        learner_ids: Optional[set] = None,
    ):
        """wal: raft.wal.RaftWal for durability (None = volatile, test-only).
        snapshot_cb() -> bytes captures the applied state machine;
        restore_cb(data, index) replaces it (snapshot install).
        compact_every > 0: leader auto-snapshots/compacts once the entry
        window exceeds that many applied entries (draft.go
        calculateSnapshot analog).
        learner: non-voting member (etcd raft learners / the reference's
        --raft learner nodes): replicates and applies the log but never
        votes, campaigns, or counts toward commit quorum — cheap read
        replicas. learner_ids: the cluster-wide learner set (so voters
        exclude them from majority math)."""
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.net = network
        self.apply_cb = apply_cb
        self.learner = learner
        self.learner_ids = set(learner_ids or ())
        self.rng = random.Random(seed if seed is not None else node_id)
        self.wal = wal
        self.snapshot_cb = snapshot_cb
        self.restore_cb = restore_cb
        self.compact_every = compact_every

        # persistent state (ref raftwal/): hardstate + entries + snapshot
        self.term = 0
        self.voted_for: Optional[int] = None
        # log window: log[i] is global index snap_index + 1 + i
        self.log: List[LogEntry] = []
        self.snap_index = 0
        self.snap_term = 0
        self.snapshot_data: Optional[bytes] = None

        # volatile
        self.state = FOLLOWER
        self.commit_index = 0  # global index of last committed entry
        self.last_applied = 0
        self.leader_id: Optional[int] = None

        # leader state
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}

        self.heartbeat_ms = heartbeat
        self.election_lo, self.election_hi = election_timeout
        self._reset_election_deadline(0)
        self._last_heartbeat_sent = 0
        self.lock = threading.RLock()

        if wal is not None:
            self._recover_from_wal()

    # -- durability ----------------------------------------------------------

    def _recover_from_wal(self):
        hard = self.wal.load_hard()
        if hard is not None:
            self.term, self.voted_for, _, _ = hard
        si, st, entries = self.wal.replay_log()
        self.snap_index, self.snap_term = si, st
        self.log = [LogEntry(t, d) for t, d in entries]
        if si > 0:
            self.snapshot_data = self.wal.load_snapshot()
            if self.snapshot_data is not None and self.restore_cb is not None:
                self.restore_cb(self.snapshot_data, si)
            self.commit_index = si
            self.last_applied = si

    def _persist_hard(self):
        if self.wal is not None:
            self.wal.save_hard(
                self.term, self.voted_for, self.snap_index, self.snap_term
            )

    def _persist_append(self, entry: LogEntry):
        if self.wal is not None:
            self.wal.append_entry(entry.term, entry.data)

    def _persist_flush(self):
        if self.wal is not None:
            self.wal.flush()

    # -- index helpers (global <-> window) ------------------------------------

    def last_index(self) -> int:
        return self.snap_index + len(self.log)

    def term_at(self, idx: int) -> int:
        if idx == self.snap_index:
            return self.snap_term
        off = idx - self.snap_index - 1
        if 0 <= off < len(self.log):
            return self.log[off].term
        return 0

    def entry_at(self, idx: int) -> LogEntry:
        return self.log[idx - self.snap_index - 1]

    def last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.snap_term

    # -- helpers -------------------------------------------------------------

    def _reset_election_deadline(self, now: int):
        self.election_deadline = now + self.rng.randint(
            self.election_lo, self.election_hi
        )

    def _become_follower(self, term: int, now: int):
        self.state = FOLLOWER
        self.term = term
        self.voted_for = None
        self._persist_hard()
        self._reset_election_deadline(now)

    # -- public API -----------------------------------------------------------

    def propose(self, data: Any) -> bool:
        """Append to the leader's log; returns False if not leader
        (ref worker/proposal.go proposeAndWait — waiting is done by the
        caller observing apply)."""
        with self.lock:
            if self.state != LEADER:
                return False
            e = LogEntry(self.term, data)
            self.log.append(e)
            self._persist_append(e)
            self._persist_flush()
            # remember the proposer's ambient trace context (set when a
            # traced RPC handler proposes): the next append broadcast
            # carries it on the wire so the replication hop of a traced
            # proposal stays attributable (RaftEnvelope.trace ->
            # follower-side raft_recv spans)
            from dgraph_tpu_torch.utils.observe import TRACER

            tp = TRACER.current_traceparent()
            if tp:
                self._pending_trace = tp
            self.match_index[self.id] = self.last_index()
            if self._voting_size() == 1:
                # a single-voter group commits on its own match alone —
                # there are no append responses to drive _advance_commit
                # (multi-voter groups advance on responses; scanning the
                # uncommitted backlog per propose would be O(n^2) there)
                self._advance_commit()
            return True

    def is_leader(self) -> bool:
        return self.state == LEADER

    def tick(self, now: int):
        """Advance timers + process inbox. Call regularly (ref
        conn/node.go ticker + draft.go Run loop)."""
        with self.lock:
            for msg in self.net.drain(self.id):
                self._handle(msg, now)
            if self.state == LEADER:
                if now - self._last_heartbeat_sent >= self.heartbeat_ms:
                    self._broadcast_append(now)
            elif now >= self.election_deadline and not self.learner:
                self._start_election(now)
            self._apply_committed()
            if (
                self.compact_every
                and self.snapshot_cb is not None
                and self.last_applied - self.snap_index >= self.compact_every
            ):
                self.take_snapshot()

    def take_snapshot(self):
        """Snapshot the applied state machine and compact the log up to
        last_applied (ref worker/draft.go:1756 calculateSnapshot +
        raftwal deleteUntil)."""
        with self.lock:
            if self.snapshot_cb is None or self.last_applied <= self.snap_index:
                return
            data = self.snapshot_cb()
            idx = self.last_applied
            term = self.term_at(idx)
            drop = idx - self.snap_index
            self.log = self.log[drop:]
            self.snap_index, self.snap_term = idx, term
            self.snapshot_data = data
            if self.wal is not None:
                self.wal.save_snapshot(data)
                self.wal.rewrite_log(
                    idx, term, [(e.term, e.data) for e in self.log]
                )
                self._persist_hard()

    # -- election --------------------------------------------------------------

    def _start_election(self, now: int):
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self.leader_id = None
        self._votes = {self.id}
        self._persist_hard()
        self._reset_election_deadline(now)
        for p in self.peers:
            self.net.send(
                Message(
                    "vote_req",
                    self.id,
                    p,
                    self.term,
                    {
                        "last_log_index": self.last_index(),
                        "last_log_term": self.last_log_term(),
                    },
                )
            )
        if not self.peers:
            self._become_leader(now)

    def _become_leader(self, now: int):
        self.state = LEADER
        self.leader_id = self.id
        self.next_index = {p: self.last_index() + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.match_index[self.id] = self.last_index()
        # commit a no-op in the new term so prior-term entries commit
        # immediately (raft §8; etcd does the same on election)
        e = LogEntry(self.term, ("noop", None))
        self.log.append(e)
        self._persist_append(e)
        self._persist_flush()
        self.match_index[self.id] = self.last_index()
        self._broadcast_append(now)

    # -- replication -----------------------------------------------------------

    def _broadcast_append(self, now: int):
        self._last_heartbeat_sent = now
        for p in self.peers:
            self._send_append(p)
        self._pending_trace = ""  # carried on one broadcast round only

    def _send_append(self, p: int):
        ni = self.next_index.get(p, self.last_index() + 1)
        if ni <= self.snap_index:
            # the entries this follower needs were compacted away: install
            # the snapshot instead (worker/snapshot.go:177 streaming analog)
            if self.snapshot_data is not None:
                self.net.send(
                    Message(
                        "snap_req",
                        self.id,
                        p,
                        self.term,
                        {
                            "index": self.snap_index,
                            "snap_term": self.snap_term,
                            "data": self.snapshot_data,
                        },
                    )
                )
            return
        prev_idx = ni - 1
        prev_term = self.term_at(prev_idx)
        off = ni - self.snap_index - 1
        entries = [(e.term, e.data) for e in self.log[off:]]
        self.net.send(
            Message(
                "append_req",
                self.id,
                p,
                self.term,
                {
                    "prev_idx": prev_idx,
                    "prev_term": prev_term,
                    "entries": entries,
                    "leader_commit": self.commit_index,
                },
                trace=getattr(self, "_pending_trace", "") if entries
                else "",
            )
        )

    # -- message handling -------------------------------------------------------

    def _handle(self, m: Message, now: int):
        if m.term > self.term:
            self._become_follower(m.term, now)
        if m.kind == "vote_req":
            self._on_vote_req(m, now)
        elif m.kind == "vote_resp":
            self._on_vote_resp(m, now)
        elif m.kind == "append_req":
            self._on_append_req(m, now)
        elif m.kind == "append_resp":
            self._on_append_resp(m, now)
        elif m.kind == "snap_req":
            self._on_snap_req(m, now)

    def _on_vote_req(self, m: Message, now: int):
        grant = False
        if self.learner or m.frm in self.learner_ids:
            # learners neither vote nor get elected
            self.net.send(
                Message(
                    "vote_resp", self.id, m.frm, self.term, {"granted": False}
                )
            )
            return
        if m.term >= self.term and self.voted_for in (None, m.frm):
            # up-to-date check (§5.4.1)
            llt, lli = self.last_log_term(), self.last_index()
            if (m.payload["last_log_term"], m.payload["last_log_index"]) >= (
                llt,
                lli,
            ):
                grant = True
                self.voted_for = m.frm
                self._persist_hard()  # durable BEFORE the response leaves
                self._reset_election_deadline(now)
        self.net.send(
            Message("vote_resp", self.id, m.frm, self.term, {"granted": grant})
        )

    def _voting_size(self) -> int:
        voters = {self.id, *self.peers} - self.learner_ids
        return len(voters)

    def _on_vote_resp(self, m: Message, now: int):
        if self.state != CANDIDATE or m.term != self.term:
            return
        if m.payload["granted"]:
            self._votes.add(m.frm)
            if len(self._votes - self.learner_ids) * 2 > self._voting_size():
                self._become_leader(now)

    def _on_append_req(self, m: Message, now: int):
        ok = False
        if m.term >= self.term:
            if m.term == self.term and self.state == CANDIDATE:
                self._become_follower(m.term, now)
            self.state = FOLLOWER
            self.leader_id = m.frm
            self._reset_election_deadline(now)
            prev_idx = m.payload["prev_idx"]
            prev_term = m.payload["prev_term"]
            if prev_idx < self.snap_index:
                # everything at/below our snapshot is already committed;
                # only accept the suffix beyond it
                skip = self.snap_index - prev_idx
                if len(m.payload["entries"]) >= skip:
                    m.payload["entries"] = m.payload["entries"][skip:]
                    prev_idx = self.snap_index
                    prev_term = self.snap_term
                    m.payload["prev_idx"] = prev_idx
                    m.payload["prev_term"] = prev_term
                else:
                    prev_idx = -1  # stale heartbeat below snapshot: ignore
            if prev_idx >= 0 and (
                prev_idx == 0
                or (
                    prev_idx <= self.last_index()
                    and self.term_at(prev_idx) == prev_term
                )
            ):
                ok = True
                # append, truncating conflicts (§5.3)
                idx = prev_idx  # global index of the last matching entry
                dirty = False
                for term, data in m.payload["entries"]:
                    off = idx - self.snap_index
                    if off < len(self.log):
                        if self.log[off].term != term:
                            del self.log[off:]
                            if self.wal is not None:
                                self.wal.truncate_from(idx + 1)
                            e = LogEntry(term, data)
                            self.log.append(e)
                            self._persist_append(e)
                            dirty = True
                    else:
                        e = LogEntry(term, data)
                        self.log.append(e)
                        self._persist_append(e)
                        dirty = True
                    idx += 1
                if dirty:
                    self._persist_flush()  # durable BEFORE the ack
                lc = m.payload["leader_commit"]
                if lc > self.commit_index:
                    self.commit_index = min(lc, self.last_index())
        self.net.send(
            Message(
                "append_resp",
                self.id,
                m.frm,
                self.term,
                {"ok": ok, "match": self.last_index() if ok else 0,
                 "hint": self.last_index()},
            )
        )

    def _on_snap_req(self, m: Message, now: int):
        """Install a leader snapshot (lagging/fresh replica catch-up)."""
        if m.term < self.term:
            return
        self.state = FOLLOWER
        self.leader_id = m.frm
        self._reset_election_deadline(now)
        idx, sterm = m.payload["index"], m.payload["snap_term"]
        if idx <= self.snap_index:
            pass  # already have it
        else:
            data = m.payload["data"]
            if self.restore_cb is not None:
                self.restore_cb(data, idx)
            self.snapshot_data = data
            self.log = []
            self.snap_index, self.snap_term = idx, sterm
            self.commit_index = max(self.commit_index, idx)
            self.last_applied = max(self.last_applied, idx)
            if self.wal is not None:
                self.wal.save_snapshot(data)
                self.wal.rewrite_log(idx, sterm, [])
                self._persist_hard()
        self.net.send(
            Message(
                "append_resp",
                self.id,
                m.frm,
                self.term,
                {"ok": True, "match": self.snap_index, "hint": self.last_index()},
            )
        )

    def _on_append_resp(self, m: Message, now: int):
        if self.state != LEADER or m.term != self.term:
            return
        p = m.frm
        if m.payload["ok"]:
            self.match_index[p] = max(self.match_index.get(p, 0), m.payload["match"])
            self.next_index[p] = self.match_index[p] + 1
            self._advance_commit()
        else:
            # backtrack (fast, using follower's log-length hint)
            self.next_index[p] = max(
                1, min(self.next_index.get(p, 1) - 1, m.payload["hint"] + 1)
            )
            self._send_append(p)

    def _advance_commit(self):
        # majority over VOTING members only (learners replicate but never
        # count toward quorum)
        n = self._voting_size()
        for idx in range(self.last_index(), self.commit_index, -1):
            votes = sum(
                1
                for nid, mi in self.match_index.items()
                if mi >= idx and nid not in self.learner_ids
            )
            if votes * 2 > n and self.term_at(idx) == self.term:
                self.commit_index = idx
                break

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            data = self.entry_at(self.last_applied).data
            # the leader's term-start no-op is raft bookkeeping, not state
            if (
                isinstance(data, (tuple, list))
                and len(data) == 2
                and data[0] == "noop"
            ):
                continue
            self.apply_cb(self.last_applied, data)


class RaftCluster:
    """Test/embedding helper: a set of nodes + virtual time pump."""

    def __init__(self, n: int, apply_cbs=None, seed: int = 0, **node_kwargs):
        self.net = InProcNetwork()
        ids = list(range(1, n + 1))
        self.nodes: Dict[int, RaftNode] = {}
        self.applied: Dict[int, List[Any]] = {i: [] for i in ids}
        for i in ids:
            self.net.register(i)
            cb = (
                apply_cbs[i - 1]
                if apply_cbs
                else (lambda idx, d, _i=i: self.applied[_i].append(d))
            )
            self.nodes[i] = RaftNode(
                i, ids, self.net, cb, seed=seed * 100 + i, **node_kwargs
            )
        self.now = 0

    def pump(self, ms: int = 10, times: int = 1):
        for _ in range(times):
            self.now += ms
            for nd in self.nodes.values():
                if nd.id not in self.net.down:
                    nd.tick(self.now)

    def run_until(self, cond, max_ms: int = 20_000, step: int = 10) -> bool:
        waited = 0
        while waited < max_ms:
            if cond():
                return True
            self.pump(step)
            waited += step
        return cond()

    def leader(self) -> Optional[RaftNode]:
        up = [
            nd
            for nd in self.nodes.values()
            if nd.state == LEADER and nd.id not in self.net.down
        ]
        if not up:
            return None
        # highest term wins (stale leaders may linger in partitions)
        return max(up, key=lambda nd: nd.term)

    def elect(self) -> RaftNode:
        assert self.run_until(lambda: self.leader() is not None)
        return self.leader()
