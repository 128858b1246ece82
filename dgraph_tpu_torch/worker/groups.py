"""Multi-group distribution: predicate sharding + replicated groups.

Mirrors the reference's distribution design (SURVEY.md §2.3):
  - ZeroService — cluster coordinator: tablet (predicate) -> group
    assignment on first write (ref dgraph/cmd/zero/zero.go:680 ShouldServe),
    ts/uid leasing + txn oracle (zero/oracle.go), membership, tablet moves
    and size-based rebalancing (zero/tablet.go:53).
  - AlphaGroup — one Raft group of replica nodes; every mutation delta is
    a Raft proposal applied to each replica's KV (ref worker/draft.go
    applyMutations; idempotent re-apply via same-ts puts).
  - DistributedCluster — the client-facing engine: routes reads/writes by
    tablet, exposes the same alter/txn/query surface as the single-node
    Server.

The data plane here is in-process (each replica owns a MemKV); the
cross-host transport seam is the Raft network (raft/raft.py, pluggable) +
the RoutingKV read interface — the gRPC conn/ equivalent slots in behind
both without touching this layer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.conn.retry import poll_policy
from dgraph_tpu_torch.posting.lists import LocalCache, Txn
from dgraph_tpu_torch.raft.raft import InProcNetwork, RaftNode
from dgraph_tpu_torch.schema.schema import State, parse_schema
from dgraph_tpu_torch.storage.kv import KV, MemKV
from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.worker.tabletmove import AppendLog
from dgraph_tpu_torch.x import config, keys
from dgraph_tpu_torch.zero.zero import TxnConflictError, ZeroLite


class GroupLeaderlessError(RuntimeError):
    """In-proc read plane: a group has no live leader and no
    watermark-verified replica (stale, or the read floor is still
    unknown). Mirrors the remote plane's no-candidates RpcError —
    refusing beats silently serving a provably stale view."""

    def __init__(self, gid: int, detail: str = ""):
        super().__init__(
            f"group {gid}: no leader and no watermark-verified replica"
            f" ({detail})"
        )
        self.gid = gid


class ZeroService:
    """Coordinator: leases, oracle, tablet map, membership.

    With a replicated backend (zero/replicated.py ReplicatedZero) every
    lease/commit/tablet decision goes through the Zero raft quorum; the
    default standalone backend is ZeroLite."""

    def __init__(self, n_groups: int, zero=None):
        self.zero = zero if zero is not None else ZeroLite()
        self.n_groups = n_groups
        self._repl = zero if hasattr(zero, "should_serve") else None
        self._tablets: Dict[str, int] = {}  # predicate -> group id
        self._lock = threading.Lock()
        self.members: Dict[int, dict] = {}  # node_id -> info
        # tablet-move journal (worker/tabletmove.py): pred -> entry with
        # {src, dst, phase, read_ts}. Durable through the replicated
        # Zero state machine when raft-backed, else through the
        # optional MoveJournal file the cluster attaches.
        self._moves: Dict[str, dict] = {}
        self.journal = None  # Optional[tabletmove.MoveJournal]
        # coordinator-local fence mirror: commits check this set per
        # predicate on the hot path instead of an RPC to Zero (the
        # mover and recovery — both on this coordinator — keep it in
        # sync with the journal)
        self._fenced: set = set()

    @property
    def tablets(self) -> Dict[str, int]:
        if self._repl is not None:
            return self._repl.tablets
        return self._tablets

    # tablet assignment (ref zero.go:680 ShouldServe)
    def should_serve(self, pred: str) -> int:
        if self._repl is not None:
            return self._repl.should_serve(pred)
        with self._lock:
            gid = self._tablets.get(pred)
            if gid is None:
                # least-loaded group gets the new tablet
                load = {g: 0 for g in range(1, self.n_groups + 1)}
                for g in self.tablets.values():
                    load[g] = load.get(g, 0) + 1
                gid = min(load, key=lambda g: (load[g], g))
                self._tablets[pred] = gid
            return gid

    def belongs_to(self, pred: str) -> Optional[int]:
        return self.tablets.get(pred)

    def move_tablet(self, pred: str, dst_group: int):
        if self._repl is not None:
            self._repl.move_tablet(pred, dst_group)
            return
        with self._lock:
            self._tablets[pred] = dst_group

    # -- tablet-move journal (ref predicate_move.go phases) -----------------
    #
    # Each transition is durable BEFORE its in-memory effect: proposed
    # through the replicated Zero state machine, or appended to the
    # MoveJournal file. `move_flip` is the atomic ownership change —
    # tablets[pred]=dst and journal phase->"drop" land in one step.

    def moves(self) -> Dict[str, dict]:
        """LINEARIZABLE journal read — drives destructive recovery
        decisions, so with a raft-backed Zero it rides the raft log.
        Advisory checks (drop_attr guard, state(), rebalance busy set)
        use the free local `moves_hint()` instead."""
        if self._repl is not None:
            return {p: dict(m) for p, m in self._repl.moves.items()}
        with self._lock:
            return {p: dict(m) for p, m in self._moves.items()}

    def moves_hint(self) -> Dict[str, dict]:
        """Coordinator-local journal mirror (no consensus round): kept
        in sync by the move_* calls, which all flow through this
        coordinator; seeded from the linearizable read at startup
        (refresh_fences). May lag only across coordinator restarts —
        fine for advisory checks, never for recovery."""
        with self._lock:
            return {p: dict(m) for p, m in self._moves.items()}

    def fenced(self, pred: str) -> bool:
        return pred in self._fenced

    def move_begin(self, pred: str, src: int, dst: int, read_ts: int):
        entry = {
            "src": int(src), "dst": int(dst),
            "phase": "copy", "read_ts": int(read_ts),
        }
        if self._repl is not None:
            self._repl.move_begin(pred, int(src), int(dst), int(read_ts))
        else:
            if self.journal is not None:
                self.journal.record(pred, entry)
        with self._lock:
            self._moves[pred] = entry

    def move_fence(self, pred: str):
        with self._lock:
            m = self._moves.get(pred)
            if m is None:
                raise RuntimeError(f"no move journaled for {pred!r}")
            m = dict(m, phase="fence")
        if self._repl is not None:
            self._repl.move_fence(pred)
        else:
            if self.journal is not None:
                self.journal.record(pred, m)
        with self._lock:
            self._moves[pred] = m
        self._fenced.add(pred)

    def move_flip(self, pred: str):
        with self._lock:
            m = self._moves.get(pred)
            if m is None:
                raise RuntimeError(f"no move journaled for {pred!r}")
            m = dict(m, phase="drop")
        if self._repl is not None:
            self._repl.move_flip(pred)
        else:
            if self.journal is not None:
                self.journal.record(pred, m)
        with self._lock:
            self._moves[pred] = m
            if self._repl is None:
                self._tablets[pred] = m["dst"]
        self._fenced.discard(pred)

    def move_done(self, pred: str):
        self._move_clear(pred)

    def move_abort(self, pred: str):
        self._move_clear(pred)

    def _move_clear(self, pred: str):
        if self._repl is not None:
            self._repl.move_clear(pred)
        else:
            if self.journal is not None:
                self.journal.clear(pred)
        with self._lock:
            self._moves.pop(pred, None)
        self._fenced.discard(pred)

    def refresh_fences(self):
        """Seed the local fence + journal mirrors from the durable
        journal (recovery: a fresh coordinator must bounce commits to
        a predicate a dead coordinator left fenced)."""
        moves = self.moves()
        with self._lock:
            self._moves = {p: dict(m) for p, m in moves.items()}
        self._fenced = {
            p for p, m in moves.items() if m.get("phase") == "fence"
        }

    def connect(self, node_id: int, group: int):
        self.members[node_id] = {"group": group, "last_seen": time.time()}

    def heartbeat(self, node_id: int):
        m = self.members.get(node_id)
        if m is not None:
            m["last_seen"] = time.time()

    def prune_dead(self, max_age_s: float = 10.0) -> List[int]:
        """Drop members that stopped heartbeating (ref conn/pool.go:233
        MonitorHealth + zero membership pruning). Returns pruned ids."""
        now = time.time()
        dead = [
            nid
            for nid, m in self.members.items()
            if now - m["last_seen"] > max_age_s
        ]
        for nid in dead:
            del self.members[nid]
        return dead

    def state(self) -> dict:
        return {
            "tablets": dict(self.tablets),
            "members": dict(self.members),
            "maxTxnTs": self.zero.max_assigned,
            "moves": self.moves_hint(),
        }


class AlphaNode:
    """One replica: a Raft member applying deltas to its own KV.

    With `data_dir` the replica is durable: KV writes go through a WAL and
    raft hardstate/log/snapshots persist via raft/wal.py (ref raftwal/,
    worker/server_state.go's per-alpha badger dirs). Restart replays both;
    re-applied deltas are idempotent (same-ts puts)."""

    def __init__(
        self,
        node_id: int,
        group_id: int,
        peer_ids: List[int],
        net,
        data_dir: Optional[str] = None,
        compact_every: int = 0,
        learner: bool = False,
        learner_ids: Optional[set] = None,
        wal_sync: bool = False,
    ):
        self.id = node_id
        self.group_id = group_id
        self.learner = learner
        raft_wal = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self.kv: KV = MemKV(
                wal_path=os.path.join(data_dir, f"kv_{node_id}.wal")
            )
            from dgraph_tpu_torch.raft.wal import RaftWal

            raft_wal = RaftWal(
                os.path.join(data_dir, f"raft_{node_id}"), sync=wal_sync
            )
        else:
            self.kv = MemKV()
        self.applied_index = 0
        net.register(node_id)
        self.raft = RaftNode(
            node_id,
            peer_ids,
            net,
            self._apply,
            wal=raft_wal,
            snapshot_cb=self._snapshot,
            restore_cb=self._restore,
            compact_every=compact_every,
            learner=learner,
            learner_ids=learner_ids,
        )
        self.applied_index = self.raft.last_applied

    def _snapshot(self) -> bytes:
        return self.kv.dump_bytes()

    def _restore(self, data: bytes, idx: int):
        self.kv.load_bytes(data)
        self.applied_index = idx

    def _apply(self, idx: int, data):
        kind, payload = data
        if kind == "delta":
            # payload: [(key, ts, record_bytes)]
            self.kv.put_batch(payload)
        elif kind == "drop":
            self.kv.drop_prefix(payload)
        # "noop": leader's term-start entry — nothing to apply
        self.applied_index = idx


class AlphaGroup:
    def __init__(
        self,
        group_id: int,
        node_ids: List[int],
        net,
        data_dir: Optional[str] = None,
        compact_every: int = 0,
        learner_ids: Optional[set] = None,
        wal_sync: bool = False,
    ):
        self.id = group_id
        self.net = net
        learner_ids = set(learner_ids or ())
        self.nodes = [
            AlphaNode(
                nid, group_id, node_ids, net,
                data_dir=data_dir, compact_every=compact_every,
                learner=nid in learner_ids, learner_ids=learner_ids,
                wal_sync=wal_sync,
            )
            for nid in node_ids
        ]

        # read floor (same rule as RemoteGroup): the max raft index any
        # completed proposal waited out, recorded before the snapshot
        # watermark advances — a replica with applied_index >= floor
        # provably serves the same bytes at the watermark. UNKNOWN
        # until the first proposal or leader-served read establishes it
        # (floor_known): with nodes restoring applied state from WAL, a
        # zero floor would "cover" pre-restart writes it knows nothing
        # about.
        self.read_floor = 0
        self.floor_known = False

    def leader(self) -> Optional[AlphaNode]:
        # a downed node may still believe it is leader — skip it, and
        # prefer the highest term among live claimants (stale leaders
        # linger until they hear the new term)
        live = [
            n
            for n in self.nodes
            if n.raft.is_leader() and n.id not in self.net.down
        ]
        if not live:
            return None
        return max(live, key=lambda n: n.raft.term)

    def note_floor(self, idx: int):
        self.floor_known = True
        if idx > self.read_floor:
            self.read_floor = idx

    def any_replica(self) -> AlphaNode:
        live = [n for n in self.nodes if n.id not in self.net.down]
        return self.leader() or (live[0] if live else self.nodes[0])

    def read_replica(self) -> AlphaNode:
        """Watermark-verified read pick: the leader when one is live
        (its applied index also establishes/refreshes the floor, same
        as the remote plane's leader health replies, so a later
        leaderless window can verify followers); otherwise the
        most-applied live replica IF follower reads are enabled, the
        floor is KNOWN, and that replica's applied index covers it —
        byte-identical at the watermark by the PR 11 rule, counted
        follower_reads_total + leaderless_reads_total. Anything else
        raises GroupLeaderlessError: stale-or-unknown never serves,
        mirroring the remote plane, and FOLLOWER_READS=0 restores
        strict leader-only routing here too."""
        lead = self.leader()
        if lead is not None:
            self.note_floor(lead.applied_index)
            return lead
        live = [n for n in self.nodes if n.id not in self.net.down]
        if live and bool(config.get("FOLLOWER_READS")):
            if not self.floor_known:
                METRICS.inc("follower_read_floor_unknown_skips_total")
            else:
                best = max(live, key=lambda n: n.applied_index)
                if best.applied_index >= self.read_floor:
                    METRICS.inc("follower_reads_total")
                    METRICS.inc("leaderless_reads_total")
                    return best
                METRICS.inc("follower_read_stale_skips_total")
        raise GroupLeaderlessError(
            self.id,
            f"floor={self.read_floor if self.floor_known else 'unknown'}",
        )


class RoutingKV(KV):
    """Read-only KV view routing each key to its tablet's group (the
    in-process stand-in for the ServeTask read RPC, worker/task.go:123)."""

    def __init__(self, cluster: "DistributedCluster"):
        self.cluster = cluster

    def _kv_for(self, key: bytes) -> Optional[KV]:
        pk = keys.parse_key(key)
        gid = self.cluster.zero.belongs_to(pk.attr)
        if gid is None:
            return None
        return self.cluster.groups[gid].read_replica().kv

    def get(self, key, read_ts):
        kv = self._kv_for(key)
        return kv.get(key, read_ts) if kv else None

    def versions(self, key, read_ts):
        kv = self._kv_for(key)
        return kv.versions(key, read_ts) if kv else []

    def iterate(self, prefix, read_ts):
        attr = keys.attr_of(prefix)
        if attr is not None:
            gid = self.cluster.zero.belongs_to(attr)
            if gid is None:
                return iter(())
            return self.cluster.groups[gid].read_replica().kv.iterate(
                prefix, read_ts
            )

        def _all():
            for g in self.cluster.groups.values():
                yield from g.read_replica().kv.iterate(prefix, read_ts)

        return _all()

    def iterate_versions(self, prefix, read_ts):
        def _all():
            for g in self.cluster.groups.values():
                yield from g.read_replica().kv.iterate_versions(prefix, read_ts)

        return _all()

    def put(self, key, ts, value):  # writes go through raft proposals
        raise RuntimeError("RoutingKV is read-only; commit via cluster txns")


class IntentLog(AppendLog):
    """Durable commit-intent journal (ref zero/oracle.go:185 delta stream
    as the recovery model): an intent is appended BEFORE deltas are
    proposed to the owning groups and marked done after every group
    applied them. Restart replays unfinished intents, so a crash between
    groups can no longer tear a commit. Shares the AppendLog record
    format with the tablet MoveJournal (torn tails truncate to the last
    complete record at open; flush-only — process-crash durability)."""

    _K_INTENT = 1
    _K_DONE = 2

    def __init__(self, path: str):
        super().__init__(path, kinds=(self._K_INTENT, self._K_DONE))

    def append_intent(self, commit_ts: int, per_group: Dict[int, list]):
        self._append(self._K_INTENT, (commit_ts, per_group))

    def mark_done(self, commit_ts: int):
        self._append(self._K_DONE, commit_ts)

    def pending(self) -> Dict[int, Dict[int, list]]:
        """commit_ts -> per_group writes for unfinished intents."""
        out: Dict[int, Dict[int, list]] = {}
        for kind, obj in self._scan():
            if kind == self._K_INTENT:
                cts, pg = obj
                out[cts] = pg
            else:
                out.pop(obj, None)
        return out


class PartialCommitError(RuntimeError):
    """A commit reached some groups but not all before a timeout. The
    intent is durable; recover_intents() (or restart) completes it."""


class DistributedCluster:
    """N predicate-sharded groups x R replicas, Zero coordination.

    Client surface mirrors the single-node Server: alter / new_txn /
    query (DQL text) — but every commit fans deltas out to the owning
    groups' Raft logs (ref worker/mutation.go:711 MutateOverNetwork ->
    populateMutationMap -> proposeOrSend).

    With `data_dir`, every replica persists KV + raft state, Zero state
    (tablets/leases/schema) lands in zero.json, and commits journal
    through an IntentLog — a full-cluster restart recovers all committed
    data and completes interrupted commits.
    """

    def __init__(
        self,
        device="cuda",
        n_groups: int = 2,
        replicas: int = 3,
        pump_ms: int = 5,
        data_dir: Optional[str] = None,
        compact_every: int = 0,
        replicated_zero: bool = False,
        zero_replicas: int = 3,
        learners_per_group: int = 0,
    ):
        # the coordinator's set ops and vector indexes run on `device`
        # (`cuda` by default, `cpu` where the caller asks for the host);
        # CUDA must be present when asked, checked before any group exists
        from dgraph_tpu_torch.device import resolve_device
        from dgraph_tpu_torch.query import dispatch

        dispatch.DISPATCHER.bind(resolve_device(device))
        self.device = dispatch.DISPATCHER.device
        self.net = InProcNetwork()
        self.zero_nodes = []
        zero_impl = None
        if replicated_zero:
            from dgraph_tpu_torch.raft.wal import RaftWal
            from dgraph_tpu_torch.zero.replicated import ReplicatedZero, ZeroReplica

            zids = list(range(901, 901 + zero_replicas))
            for zid in zids:
                zwal = None
                if data_dir is not None:
                    os.makedirs(data_dir, exist_ok=True)
                    zwal = RaftWal(os.path.join(data_dir, f"zero_{zid}"))
                self.zero_nodes.append(
                    ZeroReplica(
                        zid, zids, self.net, wal=zwal,
                        compact_every=compact_every,
                    )
                )
            zero_impl = ReplicatedZero(self.zero_nodes)
        self.zero = ZeroService(n_groups, zero=zero_impl)
        self.data_dir = data_dir
        self.groups: Dict[int, AlphaGroup] = {}
        nid = 0
        for g in range(1, n_groups + 1):
            total = replicas + learners_per_group
            ids = list(range(nid + 1, nid + total + 1))
            # learners are the tail ids of each group (non-voting readers,
            # ref etcd raft learners / --raft learner)
            lids = set(ids[replicas:])
            nid += total
            gdir = os.path.join(data_dir, f"group_{g}") if data_dir else None
            self.groups[g] = AlphaGroup(
                g, ids, self.net, data_dir=gdir,
                compact_every=compact_every, learner_ids=lids,
            )
            for node in self.groups[g].nodes:
                self.zero.connect(node.id, g)
        from dgraph_tpu_torch.posting.memlayer import MemoryLayer

        self.schema = State()
        self.vector_indexes: Dict[str, object] = {}
        self.mem = MemoryLayer()  # shared decoded-list cache (ref MemoryLayer)
        # serializes commits against tablet moves (write fencing: a commit
        # racing phase-2 of a move would land on the source group and be
        # destroyed by the drop; ref predicate_move.go's blocking phase)
        self._commit_lock = threading.Lock()
        self._group_commit = None  # lazy (worker/groupcommit.py)
        self._bootstrap_schema()
        self.intents: Optional[IntentLog] = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self.intents = IntentLog(os.path.join(data_dir, "intents.log"))
            self._load_zero_state()
        self._stop = False
        self._pump_ms = pump_ms
        self._zero_state_lock = threading.Lock()
        self._rebalance_stop = None
        self._rebalance_thread = None
        if data_dir is not None and not self.zero_nodes:
            # non-replicated Zero: the move journal durability backend
            # is a file (raft-backed Zeros journal in the state machine)
            from dgraph_tpu_torch.worker.tabletmove import MoveJournal

            self.zero.journal = MoveJournal(
                os.path.join(data_dir, "moves.journal")
            )
            self.zero._moves.update(self.zero.journal.pending())
        self._pump_thread = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump_thread.start()
        self._wait_for_leaders()
        if self.zero_nodes:
            # deterministic config entry so every replica assigns tablets
            # over the same group count
            deadline = time.time() + 10
            poll = poll_policy(0.01)
            while time.time() < deadline:
                lead = next(
                    (z for z in self.zero_nodes if z.raft.is_leader()), None
                )
                if lead is not None and lead.raft.propose(
                    ("config", self.zero.n_groups)
                ):
                    break
                poll.sleep(1)
        if data_dir is not None:
            self.recover_intents()
        # heal any move a dead coordinator left journaled (rolls back
        # copy/fence phases, rolls the drop phase forward) and restore
        # the fence mirror for anything still mid-recovery
        self.zero.refresh_fences()
        if self.zero.moves():
            self.recover_moves()

    # -- durable Zero state (tablets/leases/schema; ref zero raft state) ------

    def _zero_state_path(self) -> str:
        return os.path.join(self.data_dir, "zero.json")

    def _save_zero_state(self):
        if self.data_dir is None:
            return
        with self._zero_state_lock:
            self._save_zero_state_locked()

    def _save_zero_state_locked(self):
        # serialized: the mover's flip-time persist and a concurrent
        # alter/commit/close share one fixed .tmp path — interleaved
        # writers would os.replace torn JSON into zero.json
        if self.zero_nodes:
            # leases/tablets are raft-durable; only schema text needs a file
            state = {"schemas": getattr(self, "_schema_texts", [])}
            tmp = self._zero_state_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self._zero_state_path())
            return
        z = self.zero.zero
        state = {
            "tablets": self.zero.tablets,
            "max_ts": z.max_assigned,
            "max_uid": z._max_uid,
            "schemas": getattr(self, "_schema_texts", []),
        }
        tmp = self._zero_state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self._zero_state_path())

    def _load_zero_state(self):
        path = self._zero_state_path()
        if not os.path.exists(path):
            return
        with open(path) as f:
            state = json.load(f)
        if not self.zero_nodes:
            self.zero._tablets.update(state.get("tablets", {}))
            z = self.zero.zero
            if state.get("max_ts", 0) > z.max_assigned:
                z.next_ts(state["max_ts"] - z.max_assigned)
            if state.get("max_uid", 0) > z._max_uid:
                z.assign_uids(state["max_uid"] - z._max_uid)
        self._schema_texts = list(state.get("schemas", []))
        for text in self._schema_texts:
            preds, types = parse_schema(text)
            for su in preds:
                self.schema.set(su)
            for tu in types:
                self.schema.set_type(tu)

    def recover_intents(self) -> int:
        """Re-propose every unfinished commit intent (crash replay).
        Proposals are idempotent (same-ts puts). Writes re-shard
        against the CURRENT tablet map — a move completed since the
        intent was journaled invalidates the recorded group ids, and
        replaying to the old owner would strand them on a dropped
        tablet. Returns #replayed."""
        if self.intents is None:
            return 0
        from dgraph_tpu_torch.worker.tabletmove import reshard_intent

        replayed = 0
        for cts, per_group in sorted(self.intents.pending().items()):
            for gid, writes in reshard_intent(self.zero, per_group).items():
                self._propose_and_wait(gid, ("delta", writes))
            self.intents.mark_done(cts)
            replayed += 1
        return replayed

    # -- infrastructure --------------------------------------------------------

    def _bootstrap_schema(self):
        for su in parse_schema(
            "dgraph.type: [string] @index(exact) .\n"
            "dgraph.xid: string @index(exact) .\n"
        )[0]:
            self.schema.set(su)

    def _pump_loop(self):
        now = 0
        ticks = 0
        while not self._stop:
            now += 50  # virtual ms per real pump (fast elections)
            ticks += 1
            for g in self.groups.values():
                for n in g.nodes:
                    if n.id not in self.net.down:
                        n.raft.tick(now)
                        self.zero.heartbeat(n.id)
            for z in self.zero_nodes:
                if z.id not in self.net.down:
                    z.raft.tick(now)
            if ticks % 100 == 0:
                self.zero.prune_dead(max_age_s=5.0)
            time.sleep(self._pump_ms / 1000.0)

    def _wait_for_leaders(self, timeout: float = 10.0):
        deadline = time.time() + timeout
        poll = poll_policy(0.01)
        while time.time() < deadline:
            if all(g.leader() is not None for g in self.groups.values()) and (
                not self.zero_nodes
                or any(z.raft.is_leader() for z in self.zero_nodes)
            ):
                return
            poll.sleep(1)
        raise TimeoutError("raft groups failed to elect leaders")

    def close(self):
        # join the rebalance thread BEFORE stopping the raft-tick pump:
        # a mid-tick move must finish (or fail) while proposals can
        # still make progress — an unjoined mover would race the
        # journal/zero-state writes below
        if self._rebalance_stop is not None:
            self._rebalance_stop.set()
            self._rebalance_thread.join(timeout=15)
        self._stop = True
        self._pump_thread.join(timeout=2)
        # reap the apply-shard worker processes and unlink their rings
        from dgraph_tpu_torch.worker import applyshard

        applyshard.shutdown()
        if self.intents is not None:
            self.intents.close()
        if self.zero.journal is not None:
            self.zero.journal.close()
        if self.data_dir is not None:
            self._save_zero_state()
        for g in self.groups.values():
            for n in g.nodes:
                if n.raft.wal is not None:
                    n.raft.wal.close()
                n.kv.close()
        for z in self.zero_nodes:
            if z.raft.wal is not None:
                z.raft.wal.close()

    # -- schema ----------------------------------------------------------------

    def alter(self, schema_text: str):
        preds, types = parse_schema(schema_text)
        for su in preds:
            self.schema.set(su)
            self.zero.should_serve(su.predicate)
            if su.vector_specs:
                from dgraph_tpu_torch.models.vector import VectorIndex

                self.vector_indexes.setdefault(
                    su.predicate,
                    VectorIndex(
                        su.predicate, su.vector_specs[0].metric,
                        device=self.device,
                    ),
                )
        for tu in types:
            self.schema.set_type(tu)
        if self.data_dir is not None:
            if not hasattr(self, "_schema_texts"):
                self._schema_texts = []
            self._schema_texts.append(schema_text)
            self._save_zero_state()

    def drop_attr(self, pred: str):
        """Drop one predicate cluster-wide (ref alter DropAttr: data +
        split parts + schema on the owning group)."""
        if self.zero.fenced(pred) or pred in self.zero.moves_hint():
            from dgraph_tpu_torch.worker.tabletmove import TabletFencedError

            # a drop racing a move would be resurrected by the copy
            raise TabletFencedError(
                f"tablet {pred!r} is moving; retry the drop"
            )
        gid = self.zero.belongs_to(pred)
        if gid is not None:
            with self._commit_lock:
                self._propose_and_wait(
                    gid, ("drop", keys.PredicatePrefix(pred))
                )
                self._propose_and_wait(
                    gid, ("drop", keys.SplitPredicatePrefix(pred))
                )
        self.schema.delete(pred)
        self.vector_indexes.pop(pred, None)
        self.mem.invalidate_prefix(
            (keys.PredicatePrefix(pred), keys.SplitPredicatePrefix(pred))
        )

    def drop_all(self):
        """DropAll: wipe every group's data and reset schema."""
        with self._commit_lock:
            for gid in self.groups:
                self._propose_and_wait(gid, ("drop", b""))
        self.schema = State()
        self.vector_indexes.clear()
        self._bootstrap_schema()
        self.mem.clear()

    # -- transactions ------------------------------------------------------------

    def read_kv(self) -> KV:
        return RoutingKV(self)

    def new_txn(self) -> "ClusterTxn":
        return ClusterTxn(self)

    def _commit(self, txn: Txn) -> int:
        from dgraph_tpu_torch.posting import colwrite
        from dgraph_tpu_torch.x import config as _config

        # a commit-time consumer of Posting objects that appeared after
        # txn creation (CDC sink, vector index) forces collected
        # columns back to the serial representation
        colwrite.commit_guard(txn, self)
        if not bool(_config.get("GROUP_COMMIT")):
            # escape hatch (DGRAPH_TPU_GROUP_COMMIT=0): today's serial
            # per-txn path, byte-for-byte
            return self._commit_serial(txn)
        gc = self._group_commit
        if gc is None:
            with self._commit_lock:
                gc = self._group_commit
                if gc is None:
                    from dgraph_tpu_torch.worker.groupcommit import GroupCommit

                    gc = self._group_commit = GroupCommit(self._gc_propose)
        return gc.commit(txn)

    def _commit_serial(self, txn: Txn) -> int:
        with self._commit_lock:
            return self._commit_locked(txn)

    def _gc_propose(self, members):
        """Group-commit propose phase: under ONE commit-lock hold (the
        mover's fence exclusion point) — per-member fence bounces, ONE
        oracle exchange for the whole batch, per-member intents, then
        ONE bounded ("delta", writes) proposal per (group, frame-budget
        chunk) instead of one proposal per txn per group. The in-proc
        raft's propose includes its apply wait, so only the barrier
        bookkeeping trails into the pipeline here."""
        from dgraph_tpu_torch.posting.pl import encode_deltas
        from dgraph_tpu_torch.worker.groupcommit import (
            assign_verdicts,
            chunk_group_writes,
            columnar_writes,
            commit_phase_ns,
        )
        from dgraph_tpu_torch.x import config as _config

        committed: list = []
        plans: list = []
        with self._commit_lock:
            t0 = time.perf_counter_ns()
            live = []
            for m in members:
                try:
                    self._check_fences(m.txn)
                except Exception as e:
                    m.error = e  # retryable per member, no verdict burnt
                else:
                    live.append(m)
            if live:
                committed = assign_verdicts(
                    live,
                    self.zero.zero.commit_batch(
                        [
                            (m.txn.start_ts, m.txn.conflict_keys)
                            for m in live
                        ],
                        track=True,
                    ),
                )
            t1 = time.perf_counter_ns()
            try:
                # columnar members first (ONE batch_apply kernel call
                # for the whole batch; must precede encode_deltas — a
                # materialized fallback lands in cache.deltas)
                col_writes = columnar_writes(committed)
                for m in committed:
                    per_group: Dict[int, List[Tuple[bytes, int, bytes]]] = {}
                    for key, recb, attr in col_writes.get(m, ()):
                        gid = self.zero.should_serve(attr)
                        per_group.setdefault(gid, []).append(
                            (key, m.commit_ts, recb)
                        )
                    for key, recb in encode_deltas(m.txn.cache.deltas):
                        gid = self.zero.should_serve(
                            keys.parse_key(key).attr
                        )
                        per_group.setdefault(gid, []).append(
                            (key, m.commit_ts, recb)
                        )
                    plans.append((m, per_group))
                    if self.intents is not None:
                        self.intents.append_intent(m.commit_ts, per_group)
                frame_budget = max(
                    1 << 20, int(_config.get("MAX_FRAME_BYTES")) // 4
                )
                for gid, writes, mset in chunk_group_writes(
                    plans, frame_budget
                ):
                    try:
                        self._propose_and_wait(gid, ("delta", writes))
                    except TimeoutError as e:
                        err = PartialCommitError(
                            f"batched commit proposal to group {gid} "
                            f"timed out; intents journaled — "
                            f"recover_intents() or restart completes "
                            f"it: {e}"
                        )
                        for m in mset:
                            if m.error is None:
                                m.error = err
                if self.intents is not None:
                    marked = False
                    for m, _pg in plans:
                        if m.error is None:
                            self.intents.mark_done(m.commit_ts)
                            marked = True
                    if marked:
                        self._save_zero_state()
            except Exception as e:
                # NEVER raise past the oracle: only the barrier clears
                # the tracked pending verdicts — an escaping exception
                # would leak _pending and stall every later
                # begin_txn/read_ts for the full wait bound
                for m in committed:
                    if m.error is None:
                        m.error = e
            # publish into drain() accounting BEFORE the commit lock
            # releases (worker/groupcommit.py mark_proposed); proposals
            # here are synchronous, so this is belt-and-braces for the
            # mover's fence
            gc = self._group_commit
            if gc is not None:
                gc.mark_proposed()
            commit_phase_ns(
                oracle=t1 - t0, propose=time.perf_counter_ns() - t1
            )

        def barrier():
            from dgraph_tpu_torch.posting.mutation import ingest_vectors

            tb = time.perf_counter_ns()
            for m in committed:
                self.zero.zero.applied(m.commit_ts)
            for m in committed:
                self.mem.invalidate(m.txn.cache.deltas.keys())
                ck = getattr(m.txn, "col_keys", None)
                if ck:
                    self.mem.invalidate(ck)
            # CDC in the FIFO barrier: members are commit-ts ascending
            # and barriers run in ticket order — the sink stream stays
            # strictly commit-ts ordered across batches
            cdc = getattr(self, "_cdc", None)
            for m in committed:
                if m.error is None:
                    ingest_vectors(self.vector_indexes, m.txn.cache.deltas)
                    if cdc is not None:
                        cdc.emit_commit(m.commit_ts, m.txn.cache.deltas)
            commit_phase_ns(apply=time.perf_counter_ns() - tb)

        return barrier

    def _commit_locked(self, txn: Txn) -> int:
        from dgraph_tpu_torch.posting import colwrite
        from dgraph_tpu_torch.worker.groupcommit import commit_phase_ns

        t0 = time.perf_counter_ns()
        self._check_fences(txn)
        commit_ts = self.zero.zero.commit(txn.start_ts, txn.conflict_keys, track=True)
        t1 = time.perf_counter_ns()
        # shard deltas by owning group (populateMutationMap analog)
        per_group: Dict[int, List[Tuple[bytes, int, bytes]]] = {}
        from dgraph_tpu_torch.posting.pl import encode_delta

        for key, recb, attr in colwrite.encode_txn(txn):
            gid = self.zero.should_serve(attr)
            per_group.setdefault(gid, []).append((key, commit_ts, recb))
        for key, posts in txn.cache.deltas.items():
            if not posts:
                continue
            pk = keys.parse_key(key)
            gid = self.zero.should_serve(pk.attr)
            per_group.setdefault(gid, []).append(
                (key, commit_ts, encode_delta(posts))
            )
        # The oracle decision above is final (like the reference's Zero
        # commit): deltas MUST reach every owning group. The intent is
        # journaled BEFORE proposing, so a mid-commit crash or majority
        # loss is recoverable — recover_intents()/restart completes it
        # instead of tearing state (ref zero/oracle.go:185 delta stream).
        if self.intents is not None:
            self.intents.append_intent(commit_ts, per_group)
        done = []
        try:
            for gid, writes in per_group.items():
                self._propose_and_wait(gid, ("delta", writes))
                done.append(gid)
            if self.intents is not None:
                self.intents.mark_done(commit_ts)
                self._save_zero_state()
        except TimeoutError as e:
            raise PartialCommitError(
                f"commit at ts {commit_ts} reached groups {done} but not "
                f"all before timeout; intent journaled — recover_intents() "
                f"or restart completes it: {e}"
            ) from e
        finally:
            t2 = time.perf_counter_ns()
            self.zero.zero.applied(commit_ts)
            self.mem.invalidate(txn.cache.deltas.keys())
            ck = getattr(txn, "col_keys", None)
            if ck:
                self.mem.invalidate(ck)
            commit_phase_ns(
                oracle=t1 - t0,
                propose=t2 - t1,
                apply=time.perf_counter_ns() - t2,
            )
        # vector ingestion
        from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET

        for key, posts in txn.cache.deltas.items():
            pk = keys.parse_key(key)
            vidx = self.vector_indexes.get(pk.attr)
            if vidx is not None and pk.is_data:
                for p in posts:
                    if p.is_value and p.op == OP_SET:
                        vidx.insert(pk.uid, p.val().value)
                    elif p.op == OP_DEL:
                        vidx.remove(pk.uid)
        cdc = getattr(self, "_cdc", None)
        if cdc is not None:
            # serial path runs under the commit lock: emission here is
            # already in commit-ts order
            cdc.emit_commit(commit_ts, txn.cache.deltas)
        return commit_ts

    def _propose_and_wait(self, gid: int, proposal, timeout: float = 10.0):
        """ref worker/proposal.go:125 proposeAndWait."""
        group = self.groups[gid]
        deadline = time.time() + timeout
        apply_poll = poll_policy(0.002)
        propose_poll = poll_policy(0.01)
        while time.time() < deadline:
            leader = group.leader()
            if leader is not None and leader.raft.propose(proposal):
                target = leader.raft.last_index()
                while time.time() < deadline:
                    if leader.applied_index >= target:
                        # floor BEFORE the watermark can advance: any
                        # replica applied past `target` now serves this
                        # write at any ts the caller publishes next
                        group.note_floor(target)
                        return
                    apply_poll.sleep(1)
                break
            propose_poll.sleep(1)
        raise TimeoutError(f"proposal to group {gid} timed out")

    # -- reads -------------------------------------------------------------------

    def query(self, q: str, read_ts: Optional[int] = None) -> dict:
        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.query.streamjson import encode_response_data
        from dgraph_tpu_torch.query.subgraph import Executor

        ts = read_ts if read_ts is not None else self.zero.zero.read_ts()
        cache = LocalCache(RoutingKV(self), ts, mem=self.mem)
        ex = Executor(cache, self.schema, vector_indexes=self.vector_indexes)
        nodes = ex.process(dql.parse(q))
        data, _ = encode_response_data(
            nodes, val_vars=ex.val_vars, schema=self.schema
        )
        return {"data": data}

    # -- tablet move / rebalance (ref zero/tablet.go, predicate_move.go) --------
    #
    # The phase driver lives in worker/tabletmove.py (shared verbatim
    # with the multi-process ProcCluster so the two paths cannot
    # drift); this cluster only supplies the read/propose primitives.

    def _check_fences(self, txn: Txn):
        from dgraph_tpu_torch.posting import colwrite
        from dgraph_tpu_torch.worker.tabletmove import check_fences

        # fence_keys covers columnar members: one synthetic data key
        # per collected predicate (the columns hold no concrete keys
        # until the kernel runs)
        check_fences(self.zero, colwrite.fence_keys(txn))

    def _move_leader_kv(self, gid: int, timeout: float = 5.0) -> KV:
        """The LEADER's KV, for move reads: _propose_and_wait only
        waits for the leader's apply, so a follower may lag — a
        committed version missed by the copy stream would be LOST
        after the source drop (queries tolerate follower staleness,
        a move must not). No-leader windows raise; the move rolls
        back through the journal."""
        deadline = time.time() + timeout
        poll = poll_policy(0.01)
        while time.time() < deadline:
            lead = self.groups[gid].leader()
            if lead is not None:
                return lead.kv
            poll.sleep(1)
        raise TimeoutError(f"group {gid}: no leader for move read")

    def _move_iter(self, gid, prefix, ts, since_ts, page_bytes):
        kv = self._move_leader_kv(gid)
        for key, vers in kv.iterate_versions(prefix, ts):
            if since_ts:
                vers = [(t, v) for t, v in vers if t > since_ts]
            if vers:
                yield key, vers

    def _move_propose(self, gid: int, data):
        # honor the mover's ambient fence deadline: _propose_and_wait
        # budgets with a fixed timeout and never reads deadline_scope,
        # so an in-flight proposal during the Phase-2 delta would
        # otherwise overrun the fence with the commit lock held
        from dgraph_tpu_torch.conn.retry import current_deadline

        dl = current_deadline()
        if dl is not None:
            self._propose_and_wait(
                gid, data, timeout=max(0.1, min(10.0, dl.remaining()))
            )
        else:
            self._propose_and_wait(gid, data)

    def _move_persist_zero(self):
        # flush the flipped tablet map to zero.json before the journal
        # entry clears (no-op without a data_dir; with zero_nodes the
        # map is raft-durable and this only rewrites schema text)
        self._save_zero_state()

    def _move_prefix_size(self, gid: int, prefix: bytes) -> int:
        kv = self._move_leader_kv(gid)
        return sum(
            len(v)
            for _k, vers in kv.iterate_versions(prefix, 1 << 62)
            for _ts, v in vers
        )

    def _move_group_ids(self):
        return list(self.groups)

    def move_tablet(self, pred: str, dst_group: int):
        """Phased live move: chunked background copy at a pinned ts
        (writes keep flowing), bounded Phase-2 fence (replicated moving
        state, delta catch-up, atomic flip), deferred source drop —
        every transition journaled, recoverable at any boundary."""
        from dgraph_tpu_torch.worker.tabletmove import TabletMover

        return TabletMover(self).move(pred, dst_group)

    def recover_moves(self) -> int:
        """Resolve every journaled move whose coordinator died (moves
        in flight in this process are skipped, not rolled back)."""
        from dgraph_tpu_torch.worker.tabletmove import recover_all

        return recover_all(self)

    def rebalance(self, min_move_bytes: int = 1):
        """One size-based rebalance step (the count-based picker is
        retired: it depended on dict insertion order)."""
        return self.rebalance_by_size(min_move_bytes=min_move_bytes)

    def enable_auto_rebalance(self, interval_s: Optional[float] = None):
        """Jittered background rebalance loop (ref zero/tablet.go Run);
        interval defaults to DGRAPH_TPU_REBALANCE_INTERVAL_S."""
        from dgraph_tpu_torch.worker.tabletmove import start_rebalance_loop

        if self._rebalance_stop is None:
            self._rebalance_stop, self._rebalance_thread = (
                start_rebalance_loop(self, interval_s)
            )
        return self

    def tablet_size_bytes(self, pred: str) -> int:
        """Approximate on-disk size of one tablet (record bytes of the
        predicate's data+split regions; ref zero/tablet.go size stream)."""
        from dgraph_tpu_torch.worker.tabletmove import tablet_size

        return tablet_size(self, pred)

    def rebalance_by_size(self, min_move_bytes: int = 1 << 10):
        """Size-based rebalancing (ref zero/tablet.go:53
        rebalanceTablets): deterministically move the tablet that best
        narrows the byte-load gap. Returns the moved predicate."""
        from dgraph_tpu_torch.worker.tabletmove import run_rebalance

        return run_rebalance(self, min_move_bytes=min_move_bytes)

    def rebalance_by_traffic(self, min_move_bytes: int = 1 << 10):
        """Traffic-weighted rebalancing: each tablet weighs its size
        PLUS observed traffic from the process-local accumulator (one
        process hosts every in-process replica), so a hot small tablet
        can out-score a cold giant one."""
        from dgraph_tpu_torch.worker.tabletmove import run_rebalance

        return run_rebalance(
            self, min_move_bytes=min_move_bytes, by_traffic=True
        )

    def merged_tablets(self) -> dict:
        """Per-tablet traffic rows (the /debug/tablets body). The
        in-process cluster shares ONE accumulator across its replicas,
        so the local snapshot already is the cluster view."""
        from dgraph_tpu_torch.utils import observe
        from dgraph_tpu_torch.worker.harness import merge_tablet_rows

        observe.TABLETS.publish()
        return {
            "tablets": merge_tablet_rows([observe.TABLETS.snapshot()]),
            "instances": ["local"],
            "unreachable_instances": [],
        }

    def health(self) -> dict:
        """The health/SLO rollup (/debug/healthz body): per-group raft
        leadership + per-replica applied-index lag straight off the
        in-process nodes, snapshot-watermark lag, plus the shared
        process healthz (admission rates, pipeline depth, SLO burn)."""
        from dgraph_tpu_torch.utils import observe

        out = observe.healthz("local")
        groups: Dict[str, dict] = {}
        for gid, group in sorted(self.groups.items()):
            leader = group.leader()
            leader_applied = leader.applied_index if leader else 0
            replicas = {}
            for n in group.nodes:
                down = n.id in self.net.down
                replicas[str(n.id)] = {
                    "ok": not down,
                    "is_leader": leader is not None and n.id == leader.id,
                    "term": int(n.raft.term),
                    "applied": int(n.applied_index),
                    "applied_lag": max(
                        0, int(leader_applied - n.applied_index)
                    ),
                }
            groups[str(gid)] = {
                "leader": leader.id if leader else None,
                "healthy": leader is not None,
                "replicas": replicas,
            }
        out["groups"] = groups
        # this cluster reads at fresh barrier-waited timestamps (no
        # published watermark), so the watermark view is zero-sourced
        ma = getattr(self.zero.zero, "max_assigned", None)
        if isinstance(ma, (int, float)):
            out["snapshot_watermark"] = int(ma)
        if any(not g["healthy"] for g in groups.values()):
            out["status"] = "degraded"
        return out

    # -- failure handling ---------------------------------------------------------

    def kill_node(self, node_id: int):
        self.net.down.add(node_id)

    def revive_node(self, node_id: int):
        self.net.down.discard(node_id)


class ClusterTxn:
    def __init__(self, cluster: DistributedCluster):
        from dgraph_tpu_torch.posting import colwrite

        self.cluster = cluster
        self.start_ts = cluster.zero.zero.begin_txn()
        self.txn = Txn(cluster.read_kv(), self.start_ts, mem=cluster.mem)
        colwrite.maybe_enable(self.txn, cluster)

    def mutate_rdf(self, set_rdf: str = "", del_rdf: str = "", commit_now=False):
        from dgraph_tpu_torch.loaders.rdf import parse_rdf
        from dgraph_tpu_torch.posting.mutation import apply_edges
        from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET
        from dgraph_tpu_torch.posting.mutation import DirectedEdge, delete_entity_attr

        blank: Dict[str, int] = {}
        fresh_uids: set = set()  # uids leased by THIS request

        def resolve(ref: str) -> int:
            if ref.startswith("_:"):
                if ref not in blank:
                    blank[ref] = self.cluster.zero.zero.assign_uids(1)
                    fresh_uids.add(blank[ref])
                return blank[ref]
            return int(ref, 16) if ref.startswith("0x") else int(ref)

        # batched application (posting/mutation.apply_edges): edges
        # accumulate and flush in bulk; a star delete flushes first so
        # it observes every edge that preceded it in order
        pending: List[DirectedEdge] = []

        def flush():
            if pending:
                apply_edges(self.txn, self.cluster.schema, pending)
                pending.clear()

        for rdf, op in ((set_rdf, OP_SET), (del_rdf, OP_DEL)):
            for nq in parse_rdf(rdf):
                # ensure tablets exist for written predicates
                self.cluster.zero.should_serve(nq.predicate)
                subj = resolve(nq.subject)
                if nq.star:
                    flush()
                    delete_entity_attr(
                        self.txn, self.cluster.schema, subj, nq.predicate
                    )
                    continue
                if nq.object_id:
                    edge = DirectedEdge(
                        subj, nq.predicate, value_id=resolve(nq.object_id),
                        facets=nq.facets, op=op,
                        fresh=subj in fresh_uids,
                    )
                else:
                    edge = DirectedEdge(
                        subj, nq.predicate, value=nq.object_value,
                        lang=nq.lang, facets=nq.facets, op=op,
                        fresh=subj in fresh_uids,
                    )
                pending.append(edge)
        flush()
        if commit_now:
            return self.commit()
        return blank

    def commit(self) -> int:
        return self.cluster._commit(self.txn)
