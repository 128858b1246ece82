"""Multi-process cluster harness (ref dgraphtest/local_cluster.go:92).

Spawns one OS process per Alpha replica (dgraph_tpu_torch.worker.alpha_process),
runs the Zero/coordinator in the calling process, and exposes the same
alter / new_txn / query surface as DistributedCluster — but every read is
a real RPC and every commit is a real cross-process raft proposal.

Fault injection at process granularity: kill(node) SIGKILLs the replica,
restart(node) respawns it from its data dir (durable mode).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.conn.retry import (
    Deadline,
    current_deadline,
    deadline_scope,
    poll_policy,
)
from dgraph_tpu_torch.conn.rpc import RpcError, RpcPool
from dgraph_tpu_torch.posting.lists import Txn
from dgraph_tpu_torch.serving.digest import DIGESTS
from dgraph_tpu_torch.utils import observe
from dgraph_tpu_torch.utils.observe import METRICS, TRACER, profile_scope
from dgraph_tpu_torch.schema.schema import State, parse_schema
from dgraph_tpu_torch.worker.groups import ClusterTxn, IntentLog, ZeroService
from dgraph_tpu_torch.worker.remote import RemoteGroup, RemoteKV
from dgraph_tpu_torch.x import config, keys


def merge_tablet_rows(per_instance: List[List[dict]]) -> List[dict]:
    """Merge per-process /debug/tablets rows into ONE cluster view:
    counters (reads, uids, edges, bytes) sum by (ns, predicate); the
    latency EWMA merges as the read-weighted average (an instance that
    served 10x the reads owns 10x of the merged latency signal).
    The tablets analog of observe.merge_expositions."""
    merged: Dict[Tuple[int, str], dict] = {}
    for rows in per_instance:
        for r in rows:
            key = (int(r.get("ns", 0)), str(r.get("predicate", "")))
            m = merged.get(key)
            if m is None:
                m = merged[key] = {
                    "ns": key[0], "predicate": key[1], "reads": 0,
                    "read_uids": 0, "mutation_edges": 0,
                    "decoded_bytes": 0, "result_bytes": 0,
                    "_lat_w": 0.0,
                }
            for f in (
                "reads", "read_uids", "mutation_edges",
                "decoded_bytes", "result_bytes",
            ):
                m[f] += int(r.get(f, 0))
            m["_lat_w"] += (
                float(r.get("lat_ewma_ms", 0.0)) * int(r.get("reads", 0))
            )
    out = []
    for m in merged.values():
        w = m.pop("_lat_w")
        m["lat_ewma_ms"] = round(w / m["reads"], 3) if m["reads"] else 0.0
        out.append(m)
    out.sort(key=lambda r: (r["ns"], r["predicate"]))
    return out


def _free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ProcCluster:
    def __init__(
        self,
        device="cuda",
        n_groups: int = 1,
        replicas: int = 3,
        data_dir: Optional[str] = None,
        compact_every: int = 0,
        replicated_zero: bool = False,
        zero_replicas: int = 3,
        wal_sync: bool = False,  # tests: process-crash durability suffices
    ):
        # the coordinator's Executor runs its set ops on `device`; the
        # replicas never touch it. CUDA must be present when asked,
        # checked before any process is spawned
        from dgraph_tpu_torch.device import resolve_device
        from dgraph_tpu_torch.query import dispatch

        dispatch.DISPATCHER.bind(resolve_device(device))
        self.device = dispatch.DISPATCHER.device
        self.wal_sync = wal_sync
        # coordinator-side span sink (one file per process; replicas get
        # theirs in their own mains via the inherited TRACE_SINK env)
        observe.init_from_env()
        self.pool = RpcPool(heartbeat_s=0.5, timeout=5.0).start_heartbeats()
        self.procs: Dict[int, subprocess.Popen] = {}
        self._cfgs: Dict[int, dict] = {}
        self.data_dir = data_dir
        zero_impl = None
        if replicated_zero:
            from dgraph_tpu_torch.zero.remote import RemoteZero

            zids = list(range(901, 901 + zero_replicas))
            zraft = _free_ports(zero_replicas)
            zrpc = _free_ports(zero_replicas)
            raft_addrs = {
                str(i): ["127.0.0.1", p] for i, p in zip(zids, zraft)
            }
            zaddrs = []
            for i, rp in zip(zids, zrpc):
                cfg = {
                    "node_id": i,
                    "replica_ids": zids,
                    "raft_addrs": raft_addrs,
                    "rpc_addr": ["127.0.0.1", rp],
                    "n_groups": n_groups,
                    "data_dir": (
                        os.path.join(data_dir, "zero") if data_dir else None
                    ),
                    "wal_sync": wal_sync,
                    "_module": "dgraph_tpu_torch.zero.zero_process",
                }
                self._cfgs[i] = cfg
                zaddrs.append(("127.0.0.1", rp))
                self._spawn(i)
            zero_impl = RemoteZero(zaddrs, self.pool)
            # wait for the zero quorum's leader. 90s, not 30: freshly
            # forked replica interpreters on a loaded 1-core CI box
            # (the full tier-1 suite running beside this cluster) can
            # take tens of seconds to import + bind + elect, and a
            # startup TimeoutError here is a pure flake, not a signal
            deadline = time.time() + 90
            poll = poll_policy(0.2)
            while time.time() < deadline:
                try:
                    zero_impl._exec("lease_ts", 1, timeout=2.0)
                    break
                except TimeoutError:
                    poll.sleep(1)
            else:
                raise TimeoutError("zero quorum never elected a leader")
        self.zero = ZeroService(n_groups, zero=zero_impl)
        self.schema = State()
        from dgraph_tpu_torch.posting.memlayer import MemoryLayer

        self.mem = MemoryLayer()
        self.vector_indexes: Dict[str, object] = {}
        from dgraph_tpu_torch.serving import ServingFront
        from dgraph_tpu_torch.utils.cmsketch import StatsHolder

        self.stats = StatsHolder()
        # high-QPS serving front: plan cache + cross-query micro-batcher
        # + admission control at the cluster query entry point.
        # _snapshot_ts: last commit made visible (published before the
        # zero applied barrier) — the batcher's snapshot watermark.
        self._snapshot_ts = 0
        self.serving = ServingFront(
            stats=self.stats,
            schema_fn=lambda: self.schema,
            last_commit_fn=lambda: self._snapshot_ts,
        )
        self.remote_groups: Dict[int, RemoteGroup] = {}
        self._commit_lock = threading.Lock()
        self._group_commit = None  # lazy (worker/groupcommit.py)
        self._commit_prop_pool = None  # lazy proposal executor
        self._rebalance_stop = None
        self._rebalance_thread = None
        self._tablets_path: Optional[str] = None
        self._tablets_persist_lock = threading.Lock()
        self.intents: Optional[IntentLog] = None
        if data_dir is not None:
            os.makedirs(data_dir, exist_ok=True)
            self.intents = IntentLog(os.path.join(data_dir, "intents.log"))
            if zero_impl is None:
                # non-replicated Zero: the move journal's durability
                # backend is a file (a raft-backed Zero quorum journals
                # moves in its replicated state machine instead)
                from dgraph_tpu_torch.worker.tabletmove import MoveJournal

                self.zero.journal = MoveJournal(
                    os.path.join(data_dir, "moves.journal")
                )
                self.zero._moves.update(self.zero.journal.pending())
                # the flipped tablet map persists alongside the journal
                # (written at flip time, BEFORE the journal clears): a
                # restarted coordinator must not reassign a moved
                # predicate back to its dropped former source
                self._tablets_path = os.path.join(
                    data_dir, "zero_tablets.json"
                )
                if os.path.exists(self._tablets_path):
                    with open(self._tablets_path) as f:
                        self.zero._tablets.update(
                            {p: int(g) for p, g in json.load(f).items()}
                        )

        nid = 0
        for g in range(1, n_groups + 1):
            ids = list(range(nid + 1, nid + replicas + 1))
            nid += replicas
            raft_ports = _free_ports(replicas)
            rpc_ports = _free_ports(replicas)
            raft_addrs = {
                str(i): ["127.0.0.1", p] for i, p in zip(ids, raft_ports)
            }
            addrs = []
            for i, rp in zip(ids, rpc_ports):
                cfg = {
                    "node_id": i,
                    "group_id": g,
                    "replica_ids": ids,
                    "raft_addrs": raft_addrs,
                    "rpc_addr": ["127.0.0.1", rp],
                    "compact_every": compact_every,
                    "data_dir": (
                        os.path.join(data_dir, f"group_{g}")
                        if data_dir
                        else None
                    ),
                    "wal_sync": wal_sync,
                }
                self._cfgs[i] = cfg
                addrs.append(("127.0.0.1", rp))
                self._spawn(i)
                self.zero.connect(i, g)
            self.remote_groups[g] = RemoteGroup(g, addrs, self.pool)
        self._bootstrap_schema()
        self._wait_healthy()
        if self.intents is not None:
            self.recover_intents()
        # heal any move a dead coordinator left journaled (in the Zero
        # quorum's state machine or the MoveJournal file)
        self.zero.refresh_fences()
        if self.zero.moves():
            self.recover_moves()

    # -- process control ------------------------------------------------------

    def _spawn(self, node_id: int):
        cfg = self._cfgs[node_id]
        module = cfg.get("_module", "dgraph_tpu_torch.worker.alpha_process")
        cfg_dir = self.data_dir or "/tmp/dgraph_tpu_torch_proc"
        os.makedirs(cfg_dir, exist_ok=True)
        path = os.path.join(cfg_dir, f"alpha_{node_id}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"  # replicas never need the device
        # the replica must import dgraph_tpu_torch regardless of the caller's cwd
        import dgraph_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(dgraph_tpu_torch.__file__))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        log = open(os.path.join(cfg_dir, f"alpha_{node_id}.log"), "ab")
        self.procs[node_id] = subprocess.Popen(
            [sys.executable, "-m", module, path],
            env=env,
            stdout=log,
            stderr=log,
        )
        log.close()

    def kill(self, node_id: int):
        p = self.procs.get(node_id)
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=5)

    def restart(self, node_id: int):
        self.kill(node_id)
        self._spawn(node_id)

    def _wait_healthy(self, timeout: float = 90.0):
        """Block until every group has an RPC-reachable leader. Bypasses
        the leader/health caches: after a respawn the caches are stale and
        freshly-booted replica interpreters can take seconds to bind —
        tens of seconds when the full tier-1 suite loads the box (the
        PR 11/12 chaos-bank flake was this deadline tripping under
        full-suite load; it only delays genuinely-broken runs)."""
        deadline = time.time() + timeout
        poll = poll_policy(0.2)
        for g in self.remote_groups.values():
            g._leader = None  # force fresh discovery
            ok = False
            while time.time() < deadline and not ok:
                for a in g.addrs:
                    try:
                        h = self.pool.call(a, "health", timeout=1.0)
                        g._note_health(a, h)  # warm the replica picker
                        if h.is_leader:
                            g._leader = tuple(a)
                            g._leader_at = time.time()
                            ok = True
                            break
                    except RpcError:
                        continue
                if not ok:
                    poll.sleep(1)
            if not ok:
                raise TimeoutError(f"group {g.gid} never elected a leader")

    def close(self):
        if self._rebalance_stop is not None:
            self._rebalance_stop.set()
            # let a mid-tick move finish before its replicas vanish —
            # an unjoined mover would race the journal close below
            self._rebalance_thread.join(timeout=15)
        if self._commit_prop_pool is not None:
            self._commit_prop_pool.shutdown(wait=False)
        # reap the apply-shard worker processes and unlink their rings
        # (no commit can be in flight here — callers stop traffic
        # before close; drain() inside shutdown is the backstop)
        from dgraph_tpu_torch.worker import applyshard

        applyshard.shutdown()
        for nid in list(self.procs):
            self.kill(nid)
        self.pool.close()
        if self.intents is not None:
            self.intents.close()
        if self.zero.journal is not None:
            self.zero.journal.close()

    # -- coordinator surface (mirrors DistributedCluster) ---------------------

    def _bootstrap_schema(self):
        for su in parse_schema(
            "dgraph.type: [string] @index(exact) .\n"
            "dgraph.xid: string @index(exact) .\n"
        )[0]:
            self.schema.set(su)

    def alter(self, schema_text: str):
        self.serving.on_commit()  # schema changes invalidate cached plans
        preds, types = parse_schema(schema_text)
        for su in preds:
            self.schema.set(su)
            self.zero.should_serve(su.predicate)
        for tu in types:
            self.schema.set_type(tu)
        # schema changes can alter query SEMANTICS (@lang value picks,
        # index-backed execution paths) without a commit: advance the
        # snapshot watermark so no watermark-keyed cached result (and
        # no batcher coalescing group) spans the alter — the same
        # discipline api/server.alter applies
        self._snapshot_ts = max(
            self._snapshot_ts, self.zero.zero.next_ts()
        )

    def read_kv(self, partial_ok: bool = False):
        # one ReadContext per logical read operation: every group this
        # KV fans out to shares its retry/hedge budget, and leaderless
        # serving is recorded here for the response extensions
        kv = RemoteKV(self, partial_ok=partial_ok,
                      ctx=self.serving.read_context())
        # stable identity for the micro-batcher: a fresh RemoteKV is
        # built per query, but any two over this cluster (same
        # partial_ok) read identically at equal snapshots — without
        # this the batcher's id(kv) group key could never match and
        # cluster-side coalescing would be dead code
        kv.coalesce_key = ("cluster", id(self), partial_ok)
        return kv

    def new_txn(self) -> ClusterTxn:
        return ClusterTxn(self)

    def _commit(self, txn: Txn) -> int:
        from dgraph_tpu_torch.posting import colwrite

        # a commit-time consumer of Posting objects that appeared after
        # txn creation (CDC sink) forces collected columns back to the
        # serial representation before anything reads the txn
        colwrite.commit_guard(txn, self)
        # admission costs writes too: a commit charges the same
        # in-flight token budget queries draw from (retryable 429 over
        # budget; no-op with DGRAPH_TPU_ADMISSION off)
        n_edges = txn.pending_postings()
        ticket = self.serving.admit_write(n_edges)
        t_commit0 = time.monotonic()
        try:
            if not bool(config.get("GROUP_COMMIT")):
                # escape hatch (DGRAPH_TPU_GROUP_COMMIT=0): today's
                # serial per-txn path, byte-for-byte
                cts = self._commit_serial(txn)
            else:
                gc = self._group_commit
                if gc is None:
                    with self._commit_lock:
                        gc = self._group_commit
                        if gc is None:
                            from dgraph_tpu_torch.worker.groupcommit import (
                                GroupCommit,
                            )

                            gc = self._group_commit = GroupCommit(
                                self._gc_propose,
                                serial_fn=self._gc_serial,
                            )
                with METRICS.timer("commit_latency_seconds"):
                    cts = gc.commit(txn)
                if not getattr(txn, "gc_bypassed", False):
                    # the bypass ran the serial path, which feeds the
                    # stats inline
                    self._feed_stats(txn.cache.deltas)
                    colwrite.feed_col_stats(self.stats, txn)
            # counted for BOTH arms (only on success — the metric is
            # postings WRITTEN): the A/B escape hatch must not turn
            # the edge-throughput denominator dark; recounted after the
            # commit so the columnar kernel's exact posting count wins
            # over the admission estimate
            METRICS.inc(
                "mutation_edges_total",
                sum(len(p) for p in txn.cache.deltas.values())
                + getattr(txn, "col_nposts", 0),
            )
            # per-tenant SLO slice (cluster writes are galaxy-ns today;
            # the tag mirrors api/server.py so the healthz shape is one)
            observe.note_tenant(
                "commit",
                getattr(txn, "tenant_ns", keys.GALAXY_NS),
                time.monotonic() - t_commit0,
            )
            return cts
        finally:
            self.serving.release_write(ticket)

    def _gc_serial(self, txn: Txn) -> int:
        """Adaptive group-commit bypass target (worker/groupcommit.py):
        the serial path minus its own latency timer (gc.commit's
        caller already runs one); the mark tells _commit the stats
        were fed inline."""
        txn.gc_bypassed = True
        return self._commit_serial(txn, timed=False)

    def _commit_serial(self, txn: Txn, timed: bool = True) -> int:
        import contextlib

        # the mutation entry point stamps ONE deadline that flows through
        # zero.commit and every group proposal beneath it
        budget = float(config.get("COMMIT_DEADLINE_S"))
        with deadline_scope(current_deadline() or Deadline.after(budget)):
            with TRACER.span("commit"), (
                METRICS.timer("commit_latency_seconds")
                if timed
                else contextlib.nullcontext()
            ):
                with self._commit_lock:
                    cts = self._commit_locked(txn)
        METRICS.inc("num_commits")
        self.serving.on_commit()  # commit-epoch plan invalidation
        self._feed_stats(txn.cache.deltas)
        from dgraph_tpu_torch.posting import colwrite

        colwrite.feed_col_stats(self.stats, txn)
        return cts

    def _gc_propose(self, members):
        """Group-commit propose phase (ref the TxnWriter batching
        model): under ONE commit-lock hold — the mover's fence
        exclusion point — bounce fenced members retryably, decide the
        whole batch in ONE zero.commit exchange, journal intents, and
        dispatch the batch's deltas as bounded per-group ("delta",
        writes) proposals on the commit pool. Proposal completion waits
        ride in the returned barrier, so the NEXT batch's oracle
        exchange and proposals are in flight before this batch's apply
        barrier completes (the pipeline); the snapshot watermark still
        advances in commit-ts order because barriers run FIFO."""
        from dgraph_tpu_torch.posting import colwrite
        from dgraph_tpu_torch.posting.pl import encode_deltas
        from dgraph_tpu_torch.worker.groupcommit import (
            assign_verdicts,
            columnar_writes,
            commit_phase_ns,
        )
        from dgraph_tpu_torch.worker.tabletmove import check_fences

        budget = float(config.get("COMMIT_DEADLINE_S"))
        dl = Deadline.after(budget)
        committed: list = []
        plans: list = []  # (member, per_group writes)
        futs: list = []  # (future, member set for that chunk)
        with deadline_scope(dl), TRACER.span(
            "commit", batch=len(members)
        ), self._commit_lock:
            t0 = time.perf_counter_ns()
            live = []
            for m in members:
                try:
                    # fence bounces are retryable and PER MEMBER — a
                    # moving tablet never aborts its batchmates, and no
                    # oracle verdict is burned for the bounced txn.
                    # colwrite.fence_keys covers columnar members: one
                    # synthetic data key per collected predicate
                    check_fences(self.zero, colwrite.fence_keys(m.txn))
                except Exception as e:
                    m.error = e
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
                # materialized fallback lands in cache.deltas). The
                # kernel reports each pair's attr, so group routing
                # needs no parse_key
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
                # ONE bounded proposal per (group, frame-budget chunk)
                # for the whole batch, dispatched async on the commit
                # pool — the apply wait happens in the barrier
                frame_budget = max(
                    1 << 20, int(config.get("MAX_FRAME_BYTES")) // 4
                )
                from dgraph_tpu_torch.worker.groupcommit import (
                    chunk_group_writes,
                )

                for gid, writes, mset in chunk_group_writes(
                    plans, frame_budget
                ):
                    g = self.remote_groups[gid]
                    timeout = max(0.5, dl.remaining())
                    futs.append(
                        (
                            self._commit_pool().submit(
                                g.propose, ("delta", writes), timeout
                            ),
                            mset,
                        )
                    )
            except Exception as e:
                # NEVER raise past the oracle: only the barrier clears
                # the tracked pending verdicts — an escaping exception
                # would leak _pending and stall every later
                # begin_txn/read_ts for the full wait bound
                for m in committed:
                    if m.error is None:
                        m.error = e
            # publish into drain() accounting BEFORE the commit lock
            # releases — the mover's fence must see these airborne
            # proposals (worker/groupcommit.py mark_proposed)
            gc = self._group_commit
            if gc is not None:
                gc.mark_proposed()
            commit_phase_ns(
                oracle=t1 - t0, propose=time.perf_counter_ns() - t1
            )

        def barrier():
            tb = time.perf_counter_ns()
            try:
                for fut, mset in futs:
                    try:
                        fut.result()
                    except Exception as e:
                        # ambiguous like the serial path's propose
                        # timeout: the intent stays pending and
                        # recover_intents()/restart completes it
                        for m in mset:
                            if m.error is None:
                                m.error = e
                if self.intents is not None:
                    for m, _pg in plans:
                        if m.error is None:
                            self.intents.mark_done(m.commit_ts)
            finally:
                ok = 0
                for m in committed:
                    # watermark BEFORE the apply barrier, advanced in
                    # commit-ts order (batches barrier FIFO); max() so
                    # a concurrent move's watermark bump never regresses
                    self._snapshot_ts = max(
                        self._snapshot_ts, m.commit_ts
                    )
                    self.zero.zero.applied(m.commit_ts)
                    if m.error is None:
                        ok += 1
                for m in committed:
                    self.mem.invalidate(m.txn.cache.deltas.keys())
                    ck = getattr(m.txn, "col_keys", None)
                    if ck:
                        self.mem.invalidate(ck)
                # CDC in the FIFO barrier: members commit-ts ascending,
                # barriers ticket-ordered — the sink stream stays
                # strictly commit-ts ordered across batches
                cdc = getattr(self, "_cdc", None)
                if cdc is not None:
                    for m in committed:
                        if m.error is None:
                            cdc.emit_commit(
                                m.commit_ts, m.txn.cache.deltas
                            )
                if ok:
                    METRICS.inc("num_commits", ok)
                    self.serving.on_commit()  # ONE epoch bump per batch
                commit_phase_ns(apply=time.perf_counter_ns() - tb)

        return barrier

    def _commit_pool(self):
        """Bounded executor for pipelined commit proposals. Lazy, and
        only ever touched from a batch leader's propose phase — which
        runs under _commit_lock — so creation cannot race."""
        pool = self._commit_prop_pool
        if pool is None:
            import concurrent.futures

            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="commitprop"
            )
            self._commit_prop_pool = pool
        return pool

    def _feed_stats(self, deltas):
        """Index-key posting counts into the selectivity sketch — the
        admission controller's cost model (shared with Server)."""
        from dgraph_tpu_torch.utils.cmsketch import feed_stats

        feed_stats(self.stats, deltas)

    def _commit_locked(self, txn: Txn) -> int:
        from dgraph_tpu_torch.posting import colwrite
        from dgraph_tpu_torch.posting.pl import encode_delta
        from dgraph_tpu_torch.worker.groupcommit import commit_phase_ns
        from dgraph_tpu_torch.worker.tabletmove import check_fences

        t0 = time.perf_counter_ns()
        # a commit into a move's Phase-2 fence bounces RETRYABLE before
        # the oracle burns a verdict (never wrong data, never a write
        # the source drop would destroy); fence_keys adds one synthetic
        # data key per columnar predicate
        check_fences(self.zero, colwrite.fence_keys(txn))
        commit_ts = self.zero.zero.commit(
            txn.start_ts, txn.conflict_keys, track=True
        )
        t1 = time.perf_counter_ns()
        per_group: Dict[int, List[Tuple[bytes, int, bytes]]] = {}
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
        if self.intents is not None:
            self.intents.append_intent(commit_ts, per_group)
        try:
            for gid, writes in per_group.items():
                self.remote_groups[gid].propose(("delta", writes))
            if self.intents is not None:
                self.intents.mark_done(commit_ts)
        finally:
            t2 = time.perf_counter_ns()
            # watermark BEFORE the apply barrier (batcher snapshot key);
            # max() guards concurrent watermark bumps (moves)
            self._snapshot_ts = max(self._snapshot_ts, commit_ts)
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
        cdc = getattr(self, "_cdc", None)
        if cdc is not None:
            # serial path runs under the commit lock: already ordered
            cdc.emit_commit(commit_ts, txn.cache.deltas)
        return commit_ts

    def recover_intents(self) -> int:
        if self.intents is None:
            return 0
        from dgraph_tpu_torch.worker.tabletmove import reshard_intent

        replayed = 0
        for cts, per_group in sorted(self.intents.pending().items()):
            for gid, writes in reshard_intent(self.zero, per_group).items():
                self.remote_groups[gid].propose(("delta", writes))
            self.intents.mark_done(cts)
            replayed += 1
        return replayed

    # -- tablet move / rebalance (ref predicate_move.go, zero/tablet.go) ------
    #
    # The phased driver is shared with the in-process DistributedCluster
    # (worker/tabletmove.py); this harness supplies only the paged RPC
    # read stream and the leader-routed proposal primitive.

    def _move_iter(self, gid, prefix, ts, since_ts, page_bytes):
        """Paged kv.iterate_versions over the source group: each
        response frame is bounded by max_bytes (a whole tablet can be
        far larger than the frame cap), resumed by key cursor. Yields
        (key, versions newest-first), keys ascending."""
        from dgraph_tpu_torch.conn.messages import IterateRequest

        g = self.remote_groups[gid]
        after = b""
        while True:
            # leader-only: a follower may lag the leader's applied
            # index, and a copy stream — unlike a query — must never
            # miss a committed write (the source drop would destroy
            # it); leader failures retry via re-discovery
            got = g.read(
                "kv.iterate_versions",
                IterateRequest(
                    prefix=prefix, ts=ts, since=since_ts,
                    after=after, max_bytes=page_bytes,
                ),
                leader_only=True,
                timeout=30.0,
            )
            cur, vers = None, []
            for r in got.kv:
                k = bytes(r.key)
                if k != cur:
                    if cur is not None:
                        yield cur, vers
                    cur, vers = k, []
                vers.append((int(r.ts), bytes(r.value)))
            if cur is not None:
                yield cur, vers
                after = cur
            if not got.more:
                break

    def _move_propose(self, gid: int, data):
        self.remote_groups[int(gid)].propose(data)

    def _move_persist_zero(self):
        """Flush the tablet map next to the file journal (called by the
        phase driver right after a flip, before the journal entry
        clears). No-op without a data_dir; with a Zero quorum the map
        is raft-durable and no file is configured."""
        if self._tablets_path is None:
            return
        with self._tablets_persist_lock:  # flips of two preds can race
            tmp = self._tablets_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dict(self.zero.tablets), f)
            os.replace(tmp, self._tablets_path)

    def _move_prefix_size(self, gid: int, prefix: bytes) -> int:
        """Server-side tablet sizing (kv.prefix_size RPC): one small
        reply per prefix instead of streaming the tablet to count it."""
        from dgraph_tpu_torch.conn.messages import IterateRequest

        got = self.remote_groups[gid].read(
            "kv.prefix_size",
            IterateRequest(prefix=prefix, ts=1 << 62),
            timeout=30.0,
        )
        return int(got["bytes"])

    def _move_group_ids(self):
        return list(self.remote_groups)

    def _move_bump_snapshot(self):
        # routing changed outside the applied barrier: advance the
        # batcher watermark past every in-flight read_ts (max()-guarded
        # like every other watermark writer)
        self._snapshot_ts = max(self._snapshot_ts, self.zero.zero.next_ts())

    def move_tablet(self, pred: str, dst_group: int):
        """Cross-process phased predicate move (ref
        worker/predicate_move.go): chunked background copy at a pinned
        read_ts (writes keep flowing to the source; commits on other
        predicates never block), bounded Phase-2 fence (replicated
        moving state + delta catch-up + atomic ownership flip through
        Zero), deferred source drop. Every transition is journaled;
        recover_moves() heals a coordinator death at any boundary."""
        from dgraph_tpu_torch.worker.tabletmove import TabletMover

        return TabletMover(self).move(pred, dst_group)

    def recover_moves(self) -> int:
        """Resolve every journaled move whose coordinator died:
        copy/fence phases roll back (partial destination copy dropped,
        fence lifted), the drop phase rolls forward (flip re-asserted,
        source drop completed). Moves in flight in this process are
        skipped, not rolled back. Returns the number resolved."""
        from dgraph_tpu_torch.worker.tabletmove import recover_all

        return recover_all(self)

    def tablet_size_bytes(self, pred: str) -> int:
        from dgraph_tpu_torch.worker.tabletmove import tablet_size

        return tablet_size(self, pred)

    def rebalance_by_size(self, min_move_bytes: int = 1 << 10):
        """One deterministic size-based rebalance step (ref
        zero/tablet.go:53); returns the moved predicate or None."""
        from dgraph_tpu_torch.worker.tabletmove import run_rebalance

        return run_rebalance(self, min_move_bytes=min_move_bytes)

    def rebalance_by_traffic(self, min_move_bytes: int = 1 << 10):
        """One traffic-weighted rebalance step: tablets weigh their
        size PLUS observed traffic (cluster-merged /debug/tablets
        rows), so a hot small tablet can out-score a cold giant one
        (worker/tabletmove.pick_rebalance_move_by_traffic)."""
        from dgraph_tpu_torch.worker.tabletmove import run_rebalance

        return run_rebalance(
            self, min_move_bytes=min_move_bytes, by_traffic=True
        )

    def enable_auto_rebalance(self, interval_s: Optional[float] = None):
        """Jittered background auto-rebalance loop (poll_policy over
        DGRAPH_TPU_REBALANCE_INTERVAL_S): heals journaled half-moves,
        then takes one size-based move per tick."""
        from dgraph_tpu_torch.worker.tabletmove import start_rebalance_loop

        if self._rebalance_stop is None:
            self._rebalance_stop, self._rebalance_thread = (
                start_rebalance_loop(self, interval_s)
            )
        return self

    def query(self, q: str, read_ts: Optional[int] = None,
              timeout_s: Optional[float] = None,
              want: str = "dict", debug: bool = False) -> dict:
        """Query with graceful degradation: the entry point stamps one
        deadline for the whole read fan-out, and a group whose quorum is
        unreachable yields empty reads plus a `degraded`/`partial`
        marker in the response extensions instead of an error — queries
        touching only healthy groups are unaffected.

        Observability: the whole fan-out runs under ONE root span whose
        context flows over every RPC (alpha reads, zero oracle calls),
        and the response carries reference-shaped
        `extensions.server_latency` (parsing/assign_timestamp/
        processing/encoding/total ns) plus an `extensions.profile`
        block — per-(predicate, level) task timings, kernel-choice
        counts, retry/degradation events, and per-instance RPC
        fragments piggybacked on the responses. Queries slower than
        DGRAPH_TPU_SLOW_QUERY_MS are force-sampled and appended to the
        slow-query JSONL log with their local span tree.

        `debug=True` (EXPLAIN/ANALYZE) turns on the decision-capture
        hooks and attaches the structured plan tree as
        `extensions.plan`; response `data` bytes are identical with the
        flag on or off (observation-only capture)."""
        from dgraph_tpu_torch.posting.lists import LocalCache, cache_tier_snapshot
        from dgraph_tpu_torch.query.functions import QueryBudgetError
        from dgraph_tpu_torch.query.streamjson import encode_response_data
        from dgraph_tpu_torch.query.subgraph import Executor

        budget = timeout_s or float(config.get("QUERY_DEADLINE_S"))
        kv = self.read_kv(partial_ok=True)
        t_start = time.perf_counter()
        truncated = False
        degrade_deadline = None
        ticket = None
        shape = None
        slow = False
        completed = False  # clean, untruncated execution
        # info always collected: the digest store records the plan-
        # cache outcome per shape, not just EXPLAIN requests
        parse_info: dict = {}
        cache_base = cache_tier_snapshot(self.mem) if debug else None
        digested = False  # one digest record per query, on every path
        try:
            with deadline_scope(
                current_deadline() or Deadline.after(budget)
            ), \
                    TRACER.span("query") as root, \
                    profile_scope(debug=debug) as prof, \
                    METRICS.timer("query_latency_seconds"):
                with TRACER.span("parse"):
                    # plan cache: repeated shapes skip parse entirely
                    blocks, shape, literals = self.serving.parse(
                        q, info=parse_info
                    )
                # admission gate: shed fast past the in-flight budget,
                # degrade (bounded budget + partial response) under
                # saturation — a shed raises out through the root span
                ticket = self.serving.admit(shape, blocks)
                if ticket.degrade:
                    degrade_deadline = (
                        time.monotonic() + self.serving.degrade_budget_s()
                    )
                t_parsed = time.perf_counter()
                # snapshot-watermark read (ref worker/oracle
                # MaxAssigned): the watermark is published only after a
                # commit batch's proposals are applied, and advances in
                # commit-ts order — reads at it skip the fresh-lease +
                # apply-barrier wait that serialized reads behind the
                # write pipeline (see api/server.py query)
                # the watermark is sampled ONCE and reused for both
                # the read ts and the result-cache key — see
                # api/server.py query for the TOCTOU this closes
                wm = self._snapshot_ts
                ts = (
                    read_ts
                    if read_ts is not None
                    else (wm or self.zero.zero.read_ts())
                )
                t_ts = time.perf_counter()
                # snapshot-keyed result reuse (serving/resultcache.py):
                # watermark reads are a pure function of (shape,
                # literals, watermark) — see api/server.py query for
                # the eligibility argument; cluster side additionally
                # refuses to CACHE partial (degraded-group) responses
                rc_key = None
                rc_probe = False
                raw_hit = None
                if read_ts is None:
                    rc_key, raw_hit, rc_probe = (
                        self.serving.result_probe(
                            shape, literals, None, keys.GALAXY_NS,
                            wm, debug,
                        )
                    )
                if raw_hit is not None:
                    from dgraph_tpu_torch.serving.resultcache import (
                        hit_response,
                    )

                    METRICS.inc("num_queries")
                    t_done = time.perf_counter()
                    if DIGESTS.enabled():
                        DIGESTS.record(
                            keys.GALAXY_NS, shape, t_done - t_start,
                            nbytes=len(raw_hit),
                            plan_hit=bool(parse_info.get("hit")),
                            result_hit=True,
                        )
                        digested = True
                    observe.note_tenant(
                        "query", keys.GALAXY_NS, t_done - t_ts
                    )
                    return hit_response(
                        raw_hit, want,
                        parsing_ns=int((t_parsed - t_start) * 1e9),
                        assign_ns=int((t_ts - t_parsed) * 1e9),
                        processing_ns=int((t_done - t_ts) * 1e9),
                        watermark=wm,
                    )
                cache = LocalCache(kv, ts, mem=self.mem)
                ex = Executor(
                    cache,
                    self.schema,
                    vector_indexes=self.vector_indexes,
                    stats=self.stats,
                    deadline=(
                        degrade_deadline
                        if degrade_deadline is not None
                        else None
                    ),
                    # caller-pinned read_ts never coalesces (the
                    # watermark argument covers only fresh timestamps
                    # that waited on the applied barrier)
                    batcher=(
                        self.serving.batcher_for(cache)
                        if read_ts is None
                        else None
                    ),
                )
                with TRACER.span("process"):
                    try:
                        nodes = ex.process(blocks)
                    except QueryBudgetError:
                        # only the degraded-admission budget converts a
                        # deadline trip into a partial result
                        if degrade_deadline is None:
                            raise
                        nodes = None
                        truncated = True
                t_processed = time.perf_counter()
                if truncated:
                    out = {"data": {}}
                else:
                    with TRACER.span("encode"):
                        data, enc_stats = encode_response_data(
                            nodes,
                            val_vars=ex.val_vars,
                            schema=self.schema,
                            want=want,
                        )
                    prof.encode.update(enc_stats)
                    out = {"data": data}
                t_done = time.perf_counter()
            METRICS.inc("num_queries")
            ext = out.setdefault("extensions", {})
            # encoding_ns is the wire-bytes production time (the A/B
            # quantity for BENCH_ENCODE.json); processing absorbs the
            # rest of the post-ts work — including the dict-API compat
            # parse-back, itemized as profile.encode.parse_ns — so the
            # parts still sum to total_ns with no unattributed gap
            enc_ns = int(prof.encode.get("encode_ns", 0))
            total_ns = int((t_done - t_start) * 1e9)
            ext["server_latency"] = {
                "parsing_ns": int((t_parsed - t_start) * 1e9),
                "assign_timestamp_ns": int((t_ts - t_parsed) * 1e9),
                "processing_ns": max(
                    int((t_done - t_ts) * 1e9) - enc_ns, 0
                ),
                "encoding_ns": enc_ns,
                "total_ns": total_ns,
            }
            if total_ns > 0 and prof.encode:
                prof.encode["share"] = round(enc_ns / total_ns, 4)
            ext["profile"] = prof.to_dict()
            if prof.plan is not None:
                prof.plan.plan_cache = parse_info or {}
                prof.plan.admission = {
                    "enabled": self.serving.admission.enabled(),
                    "cost": round(ticket.cost, 3),
                    "degrade": ticket.degrade,
                }
                if cache_base is not None:
                    now_tiers = cache_tier_snapshot(self.mem)
                    prof.plan.cache = {
                        k: now_tiers[k] - cache_base.get(k, 0)
                        for k in now_tiers
                    }
                prof.plan.planner = (
                    ex.planner.explain()
                    if ex.planner is not None
                    else {"enabled": False}
                )
                prof.plan.result_cache = {
                    "enabled": self.serving.results.capacity() > 0,
                    "eligible": rc_key is not None,
                    "would_hit": bool(rc_probe),
                    "watermark": int(self._snapshot_ts),
                }
                prof.plan.meta = {
                    "read_ts": int(ts),
                    "snapshot_watermark": int(self._snapshot_ts),
                    "wall_ns": total_ns,
                }
                ext["plan"] = prof.plan.to_dict()
            if root.trace_id:
                ext["trace_id"] = f"{root.trace_id:032x}"
            if ticket.degrade:
                ext["degraded_admission"] = True
            if kv.degraded_groups or truncated:
                METRICS.inc("degraded_queries_total")
                # no cache wipe needed: RemoteKV exposes no mut_seq, so
                # the MemoryLayer revalidates every entry against
                # kv.versions on each read — an empty list cached during
                # the outage heals itself on the first read after the
                # group returns
                ext["degraded"] = True
                ext["partial"] = True
                ext["unreachable_groups"] = sorted(kv.degraded_groups)
            elif kv.ctx is not None and kv.ctx.leaderless_gids:
                # served COMPLETE and byte-identical (every read came
                # from a watermark-verified replica) but one or more
                # groups had no leader — freshness is bounded by the
                # snapshot watermark, which cannot advance while the
                # group is leaderless. NOT partial: the data is whole.
                ext["degraded"] = "leaderless"
                ext["leaderless_groups"] = sorted(kv.ctx.leaderless_gids)
            if DIGESTS.enabled():
                data = out.get("data")
                nrows = (
                    sum(
                        len(v)
                        for v in data.values()
                        if isinstance(v, list)
                    )
                    if isinstance(data, dict)
                    else 0
                )
                DIGESTS.record(
                    keys.GALAXY_NS, shape, t_done - t_start,
                    rows=nrows,
                    nbytes=int(prof.encode.get("bytes", 0)),
                    error=truncated or bool(kv.degraded_groups),
                    plan_hit=bool(parse_info.get("hit")),
                    setop_pairs=int(
                        prof.events.get("setop_pairs_total", 0)
                    ),
                    setop_packed=int(
                        prof.events.get("setop_packed_total", 0)
                    ),
                )
                digested = True
            observe.note_tenant("query", keys.GALAXY_NS, t_done - t_ts)
            # slow records carry the digest shape key so a slow entry
            # joins its aggregate row in /debug/digests
            _slow_extra = {"shape": shape}
            if kv.degraded_groups:
                _slow_extra["degraded"] = sorted(kv.degraded_groups)
            slow = observe.maybe_log_slow(
                "query", q, (t_done - t_start) * 1e3, root,
                extra=_slow_extra,
            )
            completed = not truncated
            if (
                rc_key is not None
                and completed
                and not kv.degraded_groups  # never cache a partial view
                # leaderless-served results are byte-identical but the
                # window is short — stay conservative, don't cache
                and not (kv.ctx is not None and kv.ctx.leaderless_gids)
            ):
                raw = getattr(out.get("data"), "raw", None)
                if raw is not None:
                    self.serving.results.put(rc_key, raw)
            return out
        finally:
            # errors/sheds still count against their shape in the
            # digest store (errors are a first-class digest column)
            if not digested and DIGESTS.enabled():
                DIGESTS.record(
                    keys.GALAXY_NS, shape,
                    time.perf_counter() - t_start, error=True,
                )
            # only clean completions feed the shape cost EWMA: a shed,
            # error, or budget-truncated run's latency describes the
            # failure mode, not the shape — feeding it would decay the
            # estimated cost exactly when the gate depends on it
            self.serving.finish(
                ticket,
                shape if (ticket is not None and completed) else None,
                (time.perf_counter() - t_start) * 1e3,
                slow=slow,
            )

    # -- cluster observability (scrape + merge) -------------------------------

    def instance_labels(self) -> Dict[str, Tuple[str, int]]:
        """{instance_label: rpc_addr} for every spawned replica process
        (alpha-<id> / zero-<id>), coordinator excluded."""
        out: Dict[str, Tuple[str, int]] = {}
        for nid, cfg in self._cfgs.items():
            kind = (
                "zero"
                if cfg.get("_module", "").endswith("zero_process")
                else "alpha"
            )
            out[f"{kind}-{nid}"] = tuple(cfg["rpc_addr"])
        return out

    def _scrape_all(
        self, method: str, args=None, timeout: float = 2.0
    ) -> Tuple[Dict[str, object], List[str]]:
        """Call one debug RPC on every replica process — in PARALLEL,
        so an unreachable replica costs one timeout total, not one per
        position in a serial sweep (the operator probing an outage is
        exactly who cannot wait N x 2s). Returns ({instance: reply},
        [unreachable instances]). Degraded-scrape contract: a dead or
        partitioned replica yields a PARTIAL merge plus its name in
        the unreachable list — never an exception out of the
        aggregation path (regression: kill one alpha mid-scrape,
        tests/test_telemetry.py)."""
        labels = sorted(self.instance_labels().items())
        replies: Dict[str, object] = {}
        unreachable: List[str] = []

        def one(item):
            label, addr = item
            try:
                return label, self.pool.call(
                    addr, method, args, timeout=timeout
                )
            except (RpcError, OSError, TimeoutError):
                return label, None

        from concurrent.futures import ThreadPoolExecutor

        if labels:
            with ThreadPoolExecutor(
                max_workers=min(8, len(labels))
            ) as ex:
                for label, got in ex.map(one, labels):
                    if got is None:
                        METRICS.inc("metrics_scrape_errors_total")
                        unreachable.append(label)
                    else:
                        replies[label] = got
        return replies, unreachable

    def scrape_metrics(self) -> Dict[str, str]:
        """One Prometheus exposition text per cluster process — every
        replica via its debug.metrics RPC plus this coordinator's own
        registry under the "client" label. Unreachable instances are
        skipped and counted (metrics_scrape_errors_total)."""
        return self.scrape_metrics_ex()[0]

    def scrape_metrics_ex(self) -> Tuple[Dict[str, str], List[str]]:
        replies, unreachable = self._scrape_all("debug.metrics")
        texts: Dict[str, str] = {"client": METRICS.render()}
        for label, got in replies.items():
            texts[label] = got["text"]
        return texts, unreachable

    def merged_metrics(self, with_meta: bool = False):
        """The cluster-wide /debug/prometheus_metrics body: counters
        summed, histogram buckets merged, per-instance labels kept.
        `with_meta=True` returns (text, unreachable_instances) — the
        partial-merge contract when replicas are down."""
        texts, unreachable = self.scrape_metrics_ex()
        merged = observe.merge_expositions(texts)
        if with_meta:
            return merged, unreachable
        return merged

    def merged_traces(self, n: int = 200, with_meta: bool = False):
        """Recent spans across every cluster process, tagged with the
        instance that emitted them (the /debug/traces aggregation).
        `with_meta=True` returns (spans, unreachable_instances)."""
        spans = [
            dict(s, instance="client") for s in TRACER.recent(n)
        ]
        replies, unreachable = self._scrape_all("debug.traces", {"n": n})
        for label, got in replies.items():
            spans.extend(dict(s, instance=label) for s in got["spans"])
        spans.sort(key=lambda s: s.get("start") or 0)
        if with_meta:
            return spans, unreachable
        return spans

    def merged_tablets(self) -> dict:
        """Cluster-wide per-tablet traffic: every replica's
        debug.tablets rows plus the coordinator's own accumulator,
        summed by (ns, predicate) with a read-weighted EWMA average —
        the /debug/tablets aggregation and the traffic-driven
        rebalancer's input. Partial on replica outage, with the dead
        instances named in unreachable_instances."""
        observe.TABLETS.publish()
        per_instance = [("client", observe.TABLETS.snapshot())]
        replies, unreachable = self._scrape_all("debug.tablets")
        for label, got in replies.items():
            per_instance.append((label, got.get("tablets", [])))
        return {
            "tablets": merge_tablet_rows(
                [rows for _label, rows in per_instance]
            ),
            "instances": [label for label, _rows in per_instance],
            "unreachable_instances": unreachable,
        }

    def merged_digests(self) -> dict:
        """Cluster-wide query digest rows: every replica's
        debug.digests snapshot plus the coordinator's own store, summed
        by (ns, shape) bucket-wise — so merged call counts equal the
        sum of per-process scrapes (the `dgraph-tpu top` body). Partial
        on replica outage, dead instances named."""
        from dgraph_tpu_torch.serving.digest import DIGESTS, merge_rows

        per_instance = [("client", DIGESTS.snapshot())]
        replies, unreachable = self._scrape_all("debug.digests")
        for label, got in replies.items():
            per_instance.append((label, got.get("digests", [])))
        return {
            "digests": merge_rows(
                [rows for _label, rows in per_instance]
            ),
            "instances": [label for label, _rows in per_instance],
            "unreachable_instances": unreachable,
        }

    def merged_history(self, window_s: float = 600.0) -> dict:
        """Cluster-wide windowed metrics deltas: each process's history
        report kept per-instance (per-process rings don't share a
        clock) plus one cluster sum of the counter deltas — "what
        changed in the last N seconds, cluster-wide". Partial on
        replica outage, dead instances named."""
        per_instance = {"client": observe.HISTORY.report(window_s)}
        replies, unreachable = self._scrape_all(
            "debug.history", {"window": float(window_s)}
        )
        for label, got in replies.items():
            per_instance[label] = {
                k: v for k, v in got.items() if k != "instance"
            }
        summed: Dict[str, float] = {}
        for rep in per_instance.values():
            for k, v in (rep.get("deltas") or {}).items():
                summed[k] = summed.get(k, 0.0) + v
        return {
            "window_s": float(window_s),
            "history": per_instance,
            "deltas": summed,
            "instances": sorted(per_instance),
            "unreachable_instances": unreachable,
        }

    def debug_bundle(self, window_s: float = 600.0) -> dict:
        """Everything an operator needs to diagnose the cluster after
        the fact, in one dict (the `dgraph-tpu debug-bundle` body):
        merged metrics, digests, a history window, health, traces,
        tablets, the slow-query log, the static lock graph, and the
        resolved config. Built on the degraded-scrape machinery — a
        dead alpha yields a partial bundle plus its name in
        unreachable_instances, never a raise."""
        metrics, m_unreach = self.merged_metrics(with_meta=True)
        digests = self.merged_digests()
        history = self.merged_history(window_s)
        traces, t_unreach = self.merged_traces(with_meta=True)
        tablets = self.merged_tablets()
        health = self.health()
        slow: List[dict] = []
        log = observe.slow_query_log()
        if log is not None:
            try:
                with open(log.path) as f:
                    slow = [
                        json.loads(line)
                        for line in f
                        if line.strip()
                    ]
            except (OSError, ValueError):
                slow = []
        lock_edges: List[dict] = []
        try:
            from dgraph_tpu_torch.analysis import load_sources, package_root
            from dgraph_tpu_torch.analysis.check_lockorder import lock_graph

            for (outer, inner), (path, line, kind) in sorted(
                lock_graph(load_sources(package_root())).items()
            ):
                lock_edges.append(
                    {
                        "outer": outer,
                        "inner": inner,
                        "path": path,
                        "line": line,
                        "kind": kind,
                    }
                )
        except Exception as e:  # analyzer absence must not sink a bundle
            lock_edges = [{"error": f"{type(e).__name__}: {e}"}]
        unreachable = sorted(
            set(m_unreach)
            | set(t_unreach)
            | set(digests.get("unreachable_instances") or [])
            | set(history.get("unreachable_instances") or [])
            | set(tablets.get("unreachable_instances") or [])
            | set(health.get("unreachable_instances") or [])
        )
        return {
            "generated_ts": time.time(),
            "window_s": float(window_s),
            "unreachable_instances": unreachable,
            "metrics": metrics,
            "digests": digests,
            "history": history,
            "health": health,
            "traces": traces,
            "tablets": tablets,
            "slow_queries": slow,
            "lock_graph": lock_edges,
            "config": config.resolved(),
        }

    def health(self) -> dict:
        """The cluster health/SLO rollup behind `dgraph-tpu health`:
        the coordinator's own healthz (admission rates, commit pipeline
        depth, SLO burn windows) plus per-group raft state — leader
        presence and per-replica applied-index lag from the health RPC
        every alpha already serves — snapshot-watermark lag, and each
        replica process's healthz via debug.health."""
        out = observe.healthz("client")
        # probe every replica of every group in one parallel sweep (a
        # dead replica costs one timeout total, not one per position)
        all_addrs = [
            (gid, addr)
            for gid, rg in sorted(self.remote_groups.items())
            for addr in rg.addrs
        ]

        def probe(item):
            gid, addr = item
            try:
                return gid, addr, self.pool.call(
                    addr, "health", timeout=2.0
                )
            except (RpcError, OSError, TimeoutError):
                return gid, addr, None

        from concurrent.futures import ThreadPoolExecutor

        probed = []
        if all_addrs:
            with ThreadPoolExecutor(
                max_workers=min(8, len(all_addrs))
            ) as ex:
                probed = list(ex.map(probe, all_addrs))
        groups: Dict[str, dict] = {}
        for gid in sorted(self.remote_groups):
            replicas = {}
            leader_applied = 0
            leader = None
            for pgid, addr, h in probed:
                if pgid != gid:
                    continue
                if h is None:
                    replicas[f"{addr[0]}:{addr[1]}"] = {"ok": False}
                    continue
                nid = int(getattr(h, "node", 0))
                applied = int(getattr(h, "applied", 0))
                is_leader = bool(getattr(h, "is_leader", False))
                if is_leader:
                    leader = nid
                    leader_applied = max(leader_applied, applied)
                replicas[str(nid)] = {
                    "ok": True,
                    "is_leader": is_leader,
                    "term": int(getattr(h, "term", 0)),
                    "applied": applied,
                }
            for r in replicas.values():
                if r.get("ok"):
                    r["applied_lag"] = max(
                        0, leader_applied - r["applied"]
                    )
            groups[str(gid)] = {
                "leader": leader,
                "healthy": leader is not None,
                "replicas": replicas,
            }
        out["groups"] = groups
        out["snapshot_watermark"] = int(self._snapshot_ts)
        # watermark lag: how far the serving snapshot trails the newest
        # leased timestamp (in-flight commits). Only the local ZeroLite
        # exposes max_assigned without a consensus round; omitted on a
        # remote Zero quorum.
        ma = getattr(self.zero.zero, "max_assigned", None)
        if isinstance(ma, (int, float)):
            out["watermark_lag"] = max(0, int(ma) - self._snapshot_ts)
        replies, unreachable = self._scrape_all("debug.health")
        out["processes"] = {
            label: got for label, got in sorted(replies.items())
        }
        # cluster-wide per-tenant traffic rollup from the merged tablet
        # rows (the per-tenant SLO slices ride in each process's
        # healthz "tenants" section above)
        merged = self.merged_tablets()
        traffic: Dict[str, dict] = {}
        for r in merged["tablets"]:
            t = traffic.setdefault(
                str(r["ns"]),
                {
                    "reads": 0,
                    "read_uids": 0,
                    "mutation_edges": 0,
                    "result_bytes": 0,
                },
            )
            t["reads"] += r["reads"]
            t["read_uids"] += r["read_uids"]
            t["mutation_edges"] += r["mutation_edges"]
            t["result_bytes"] += r["result_bytes"]
        if traffic:
            out["tenant_traffic"] = traffic
        unreachable = sorted(
            set(unreachable) | set(merged["unreachable_instances"])
        )
        out["unreachable_instances"] = unreachable
        if unreachable or any(
            not g["healthy"] for g in groups.values()
        ):
            out["status"] = "degraded"
        return out
