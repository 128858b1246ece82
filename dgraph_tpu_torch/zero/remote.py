"""Coordinator-side client for an OS-process Zero quorum.

Same ZeroLite-compatible face as zero/replicated.ReplicatedZero, but the
quorum members are zero_process.py servers reached over conn/rpc —
leases, commit verdicts and tablet decisions are zero.exec RPCs routed to
the Zero leader with not-leader retry (ref the alphas' Zero gRPC client,
worker/zero.go).
"""

from __future__ import annotations

import threading
import json
import time
from typing import Dict, List, Optional, Set, Tuple

from dgraph_tpu_torch.conn.retry import RetryPolicy, effective_deadline
from dgraph_tpu_torch.conn.rpc import RpcError, RpcPool
from dgraph_tpu_torch.zero.zero import TxnConflictError


class RemoteZero:
    TS_BLOCK = 128
    retry = RetryPolicy(base=0.02, cap=0.5)

    def __init__(self, rpc_addrs: List[Tuple[str, int]], pool: RpcPool):
        self.addrs = [tuple(a) for a in rpc_addrs]
        self.pool = pool
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._ts_next = 0
        self._ts_end = -1
        self._floor = 0
        self._active: Set[int] = set()
        self._pending: Set[int] = set()
        self._leader: Optional[Tuple[str, int]] = None

    # -- rpc plumbing --------------------------------------------------------

    def _state(self, addr) -> dict:
        got = self.pool.call(addr, "zero.state", timeout=2.0)
        return json.loads(got.state_json)

    def _exec(self, kind: str, *args, timeout: float = 15.0, batch=None):
        """Leader-routed Zero op. Runs under the ambient deadline (see
        conn/retry.py), retries with full-jitter backoff instead of a
        fixed 50ms sleep, and sends `idem=True`: a reconnect-and-resend
        of a lease/commit/abort dedupes in the server's idempotency LRU
        rather than re-proposing (a double-applied commit could flip a
        verdict; a double-applied lease leaks a block). `batch` carries
        the typed ZeroCommitBatch body of the batched commit op."""
        dl = effective_deadline(timeout)
        last = "no zero leader"
        attempt = 0
        while not dl.expired():
            order = (
                [self._leader] + [a for a in self.addrs if a != self._leader]
                if self._leader
                else list(self.addrs)
            )
            wait_s = dl.clamp(5.0, floor=0.1)
            for addr in order:
                try:
                    from dgraph_tpu_torch.conn.messages import ZeroExec

                    out = self.pool.call(
                        addr,
                        "zero.exec",
                        ZeroExec(
                            op=kind,
                            args_json=json.dumps(
                                {"args": list(args), "timeout": wait_s}
                            ).encode(),
                            commit_batch=batch,
                        ),
                        timeout=wait_s + 3.0,
                        idem=True,
                        deadline=dl,
                    )
                except RpcError as e:
                    last = str(e)
                    continue
                if out.get("ok"):
                    self._leader = addr
                    return out["result"]
                if out.get("not_leader"):
                    self._leader = None
                last = f"{addr}: {out}"
            attempt += 1
            self.retry.sleep(attempt, dl)
        raise TimeoutError(f"zero.exec {kind} failed: {last}")

    # -- ZeroLite face -------------------------------------------------------

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
            first = self._exec("lease_ts", self.TS_BLOCK)
            with self._lock:
                self._ts_next = first + 1
                self._ts_end = first + self.TS_BLOCK - 1
                return first
        return self._exec("lease_ts", count)

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
        return self._exec("lease_uid", count)

    @property
    def max_assigned(self) -> int:
        for addr in self.addrs:
            try:
                return int(self._state(addr)["max_ts"])
            except RpcError:
                continue
        return 0

    @property
    def _max_uid(self) -> int:
        for addr in self.addrs:
            try:
                return int(
                    self._state(addr)["max_uid"]
                )
            except RpcError:
                continue
        return 1

    def commit(self, start_ts: int, conflict_keys, track: bool = False) -> int:
        verdict = self._exec("commit", start_ts, sorted(conflict_keys))
        with self._lock:
            self._active.discard(start_ts)
        if verdict[0] == "abort":
            with self._lock:
                self._floor = max(self._floor, int(verdict[1]))
            raise TxnConflictError(
                f"conflict (committed at {verdict[1]} > start {start_ts})"
            )
        commit_ts = int(verdict[1])
        with self._lock:
            self._floor = max(self._floor, commit_ts)
            if track:
                self._pending.add(commit_ts)
        return commit_ts

    def commit_batch(self, items, track: bool = False):
        """ONE zero.exec round trip deciding N txns (the group-commit
        oracle exchange): verdicts come back per member, so an aborted
        member never fails its batchmates. The batch body rides typed
        (conn/messages.ZeroCommitBatch), not through args_json."""
        from dgraph_tpu_torch.conn.messages import ZeroCommitBatch, ZeroCommitReq

        batch = ZeroCommitBatch(
            txns=[
                ZeroCommitReq(
                    start_ts=int(s),
                    cks=sorted(int(c) for c in cks),
                )
                for s, cks in items
            ]
        )
        verdicts = self._exec("commit_batch", batch=batch)
        with self._lock:
            for (s, _), v in zip(items, verdicts):
                self._active.discard(int(s))
                if int(v[1]):
                    self._floor = max(self._floor, int(v[1]))
                if v[0] == "commit" and track:
                    self._pending.add(int(v[1]))
        return [tuple(v) for v in verdicts]

    def applied(self, commit_ts: int):
        with self._cv:
            self._pending.discard(commit_ts)
            self._cv.notify_all()

    def abort(self, start_ts: int):
        with self._lock:
            self._active.discard(start_ts)
        try:
            self._exec("abort", start_ts, timeout=3.0)
        except TimeoutError:
            pass

    # -- tablet ops ----------------------------------------------------------

    def should_serve(self, pred: str) -> int:
        return int(self._exec("tablet", pred))

    def move_tablet(self, pred: str, gid: int):
        self._exec("move_tablet", pred, int(gid))

    # -- move journal (worker/tabletmove.py phase driver) --------------------

    def move_begin(self, pred: str, src: int, dst: int, read_ts: int):
        self._exec("move_begin", pred, int(src), int(dst), int(read_ts))

    def move_fence(self, pred: str):
        self._exec("move_fence", pred)

    def move_flip(self, pred: str):
        self._exec("move_flip", pred)

    def move_clear(self, pred: str):
        self._exec("move_clear", pred)

    @property
    def moves(self) -> Dict[str, dict]:
        # linearizable (leader-routed raft op): journal reads drive
        # destructive recovery — a follower's stale state could roll
        # back a move whose flip already committed
        return {
            p: dict(m) for p, m in self._exec("moves").items()
        }

    @property
    def tablets(self) -> Dict[str, int]:
        for addr in self.addrs:
            try:
                return dict(
                    self._state(addr)["tablets"]
                )
            except RpcError:
                continue
        return {}
