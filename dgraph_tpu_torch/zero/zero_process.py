"""Standalone Zero replica process (ref dgraph/cmd/zero run.go: the Zero
quorum as its own servers).

One OS process hosts one Zero raft member: the deterministic coordinator
state machine (zero/replicated.py), TCP raft among the quorum, a raft
WAL, and an RPC surface the cluster coordinator calls:

  zero.exec  {kind, args} — leader-only: propose the op, wait for local
             apply, return the deterministic result (non-leaders answer
             {not_leader: true})
  zero.state — {is_leader, term, max_ts, max_uid, tablets}

Run: python -m dgraph_tpu_torch.zero.zero_process <config.json>
config: {"node_id": 901, "replica_ids": [901,902,903],
         "raft_addrs": {"901": ["127.0.0.1", p], ...},
         "rpc_addr": ["127.0.0.1", p], "data_dir": "..."|null,
         "n_groups": 2}
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from dgraph_tpu_torch.conn.rpc import RpcServer
from dgraph_tpu_torch.raft.raft import RaftNode
from dgraph_tpu_torch.raft.tcp import TcpNetwork
from dgraph_tpu_torch.raft.wal import RaftWal
from dgraph_tpu_torch.zero.replicated import ZeroStateMachine


class ZeroProcess:
    def __init__(self, cfg: dict):
        self.node_id = int(cfg["node_id"])
        self.replica_ids = [int(x) for x in cfg["replica_ids"]]
        raft_addrs = {int(k): tuple(v) for k, v in cfg["raft_addrs"].items()}
        data_dir: Optional[str] = cfg.get("data_dir")
        self.sm = ZeroStateMachine()
        self.sm.n_groups = int(cfg.get("n_groups", 1))
        wal = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            wal = RaftWal(
                os.path.join(data_dir, f"zeroraft_{self.node_id}"),
                sync=bool(cfg.get("wal_sync", True)),
            )
        self.net = TcpNetwork(raft_addrs)
        self.net.register(self.node_id)
        self._apply_cv = threading.Condition()
        self.raft = RaftNode(
            self.node_id,
            self.replica_ids,
            self.net,
            self._apply,
            wal=wal,
            snapshot_cb=self.sm.dump,
            restore_cb=lambda blob, idx: self.sm.load(blob),
            compact_every=int(cfg.get("compact_every", 2048)),
            election_timeout=(400, 800),
            heartbeat=100,
        )
        self._req_id = 0
        host, port = cfg["rpc_addr"]
        self.rpc = RpcServer(
            host, int(port), instance=f"zero-{self.node_id}"
        )
        self.rpc.register("zero.exec", self._h_exec)
        self.rpc.register("zero.state", self._h_state)
        from dgraph_tpu_torch.utils.observe import attach_debug_surface

        self._debug_http, self.debug_port = attach_debug_surface(self.rpc)
        self._stop = threading.Event()

    def _apply(self, idx: int, data):
        with self._apply_cv:
            self.sm.apply(tuple(data) if isinstance(data, list) else data)
            self._apply_cv.notify_all()

    def _h_state(self, a):
        from dgraph_tpu_torch.conn.messages import ZeroState

        return ZeroState(
            state_json=json.dumps(
                {
                    "is_leader": self.raft.is_leader(),
                    "term": self.raft.term,
                    "max_ts": self.sm.max_ts,
                    "max_uid": self.sm.max_uid,
                    "tablets": self.sm.tablets,
                    "moves": self.sm.moves,
                }
            ).encode()
        )

    def _h_exec(self, m):
        """Leader-only propose + wait (the coordinator's consensus op)."""
        from dgraph_tpu_torch.conn.messages import ZeroExec

        if isinstance(m, ZeroExec):
            a = json.loads(m.args_json)
            kind = m.op  # the typed field is authoritative
        else:
            a = m
            kind = a["kind"]
        if not self.raft.is_leader():
            return {"not_leader": True, "hint": self.raft.leader_id}
        with self._apply_cv:
            self._req_id += 1
            rid = self._req_id
        if (
            isinstance(m, ZeroExec)
            and m.commit_batch is not None
            and m.commit_batch.txns
        ):
            # typed batched-commit body (group commit): the nested
            # (start_ts, cks-list) shape never rides args_json, so the
            # scalar-list normalizer below can't mangle it
            args = [
                {
                    "b": [
                        [int(t.start_ts), [int(c) for c in t.cks]]
                        for t in m.commit_batch.txns
                    ]
                }
            ]
        else:
            args = a.get("args") or []
            # JSON round-trip turns tuples/ints-as-keys; normalize args
            args = [
                [int(x) for x in v] if isinstance(v, list) else v
                for v in args
            ]
        op = (kind, self.node_id, rid, *args)
        if not self.raft.propose(op):
            return {"not_leader": True, "hint": self.raft.leader_id}
        key = (self.node_id, rid)
        deadline = time.time() + float(a.get("timeout", 10.0))
        with self._apply_cv:
            while key not in self.sm.results:
                if not self._apply_cv.wait(timeout=0.1) and time.time() > deadline:
                    return {"timeout": True}
        out = self.sm.results[key]
        return {"ok": True, "result": out}

    def run_forever(self):
        self.rpc.start()
        now = 0
        while not self._stop.is_set():
            now += 20
            self.raft.tick(now)
            # apply_cb runs inside tick; wake exec waiters even when the
            # apply happened on this tick thread
            time.sleep(0.005)

    def stop(self):
        self._stop.set()
        self.rpc.close()
        self.net.close()
        if self.raft.wal is not None:
            self.raft.wal.close()


def main():
    with open(sys.argv[1]) as f:
        cfg = json.load(f)
    from dgraph_tpu_torch.conn import faults
    from dgraph_tpu_torch.utils import observe

    observe.init_from_env(instance=f"zero-{cfg.get('node_id')}")
    plan = faults.init_from_env()
    if plan is not None:
        print(
            f"[faults] zero {cfg.get('node_id')}: chaos plan active "
            f"seed={plan.seed} rules={len(plan.rules)}",
            file=sys.stderr, flush=True,
        )
    proc = ZeroProcess(cfg)
    try:
        proc.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        proc.stop()


if __name__ == "__main__":
    main()
