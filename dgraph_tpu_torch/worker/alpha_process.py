"""Standalone Alpha replica process (ref dgraph/cmd/alpha + worker/).

One OS process hosts ONE raft replica of ONE group:

  - raft transport among the group's replicas over TcpNetwork
  - an RpcServer exposing the ServeTask-style surface:
      kv.get / kv.versions / kv.iterate / kv.iterate_versions  (reads,
        worker/task.go:123 analog — the coordinator routes by tablet)
      propose  (proposal forwarding: leader appends + waits for local
        apply, worker/proposal.go proposeAndWait)
      health   (leader/term/applied heartbeat probe)
  - durable KV WAL + raft WAL under --data-dir (restart-safe)

Run: python -m dgraph_tpu_torch.worker.alpha_process <config.json>
config: {"node_id": 1, "group_id": 1, "replica_ids": [1,2,3],
         "raft_addrs": {"1": ["127.0.0.1", p1], ...},
         "rpc_addr": ["127.0.0.1", p], "data_dir": "..." | null}
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from dgraph_tpu_torch.conn.messages import (
    KV,
    GetRequest,
    GetResponse,
    HealthInfo,
    IterateRequest,
    KVList,
    Proposal,
    ProposalResponse,
)
from dgraph_tpu_torch.conn.rpc import RpcServer
from dgraph_tpu_torch.raft.raft import RaftNode
from dgraph_tpu_torch.raft.tcp import TcpNetwork
from dgraph_tpu_torch.raft.wal import RaftWal
from dgraph_tpu_torch.storage.kv import MemKV


def _as_tuple_data(data):
    """JSON turns tuples into lists; normalize a proposal back into the
    (kind, payload) shape the apply function expects."""
    if isinstance(data, (list, tuple)) and len(data) == 2:
        kind, payload = data
        if kind == "delta":
            payload = [(bytes(k), int(ts), bytes(v)) for k, ts, v in payload]
        elif kind == "drop":
            payload = bytes(payload)
        return (kind, payload)
    return tuple(data) if isinstance(data, list) else data


class AlphaProcess:
    def __init__(self, cfg: dict):
        self.node_id = int(cfg["node_id"])
        self.group_id = int(cfg["group_id"])
        self.replica_ids = [int(x) for x in cfg["replica_ids"]]
        raft_addrs = {int(k): tuple(v) for k, v in cfg["raft_addrs"].items()}
        data_dir: Optional[str] = cfg.get("data_dir")

        raft_wal = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self.kv = MemKV(
                wal_path=os.path.join(data_dir, f"kv_{self.node_id}.wal")
            )
            # default True: hardstate/entries must hit disk before vote/
            # append responses leave the node or power loss can un-vote us
            # (raft §5). Tests pass wal_sync=False (process-crash model).
            raft_wal = RaftWal(
                os.path.join(data_dir, f"raft_{self.node_id}"),
                sync=bool(cfg.get("wal_sync", True)),
            )
        else:
            self.kv = MemKV()

        self.applied_index = 0
        self.net = TcpNetwork(raft_addrs)
        self.net.register(self.node_id)
        self.raft = RaftNode(
            self.node_id,
            self.replica_ids,
            self.net,
            self._apply,
            wal=raft_wal,
            snapshot_cb=self.kv.dump_bytes,
            restore_cb=self._restore,
            compact_every=int(cfg.get("compact_every", 0)),
            # real-time ticks: slower timeouts than the virtual-clock tests
            election_timeout=(400, 800),
            heartbeat=100,
        )
        self.applied_index = self.raft.last_applied
        self._apply_cv = threading.Condition()

        host, port = cfg["rpc_addr"]
        self.rpc = RpcServer(
            host, int(port), instance=f"alpha-{self.node_id}"
        )
        self._register_handlers()
        from dgraph_tpu_torch.utils.observe import attach_debug_surface

        self._debug_http, self.debug_port = attach_debug_surface(self.rpc)
        self._stop = threading.Event()

    # -- state machine --------------------------------------------------------

    def _apply(self, idx: int, data):
        kind, payload = _as_tuple_data(data)
        if kind == "delta":
            self.kv.put_batch(payload)
        elif kind == "drop":
            self.kv.drop_prefix(payload)
        # "noop": leader's term-start entry — nothing to apply
        with self._apply_cv:
            self.applied_index = idx
            self._apply_cv.notify_all()

    def _restore(self, data: bytes, idx: int):
        self.kv.load_bytes(data)
        with self._apply_cv:
            self.applied_index = idx
            self._apply_cv.notify_all()

    # -- RPC surface ----------------------------------------------------------

    def _register_handlers(self):
        r = self.rpc.register
        r("health", self._h_health)
        r("kv.get", self._h_get)
        r("kv.versions", self._h_versions)
        r("kv.iterate", self._h_iterate)
        r("kv.iterate_versions", self._h_iterate_versions)
        r("kv.prefix_size", self._h_prefix_size)
        r("propose", self._h_propose)
        from dgraph_tpu_torch.conn.messages import Ack

        r("take_snapshot", lambda a: self.raft.take_snapshot() or Ack(ok=True))

    def _h_health(self, a):
        return HealthInfo(
            ok=True,
            node=self.node_id,
            group=self.group_id,
            is_leader=self.raft.is_leader(),
            term=self.raft.term,
            applied=self.applied_index,
        )

    def _h_get(self, a: GetRequest):
        got = self.kv.get(a.key, a.ts)
        if got is None:
            return GetResponse(found=False)
        return GetResponse(found=True, ts=got[0], value=got[1])

    def _h_versions(self, a: GetRequest):
        return KVList(
            kv=[
                KV(ts=ts, value=v)
                for ts, v in self.kv.versions(a.key, a.ts)
            ]
        )

    def _h_iterate(self, a: IterateRequest):
        return KVList(
            kv=[
                KV(key=k, ts=ts, value=v)
                for k, ts, v in self.kv.iterate(a.prefix, a.ts)
            ]
        )

    def _h_iterate_versions(self, a: IterateRequest):
        # flat KVList; consecutive same-key runs group client-side
        # (the stream shape of pb.KVS). Paging (after/max_bytes) and
        # the since-ts filter bound one response frame — the tablet
        # mover streams tablets larger than the frame cap in chunks.
        # The cursor SEEKS (bisect in MemKV) so N pages cost one scan
        # total, not N re-scans of everything already sent.
        out = []
        size = 0
        more = False
        try:
            it = self.kv.iterate_versions(a.prefix, a.ts, after=a.after)
        except TypeError:  # backend without seek support
            it = self.kv.iterate_versions(a.prefix, a.ts)
        for k, vers in it:
            if a.after and k <= a.after:
                continue
            if a.since:
                vers = [(ts, v) for ts, v in vers if ts > a.since]
                if not vers:
                    continue
            if a.max_bytes and size >= a.max_bytes:
                more = True  # truncated at a key boundary; resume here
                break
            for ts, v in vers:
                out.append(KV(key=k, ts=ts, value=v))
                size += len(k) + len(v) + 16
        return KVList(kv=out, more=more)

    def _h_prefix_size(self, a: IterateRequest):
        """Record bytes under a prefix, summed server-side — the
        rebalancer's tablet-size signal (ref draft.go
        calculateTabletSizes). One small reply instead of streaming
        the whole tablet over the wire just to count it."""
        total = 0
        for _k, vers in self.kv.iterate_versions(a.prefix, a.ts):
            for _ts, v in vers:
                total += len(v)
        return {"bytes": total}

    def _h_propose(self, a: Proposal):
        """Leader-only append + wait-for-apply (proposeAndWait). Non-leaders
        answer with a leader hint so the coordinator retries there."""
        from dgraph_tpu_torch.conn.frame import unpack_body

        req = unpack_body(a.data)
        data = _as_tuple_data(req["data"])
        if not self.raft.propose(data):
            return ProposalResponse(
                ok=False, error="not leader",
                leader_hint=self.raft.leader_id or 0,
            )
        target = self.raft.last_index()
        deadline = time.time() + float(req.get("timeout", 10.0))
        with self._apply_cv:
            while self.applied_index < target:
                if not self._apply_cv.wait(timeout=0.1):
                    if time.time() > deadline:
                        return ProposalResponse(ok=False, error="timeout")
        return ProposalResponse(ok=True, index=target)

    # -- lifecycle ------------------------------------------------------------

    def run_forever(self):
        self.rpc.start()
        now = 0
        while not self._stop.is_set():
            now += 20
            self.raft.tick(now)
            time.sleep(0.005)

    def stop(self):
        self._stop.set()
        self.rpc.close()
        self.net.close()
        if self.raft.wal is not None:
            self.raft.wal.close()
        self.kv.close()


def main():
    with open(sys.argv[1]) as f:
        cfg = json.load(f)
    from dgraph_tpu_torch.conn import faults
    from dgraph_tpu_torch.utils import observe

    # per-process span sink (DGRAPH_TPU_TRACE_SINK directory inherited
    # from the coordinator): one spans-alpha-<id>.jsonl per replica
    observe.init_from_env(instance=f"alpha-{cfg.get('node_id')}")
    plan = faults.init_from_env()
    if plan is not None:
        # chaos runs must be auditable: announce the inherited schedule
        print(
            f"[faults] alpha {cfg.get('node_id')}: chaos plan active "
            f"seed={plan.seed} rules={len(plan.rules)}",
            file=sys.stderr, flush=True,
        )
    proc = AlphaProcess(cfg)
    try:
        proc.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        proc.stop()


if __name__ == "__main__":
    main()
