"""Deterministic fault injection for the cross-process cluster stack.

The reference proves its failure handling with Jepsen-style chaos
(systest/bank, conn/pool.go MonitorHealth recovering from flapping
peers). This module is the injection half of that story for dgraph-tpu:
a process-wide, seedable `FaultPlan` that the transports consult at
well-defined points —

  send       RpcClient, before a request frame leaves
  recv       RpcServer, on request receipt (before the handler runs)
  resp       RpcServer, before the response frame is written (a `drop`
             here models "applied but the ack was lost", the classic
             double-apply trap the idempotency LRU exists for)
  raft_send  raft/tcp.py TcpNetwork.send, per remote peer
  raft_recv  raft/tcp.py listener, per remote sender
  move.*     named in-code sync points at the tablet-move phase
             boundaries (worker/tabletmove.py via `syncpoint`): crash
             rules simulate coordinator death at exactly that boundary
             (InjectedCrash), delay rules stretch a phase
  backup.*   the backup coordinator's journaled phase boundaries
             (worker/backupdriver.py: backup.begin/group/manifest)
  cdc.*      the CDC emitter's sink-write/checkpoint boundaries
             (admin/cdc.py: cdc.emit/cdc.checkpoint — a crash here
             simulates sink death inside the at-least-once window)

Actions: drop | delay | dup | disconnect | partition | crash.
`crash` only fires at named sync points. `partition` is a
deterministic directional block (see `FaultPlan.partition`); the rest
fire probabilistically but DETERMINISTICALLY: each (point, peer) pair
is a stream with its own monotonic counter, and the n-th decision of a
stream is a pure hash of (seed, rule, stream, n) — independent of
thread scheduling, so the same seed reproduces the same per-stream
fault sequence byte-for-byte across runs (`replay` verifies this).

Activation: programmatic `install(plan)` / `reset()`, or the
`DGRAPH_TPU_FAULT_PLAN` env var (a JSON spec, or `@/path/to/spec.json`)
which child alpha/zero processes inherit from the harness. Every
injected fault increments `fault_<action>_total` / `faults_injected_total`
in utils/observe.METRICS and lands in a bounded audit log, so chaos
runs are auditable after the fact.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.utils.observe import METRICS

_ACTIONS = ("drop", "delay", "dup", "disconnect", "partition", "crash")
_OUTBOUND = ("send", "raft_send")


class InjectedCrash(RuntimeError):
    """A `crash` rule fired at a named sync point: the in-process
    simulation of the coordinator dying at exactly that boundary (the
    tablet-move chaos suite drives one of these at every journaled
    phase transition). Callers must NOT catch this to clean up — a real
    SIGKILL would not have run the cleanup either; recovery code has to
    heal from the durable journal alone."""


def _peer_str(peer) -> str:
    if isinstance(peer, (tuple, list)) and len(peer) == 2:
        return f"{peer[0]}:{peer[1]}"
    return str(peer)


class FaultRule:
    """One match+action clause of a plan."""

    __slots__ = (
        "action", "point", "peer", "method", "p", "delay_ms", "after",
        "max", "fired",
    )

    def __init__(
        self,
        action: str,
        point: str = "*",
        peer: str = "*",
        method: str = "*",
        p: float = 1.0,
        delay_ms: float = 0.0,
        after: int = 0,
        max: int = 0,
    ):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        self.action = action
        self.point = point
        self.peer = _peer_str(peer) if peer != "*" else "*"
        self.method = method
        self.p = float(p)
        self.delay_ms = float(delay_ms)
        self.after = int(after)  # skip the first N decisions of a stream
        self.max = int(max)      # total fires across all streams (0 = inf)
        self.fired = 0

    @property
    def delay_s(self) -> float:
        return self.delay_ms / 1000.0

    def matches(self, point: str, peer: str, method: str) -> bool:
        return (
            self.point in ("*", point)
            and self.peer in ("*", peer)
            and self.method in ("*", method)
        )

    def to_dict(self) -> dict:
        return {
            "action": self.action, "point": self.point, "peer": self.peer,
            "method": self.method, "p": self.p, "delay_ms": self.delay_ms,
            "after": self.after, "max": self.max,
        }


class _Partition(FaultRule):
    """Synthetic rule returned for a blocked (partitioned) peer."""

    def __init__(self):
        super().__init__("partition")


_PARTITION = _Partition()


class FaultPlan:
    """Seeded, process-wide fault schedule. Thread-safe."""

    def __init__(self, seed: int = 0, rules: Optional[List[dict]] = None,
                 log_cap: int = 4096):
        self.seed = int(seed)
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r)
            for r in (rules or [])
        ]
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._blocked: set = set()  # ("to"|"from", peer_str)
        self.log: deque = deque(maxlen=log_cap)

    # -- partitions ------------------------------------------------------

    def partition(self, peer, direction: str = "both"):
        """Deterministically block traffic with `peer`. direction:
        "to" (we stop sending), "from" (we stop receiving), "both"."""
        p = _peer_str(peer)
        with self._lock:
            if direction in ("to", "both"):
                self._blocked.add(("to", p))
            if direction in ("from", "both"):
                self._blocked.add(("from", p))

    def heal(self, peer=None):
        """Lift partitions — for `peer`, or all when None."""
        with self._lock:
            if peer is None:
                self._blocked.clear()
            else:
                p = _peer_str(peer)
                self._blocked -= {("to", p), ("from", p)}

    def _is_blocked(self, point: str, peer: str) -> bool:
        d = "to" if point in _OUTBOUND else "from"
        return (d, peer) in self._blocked

    # -- decisions -------------------------------------------------------

    def _draw(self, rule_idx: int, stream: Tuple[str, str], n: int) -> float:
        h = hashlib.blake2b(
            f"{self.seed}|{rule_idx}|{stream[0]}|{stream[1]}|{n}".encode(),
            digest_size=8,
        ).digest()
        return int.from_bytes(h, "big") / float(1 << 64)

    def _pick(self, stream: Tuple[str, str], n: int, method: str,
              count_max: bool) -> Optional[FaultRule]:
        """Pure rule evaluation for decision n of a stream (1-based)."""
        point, peer = stream
        for idx, r in enumerate(self.rules):
            if not r.matches(point, peer, method):
                continue
            if n <= r.after:
                continue
            if count_max and r.max and r.fired >= r.max:
                continue
            if r.p >= 1.0 or self._draw(idx, stream, n) < r.p:
                return r
        return None

    def decide(self, point: str, peer, method: str = "") -> Optional[FaultRule]:
        """Advance the (point, peer) stream and return the fault to
        inject for this event, or None. Deterministic per stream."""
        peer_s = _peer_str(peer)
        stream = (point, peer_s)
        with self._lock:
            n = self._counts[stream] = self._counts.get(stream, 0) + 1
            if self._is_blocked(point, peer_s):
                self.log.append((point, peer_s, n, "partition", method))
                METRICS.inc("faults_injected_total")
                METRICS.inc("fault_partition_total")
                return _PARTITION
            r = self._pick(stream, n, method, count_max=True)
            if r is None:
                return None
            r.fired += 1
            self.log.append((point, peer_s, n, r.action, method))
        METRICS.inc("faults_injected_total")
        METRICS.inc(f"fault_{r.action}_total")
        return r

    def replay(self, point: str, peer, upto: int,
               method: str = "") -> List[Optional[str]]:
        """Recompute decisions 1..upto for a stream WITHOUT advancing
        state — the reproducibility witness (valid for plans whose rules
        carry no `max` cap, since `fired` is cross-stream state)."""
        stream = (point, _peer_str(peer))
        return [
            (r.action if r is not None else None)
            for n in range(1, upto + 1)
            for r in (self._pick(stream, n, method, count_max=False),)
        ]

    def trace(self) -> Dict[Tuple[str, str], List[Tuple[int, str]]]:
        """Injected faults grouped per stream: {(point, peer): [(n, action)]}.
        Per-stream sequences are deterministic for a given seed."""
        out: Dict[Tuple[str, str], List[Tuple[int, str]]] = {}
        with self._lock:
            for point, peer, n, action, _m in self.log:
                out.setdefault((point, peer), []).append((n, action))
        for seq in out.values():
            seq.sort()
        return out

    def counts(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._counts)

    def to_spec(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}


# ---------------------------------------------------------------------------
# process-wide activation
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None

# single source: the registry owns the variable's name and doc
from dgraph_tpu_torch.x import config as _config

ENV_VAR = _config.knob("FAULT_PLAN").env


def _plan_from_env() -> Optional[FaultPlan]:
    spec = _config.get("FAULT_PLAN").strip()
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    obj = json.loads(spec)
    return FaultPlan(seed=obj.get("seed", 0), rules=obj.get("rules") or [])


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set (or clear, with None) the process-wide plan."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = plan
    return plan


def reset():
    install(None)


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def init_from_env(force: bool = False) -> Optional[FaultPlan]:
    """Load the env-specified plan (alpha/zero processes call this at
    startup so a harness-exported schedule applies inside replicas).
    Without `force`, an already-installed plan wins."""
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None and not force:
            return _ACTIVE
        _ACTIVE = _plan_from_env()
        return _ACTIVE


def syncpoint(point: str, peer="coordinator"):
    """Named in-code fault point (the tablet-move phase boundaries
    `move.begin`/`copy`/`chunk`/`fence`/`delta`/`flip`/`drop`, the
    backup coordinator's `backup.begin`/`group`/`manifest`, and the
    CDC emitter's `cdc.emit`/`cdc.checkpoint`). Consults the active
    plan's deterministic per-(point, peer) stream like any transport
    hook:

      crash  -> raises InjectedCrash (simulated coordinator death at
                exactly this boundary; the caller must not clean up)
      delay  -> sleeps delay_ms (stretches a phase deterministically so
                concurrency tests can observe it in flight)

    Other actions are transport-only and ignored here. Plans with no
    rule matching the point leave its stream untouched, so installing a
    move-point schedule never perturbs the RPC/raft stream draws."""
    plan = _ACTIVE
    if plan is None:
        return
    peer_s = _peer_str(peer)
    if not any(
        r.matches(point, peer_s, "") and r.action in ("crash", "delay")
        for r in plan.rules
    ):
        return
    r = plan.decide(point, peer, "")
    if r is None:
        return
    if r.action == "crash":
        raise InjectedCrash(f"{point} ({peer_s})")
    if r.action == "delay" and r.delay_s > 0:
        import time as _time

        _time.sleep(r.delay_s)  # injected latency, not a retry backoff


# child processes inherit the harness env: pick the plan up at import so
# every transport in the replica consults it from the first frame
init_from_env()
