"""Health-aware replica selection for the read plane.

The reference routes reads leader-first and hedges blindly to one
follower (worker/task.go:60). This module replaces that with the two
ingredients of a tail-tolerant, watermark-correct read plane:

  ReplicaStats   per-replica latency EWMA + an error circuit breaker
                 (closed / open / half-open with a jittered probe
                 window), so a sick replica is routed AROUND instead of
                 stalled ON, and rejoins within ~one probe interval of
                 recovering ("The Tail at Scale" hedging only pays off
                 when the hedge target is actually healthy).

  ReplicaPicker  per-group candidate ordering. Followers are eligible
                 only under the PR 11 watermark-verification rule: the
                 replica's cached raft applied index (from the health
                 RPC, TTL-bounded) must cover the group's read floor —
                 the highest raft index any completed proposal of this
                 coordinator returned, recorded BEFORE the snapshot
                 watermark advances. Raft applies the log as a prefix,
                 so applied >= floor means every write visible at the
                 watermark is present; MVCC hides anything newer than
                 the read ts. Stale-or-unknown rows never serve, and an
                 UNKNOWN floor (floor=None — a freshly started or
                 restarted coordinator that has not yet heard a leader
                 health reply or completed a proposal) makes EVERY
                 follower ineligible: floor 0 would otherwise "cover"
                 pre-restart writes this process knows nothing about.
                 A known floor is conservative — it only skips an
                 eligible follower, it cannot serve stale bytes. The
                 leader (when known) is always eligible — it is the
                 fallback, not the default.

Ordering among eligible closed-breaker candidates is by latency EWMA
(unknown sorts first: an unmeasured-but-verified replica is explored
once, then the EWMA takes over; the sort is stable so the leader-first
input order breaks ties). Half-open probes append at the END of the
plan: they only get traffic when everything healthier already failed
or the hedge timer fired.

All state is process-local and advisory — losing it (coordinator
restart) only makes routing conservative, never wrong.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config

Addr = Tuple[str, int]

# breaker states
CLOSED = "closed"
OPEN = "open"

_EWMA_ALPHA = 0.3


class ReplicaStats:
    """Mutable per-replica read statistics. Callers hold the picker
    lock; nothing here locks."""

    __slots__ = (
        "lat_ewma_ms", "consec_fails", "state", "next_probe_at",
    )

    def __init__(self):
        self.lat_ewma_ms: Optional[float] = None
        self.consec_fails = 0
        self.state = CLOSED
        self.next_probe_at = 0.0

    def score(self) -> float:
        # unknown latency sorts FIRST (exploration of verified replicas)
        return self.lat_ewma_ms if self.lat_ewma_ms is not None else 0.0


class _HealthRow:
    __slots__ = ("applied", "is_leader", "at")

    def __init__(self, applied: int, is_leader: bool, at: float):
        self.applied = applied
        self.is_leader = is_leader
        self.at = at


class ReplicaPicker:
    """Candidate ordering + breaker bookkeeping for ONE raft group."""

    def __init__(self, gid: int, addrs: List[Addr],
                 rng: Optional[random.Random] = None):
        self.gid = gid
        self._lock = threading.Lock()
        self._stats: Dict[Addr, ReplicaStats] = {
            tuple(a): ReplicaStats() for a in addrs
        }
        self._health: Dict[Addr, _HealthRow] = {}
        self._rng = rng or random.Random()

    def _stat(self, addr: Addr) -> ReplicaStats:
        st = self._stats.get(addr)
        if st is None:
            st = self._stats[addr] = ReplicaStats()
        return st

    # -- inputs ----------------------------------------------------------

    def note_health(self, addr: Addr, applied: int, is_leader: bool):
        """Record a health-RPC reply (leader discovery, background
        refresh, harness health probes all feed this)."""
        addr = tuple(addr)
        with self._lock:
            self._health[addr] = _HealthRow(
                int(applied), bool(is_leader), time.monotonic()
            )
            # a health reply proves the PROCESS answers, not that the
            # data path works (sick disk, deserialization bug, overload
            # all keep answering health). An OPEN breaker therefore
            # goes HALF-OPEN — immediately probe-eligible — instead of
            # closing; only a successful read (observe(ok=True)) closes
            # it. Health must not touch consec_fails either: the
            # background sweep fires every TTL/2 and would otherwise
            # reset the count faster than a flaky data path can trip it.
            st = self._stat(addr)
            if st.state == OPEN:
                st.next_probe_at = 0.0

    def observe(self, addr: Addr, ok: bool, lat_s: float = 0.0):
        """Feed one read outcome into the EWMA + breaker."""
        addr = tuple(addr)
        thresh = int(config.get("READ_BREAKER_ERRORS"))
        with self._lock:
            st = self._stat(addr)
            if ok:
                ms = lat_s * 1000.0
                if st.lat_ewma_ms is None:
                    st.lat_ewma_ms = ms
                else:
                    st.lat_ewma_ms += _EWMA_ALPHA * (ms - st.lat_ewma_ms)
                st.consec_fails = 0
                if st.state == OPEN:
                    st.state = CLOSED
                    METRICS.inc("read_breaker_close_total")
                return
            st.consec_fails += 1
            if st.state == OPEN:
                # a failed half-open probe: push the next window out
                st.next_probe_at = time.monotonic() + self._probe_window()
            elif thresh and st.consec_fails >= thresh:
                st.state = OPEN
                st.next_probe_at = time.monotonic() + self._probe_window()
                METRICS.inc("read_breaker_open_total")

    def _probe_window(self) -> float:
        probe_s = float(config.get("READ_BREAKER_PROBE_S"))
        return probe_s * self._rng.uniform(0.5, 1.5)

    # -- queries ---------------------------------------------------------

    def applied_of(self, addr: Addr, ttl: float) -> Optional[int]:
        """The replica's cached applied index, or None when stale/unknown."""
        row = self._health.get(tuple(addr))
        if row is None or time.monotonic() - row.at > ttl:
            return None
        return row.applied

    def refresh_due(self, addrs: List[Addr], ttl: float) -> bool:
        """True when any replica's health row is older than half the
        TTL — the background-refresh trigger (half, so rows are usually
        still fresh when a read needs them)."""
        now = time.monotonic()
        with self._lock:
            for a in addrs:
                row = self._health.get(tuple(a))
                if row is None or now - row.at > ttl * 0.5:
                    return True
        return False

    def plan(self, addrs: List[Addr], leader: Optional[Addr],
             floor: Optional[int], healthy,
             follower_ok: bool = True) -> List[Addr]:
        """Ordered read candidates for one attempt.

        Eligibility: transport circuit closed (`healthy`), AND (is the
        known leader OR `follower_ok` with a fresh applied index >= the
        group read floor). `floor=None` means the floor is UNKNOWN
        (restarted coordinator): no follower is eligible, whatever its
        applied index claims. Breaker-OPEN replicas are skipped unless
        their jittered probe window elapsed, in which case they append
        at the end as half-open probes."""
        ttl = float(config.get("FOLLOWER_READ_TTL_S"))
        now = time.monotonic()
        ordered = []
        if leader is not None:
            leader = tuple(leader)
            ordered.append(leader)
        ordered.extend(a for a in (tuple(x) for x in addrs)
                       if a != leader)
        eligible: List[Tuple[float, int, Addr]] = []
        probes: List[Addr] = []
        with self._lock:
            for i, a in enumerate(ordered):
                if not healthy(a):
                    continue
                if a != leader:
                    if not follower_ok:
                        continue
                    if floor is None:
                        METRICS.inc(
                            "follower_read_floor_unknown_skips_total"
                        )
                        continue
                    row = self._health.get(a)
                    fresh = row is not None and now - row.at <= ttl
                    if not fresh or row.applied < floor:
                        METRICS.inc("follower_read_stale_skips_total")
                        continue
                st = self._stat(a)
                if st.state == OPEN:
                    if now >= st.next_probe_at:
                        # claim this window so concurrent reads don't
                        # all probe the same sick replica at once
                        st.next_probe_at = now + self._probe_window()
                        METRICS.inc("read_breaker_probe_total")
                        probes.append(a)
                    continue
                eligible.append((st.score(), i, a))
        eligible.sort()
        return [a for _, _, a in eligible] + probes

    def snapshot(self) -> dict:
        """Debug/ops view of the per-replica read state."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for a, st in self._stats.items():
                row = self._health.get(a)
                out[f"{a[0]}:{a[1]}"] = {
                    "lat_ewma_ms": st.lat_ewma_ms,
                    "breaker": st.state,
                    "consec_fails": st.consec_fails,
                    "applied": row.applied if row else None,
                    "health_age_s": (now - row.at) if row else None,
                }
        return out
