"""Snapshot-keyed whole-response result cache (ROADMAP open item 2).

Production traffic from millions of users is highly repetitive: the
same query shapes with the same hot literal bindings arrive over and
over between commits. PR 7's plan cache only skips *parsing*; this
cache skips execution and encode outright by serving the response's
wire bytes from a bounded LRU keyed on

    (normalized plan shape, literal bindings, query variables,
     namespace, snapshot watermark)

Correctness rests on the PR 7/11 snapshot-watermark proof: the
engine's `_snapshot_ts` is published only after a commit's deltas are
written and advances in commit-ts order, so any two reads covering the
SAME watermark observe identical stores — the executed response bytes
are a pure function of (query text, variables, namespace, watermark).
A commit (or alter) advances the watermark, which changes every key:
no cached result can ever be served past a watermark advance, with no
explicit invalidation sweep needed (stale-watermark entries age out of
the LRU; commit-epoch invalidation already covers the plan cache).

What is stored is only the response `data` wire bytes (the RawJson /
RawData `.raw` arena output) — entries are immutable `bytes`; hits
rebuild the response shell per `want` (a fresh RawJson, or a RawData
around `json.loads`, the same parse-back the stream path performs on a
miss), so callers can never mutate a cached entry.

Eligibility is decided at the entry points (api/server.py,
worker/harness.py): watermark reads only (caller-pinned read_ts never
caches), no ACL (per-user visibility would need per-claims keys),
clean completions only (no truncated/degraded/partial responses), and
EXPLAIN/debug queries always execute (the plan tree is the point) but
record the would-hit tier in `extensions.plan.result_cache`.

Default OFF (DGRAPH_TPU_RESULT_CACHE_SIZE=0), like the other
serving-front gates (ADMISSION, BATCH_WINDOW_US); the BENCH_QPS
reuse sweep A/Bs it against the same build with the knob zeroed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config


class ResultCache:
    """Bounded LRU of response wire bytes keyed on (shape, literals,
    vars, ns, watermark). Thread-safe; nothing blocking runs under its
    lock (entries are prebuilt bytes)."""

    def __init__(self, size: Optional[int] = None, ttl_s: Optional[float] = None,
                 max_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._size = size
        self._ttl = ttl_s
        self._max_bytes = max_bytes
        # key -> (raw bytes, monotonic insert time)
        self._entries: "OrderedDict[tuple, Tuple[bytes, float]]" = (
            OrderedDict()
        )
        self._bytes = 0  # payload bytes currently held
        self.hits = 0
        self.misses = 0

    def capacity(self) -> int:
        if self._size is not None:
            return max(0, int(self._size))
        return max(0, int(config.get("RESULT_CACHE_SIZE")))

    def byte_capacity(self) -> int:
        """Byte bound on stored payloads; 0 = entry count only. A
        response cache sized in 'entries' alone is unbounded in the
        dimension that matters (a wide fan-out response is MBs)."""
        if self._max_bytes is not None:
            return max(0, int(self._max_bytes))
        return max(0, int(config.get("RESULT_CACHE_BYTES")))

    def ttl_s(self) -> float:
        if self._ttl is not None:
            return max(0.0, float(self._ttl))
        return max(0.0, float(config.get("RESULT_CACHE_TTL_S")))

    @staticmethod
    def key(
        shape: str,
        literals: tuple,
        variables,
        ns: int,
        watermark: int,
        epoch: int = 0,
    ) -> tuple:
        """`epoch` is the engine's commit epoch (plan-cache epoch,
        bumped by every commit AND alter): it closes the one hole
        watermark keying leaves — an alter, or a commit racing an
        alter's watermark jump, can change visible semantics without
        the watermark distinguishing before from after. Keys carry
        both, so an entry is reachable only at an unchanged store AND
        an unchanged schema/commit epoch."""
        vk = (
            ()
            if not variables
            else tuple(sorted((str(k), repr(v)) for k, v in variables.items()))
        )
        return (
            shape, tuple(literals or ()), vk, int(ns),
            int(watermark), int(epoch),
        )

    # -- lookups --------------------------------------------------------------

    def get(self, key: tuple) -> Optional[bytes]:
        """Cached wire bytes for this exact (binding, watermark), or
        None. Counts result_cache_{hit,miss}_total — call only for
        ELIGIBLE lookups so the metrics describe the reuse regime."""
        ttl = self.ttl_s()
        now = time.monotonic()
        with self._lock:
            got = self._entries.get(key)
            if got is not None and ttl and now - got[1] > ttl:
                del self._entries[key]
                self._bytes -= len(got[0])
                got = None
            if got is None:
                self.misses += 1
                METRICS.inc("result_cache_miss_total")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            METRICS.inc("result_cache_hit_total")
            return got[0]

    def peek(self, key: tuple) -> bool:
        """Presence probe without serving, counters, or LRU touch —
        the EXPLAIN would-hit tier (debug queries always execute)."""
        ttl = self.ttl_s()
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                return False
            return not (ttl and time.monotonic() - got[1] > ttl)

    def put(self, key: tuple, raw: bytes) -> None:
        cap = self.capacity()
        bcap = self.byte_capacity()
        if cap == 0 or not isinstance(raw, (bytes, bytearray)):
            return
        raw = bytes(raw)
        if bcap and len(raw) > bcap:
            return  # one giant response must not flush the whole LRU
        with self._lock:
            old = self._entries.get(key)
            if old is not None:
                self._bytes -= len(old[0])
            self._entries[key] = (raw, time.monotonic())
            self._entries.move_to_end(key)
            self._bytes += len(raw)
            while len(self._entries) > cap or (
                bcap and self._bytes > bcap
            ):
                _, (dropped, _t) = self._entries.popitem(last=False)
                self._bytes -= len(dropped)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
            }


def rebuild_data(raw: bytes, want: str):
    """Response `data` shell around cached wire bytes: a fresh RawJson
    (want="raw"), or a RawData around json.loads — the SAME parse-back
    the stream encoder performs on a miss, so hit and miss responses
    are structurally as well as byte identical. A fresh object per hit
    means callers can never mutate the cached entry."""
    from dgraph_tpu_torch.query.streamjson import RawData, RawJson

    if want == "raw":
        return RawJson(raw)
    import json

    return RawData(json.loads(raw), raw)


def hit_response(
    raw: bytes,
    want: str,
    parsing_ns: int,
    assign_ns: int,
    processing_ns: int,
    watermark: int,
) -> dict:
    """The full cache-hit response shell — ONE implementation for both
    entry points (api/server.Server.query, ProcCluster.query) so the
    hit shape can never drift between engines. The latency parts
    partition the wall clock at the caller, so total is their sum
    (encoding is 0: no bytes were produced on a hit)."""
    out = {"data": rebuild_data(raw, want)}
    out["extensions"] = {
        "server_latency": {
            "parsing_ns": int(parsing_ns),
            "assign_timestamp_ns": int(assign_ns),
            "processing_ns": int(processing_ns),
            "encoding_ns": 0,
            "total_ns": int(parsing_ns) + int(assign_ns) + int(processing_ns),
        },
        # the response contract promises an extensions.profile block on
        # every query (consumers index into it unguarded): a hit did no
        # execution, so the attribution is the empty QueryProfile shape
        "profile": {
            "level_tasks": [],
            "rpc": [],
            "kernel": {},
            "events": {},
            "encode": {},
            "exec_pool": {"max_queue_depth": 0},
        },
        "result_cache": {"hit": True, "watermark": int(watermark)},
    }
    return out
