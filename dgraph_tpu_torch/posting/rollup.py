"""Incremental rollups: bound delta-chain length per key.

Mirrors dgraph/posting/mvcc.go (incrRollupi:41, Process:158): keys
whose committed delta chains exceed a threshold are compacted into a fresh
rollup record and old versions dropped, keeping reads O(1)-ish in layers.
Runs on demand (rollup_all) or as a background thread (RollupDaemon — the
incremental rollup goroutine analog).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dgraph_tpu_torch.posting.pl import KIND_DELTA, PostingList, decode_record
from dgraph_tpu_torch.x import keys


def rollup_key(kv, key: bytes, read_ts: int) -> bool:
    """Compact one key's layers; returns True if a rollup was written.

    Oversized lists split into part records (keys.SplitKey) and re-split on
    every rollup (ref posting/list.go:1590 splitUpList); parts dropped by a
    re-split are deleted."""
    versions = kv.versions(key, read_ts)
    n_deltas = 0
    for _, rec in versions:
        kind = rec[0]
        if kind == KIND_DELTA:
            n_deltas += 1
        else:
            break
    if n_deltas == 0:
        return False
    pl = PostingList.from_versions(key, versions, kv=kv, read_ts=read_ts)
    old_starts = set(pl.split_starts)
    rec, ts, parts = pl.rollup()
    new_starts = set()
    for start, prec in parts:
        pk = keys.SplitKey(key, start)
        kv.put(pk, ts, prec)
        kv.delete_below(pk, ts)
        new_starts.add(start)
    for start in old_starts - new_starts:
        kv.delete_below(keys.SplitKey(key, start), ts + 1)
    kv.put(key, ts, rec)
    kv.delete_below(key, ts)
    return True


def rollup_all(server, min_deltas: int = 2) -> int:
    """Compact every key whose delta chain is >= min_deltas. Returns the
    number of keys rolled up (ref Rollup stream in draft.go rollup op)."""
    ts = server.zero.read_ts()
    rolled = 0
    todo = []
    for key, vers in server.kv.iterate_versions(b"", ts):
        try:
            keys.parse_key(key)
        except Exception:
            continue  # non-graph meta keys (counters, checkpoints)
        n = 0
        for _, rec in vers:
            if rec[:1] and rec[0] == KIND_DELTA:
                n += 1
            else:
                break
        if n >= min_deltas:
            todo.append(key)
    for key in todo:
        if rollup_key(server.kv, key, ts):
            rolled += 1
    return rolled


class RollupDaemon:
    """Background incremental rollup (ref posting/mvcc.go:92 goroutine)."""

    def __init__(self, server, interval_s: float = 5.0, min_deltas: int = 4):
        self.server = server
        self.interval = interval_s
        self.min_deltas = min_deltas
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rolled_total = 0

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                # race-ok: single-writer stats counter — only this daemon
                # thread increments; readers see a GIL-atomic int
                self.rolled_total += rollup_all(self.server, self.min_deltas)
            except Exception:
                pass  # rollups are best-effort; next tick retries

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
