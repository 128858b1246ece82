"""XID -> UID assignment map (ref dgraph/xidmap/xidmap.go).

Sharded map handing out uids from Zero lease blocks; used by the live and
bulk loaders so external ids ("xids", e.g. blank node labels or IRI ids)
map to stable uids across batches.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from dgraph_tpu_torch.zero.zero import ZeroLite

_NSHARDS = 16
_LEASE_BLOCK = 10_000


class XidMap:
    def __init__(self, zero: ZeroLite, kv=None):
        self.zero = zero
        self._shards = [
            {"lock": threading.Lock(), "map": {}} for _ in range(_NSHARDS)
        ]
        self._lease_lock = threading.Lock()
        self._next = 0
        self._end = 0
        self.kv = kv  # optional spill store (ref badger-backed xidmap)

    def _lease(self) -> int:
        with self._lease_lock:
            if self._next >= self._end:
                first = self.zero.assign_uids(_LEASE_BLOCK)
                self._next = first
                self._end = first + _LEASE_BLOCK
            uid = self._next
            self._next += 1
            return uid

    def assign_uid(self, xid: str) -> int:
        """Get-or-assign (ref xidmap.go:252 AssignUid)."""
        sh = self._shards[hash(xid) % _NSHARDS]
        with sh["lock"]:
            uid = sh["map"].get(xid)
            if uid is None:
                uid = self._lease()
                sh["map"][xid] = uid
            return uid

    def lookup(self, xid: str) -> Optional[int]:
        sh = self._shards[hash(xid) % _NSHARDS]
        with sh["lock"]:
            return sh["map"].get(xid)

    def set_uid(self, xid: str, uid: int):
        sh = self._shards[hash(xid) % _NSHARDS]
        with sh["lock"]:
            sh["map"][xid] = uid

    def __len__(self):
        return sum(len(sh["map"]) for sh in self._shards)
