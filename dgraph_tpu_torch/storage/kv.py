"""Host key-value store: the BadgerDB-equivalent storage engine.

The reference stores everything in BadgerDB v4 (LSM + value log, MVCC via
version-suffixed keys; opened at dgraph/worker/server_state.go:95).
Per SURVEY.md §2.7(2) this is host-side storage and is NOT TPU work: we
provide a versioned KV interface with the operations the posting layer
actually uses:

  - put(key, ts, value)            — write a version
  - versions(key, read_ts)         — versions at/below read_ts, newest first
    (posting-list reconstruction walks newest->oldest until a full rollup,
    ref posting/mvcc.go:641 ReadPostingList)
  - iterate(prefix, read_ts)       — latest version per key under prefix
    (index range scans, rebuilds, exports; ref badger Stream framework)
  - delete_below(key, ts)          — GC old versions after rollup

Backends:
  - MemKV: sorted in-memory versioned map with an append-only WAL for
    durability + snapshot/restore. Single-writer, snapshot-isolated reads
    (MVCC by ts) — the concurrency model matches how the engine serializes
    applies through the Raft/oracle path anyway.
  - (later rounds) C++ LSM or sqlite-backed store behind the same interface.
"""

from __future__ import annotations

import bisect
import io
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class KV:
    """Interface. All values are bytes; ts is a u64 commit timestamp."""

    def put(self, key: bytes, ts: int, value: bytes) -> None:
        raise NotImplementedError

    def put_batch(self, items) -> None:
        for k, ts, v in items:
            self.put(k, ts, v)

    def get(self, key: bytes, read_ts: int) -> Optional[Tuple[int, bytes]]:
        """Latest (ts, value) with ts <= read_ts, else None."""
        raise NotImplementedError

    def versions(self, key: bytes, read_ts: int) -> List[Tuple[int, bytes]]:
        raise NotImplementedError

    def iterate(
        self, prefix: bytes, read_ts: int
    ) -> Iterator[Tuple[bytes, int, bytes]]:
        raise NotImplementedError

    def delete_below(self, key: bytes, ts: int) -> None:
        raise NotImplementedError

    def drop_prefix(self, prefix: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


_WAL_REC = struct.Struct("<BIQI")  # op, key_len, ts, val_len
_OP_PUT = 0
_OP_DROP_PREFIX = 1
_OP_DELETE_BELOW = 2


class MemKV(KV):
    """In-memory versioned sorted map + optional WAL durability."""

    def __init__(self, wal_path: Optional[str] = None):
        # guards _data/_keys/WAL: the HTTP front-end serves concurrently and
        # MemKV must not corrupt its sorted-key index or interleave WAL
        # records (ADVICE r1 #2); writes are short, an RLock suffices
        self._mu = threading.RLock()
        # key -> list[(ts, value)] ascending by ts
        self._data: Dict[bytes, List[Tuple[int, bytes]]] = {}
        self._keys: List[bytes] = []  # sorted key index
        self._keys_dirty = False
        self._wal = None
        self._wal_path = wal_path
        if wal_path:
            if os.path.exists(wal_path):
                valid_len = self._replay_wal(wal_path)
                # truncate a torn tail so later appends don't land behind
                # a half-written record and desync the next replay
                if valid_len < os.path.getsize(wal_path):
                    with open(wal_path, "r+b") as f:
                        f.truncate(valid_len)
            self._wal = open(wal_path, "ab")

    # -- writes -------------------------------------------------------------

    def put(self, key: bytes, ts: int, value: bytes) -> None:
        with self._mu:
            self._put_mem(key, ts, value)
            self._wal_append(_OP_PUT, key, ts, value)
            self._wal_flush()

    def put_batch(self, items) -> None:
        with self._mu:
            for k, ts, v in items:
                self._put_mem(k, ts, v)
                self._wal_append(_OP_PUT, k, ts, v)
            self._wal_flush()

    def _wal_append(self, op: int, key: bytes, ts: int, value: bytes = b""):
        if self._wal is not None:
            self._wal.write(_WAL_REC.pack(op, len(key), ts, len(value)))
            self._wal.write(key)
            self._wal.write(value)

    def _wal_flush(self):
        # push buffered records to the OS after every write batch: a
        # SIGKILLed process loses nothing (fsync durability is sync())
        if self._wal is not None:
            self._wal.flush()

    def sync(self):
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def _put_mem(self, key: bytes, ts: int, value: bytes) -> None:
        vers = self._data.get(key)
        if vers is None:
            self._data[key] = [(ts, value)]
            self._keys_dirty = True
            return
        # common case: ts newer than all existing
        if not vers or vers[-1][0] < ts:
            vers.append((ts, value))
        else:
            i = bisect.bisect_left(vers, (ts, b""))
            if i < len(vers) and vers[i][0] == ts:
                vers[i] = (ts, value)  # overwrite same-ts (idempotent replay)
            else:
                vers.insert(i, (ts, value))

    # -- reads --------------------------------------------------------------

    def get(self, key: bytes, read_ts: int) -> Optional[Tuple[int, bytes]]:
        with self._mu:
            vers = self._data.get(key)
            if not vers:
                return None
            i = bisect.bisect_right(vers, read_ts, key=lambda x: x[0])
            if i == 0:
                return None
            return vers[i - 1]

    def versions(self, key: bytes, read_ts: int) -> List[Tuple[int, bytes]]:
        with self._mu:
            vers = self._data.get(key)
            if not vers:
                return []
            return [(ts, v) for ts, v in reversed(vers) if ts <= read_ts]

    def _sorted_keys(self) -> List[bytes]:
        # returns an immutable snapshot list: writers replace (not mutate)
        # self._keys, so iterators holding an old snapshot stay valid
        with self._mu:
            if self._keys_dirty:
                self._keys = sorted(self._data)
                self._keys_dirty = False
            return self._keys

    def iterate(
        self, prefix: bytes, read_ts: int
    ) -> Iterator[Tuple[bytes, int, bytes]]:
        # snapshot the latest versions under ONE lock acquisition — the
        # per-key get() path paid a lock + dict lookup per key, which
        # dominated has()-style tablet scans
        keys = self._sorted_keys()
        i = bisect.bisect_left(keys, prefix)
        out = []
        with self._mu:
            n = len(keys)
            data = self._data
            while i < n:
                k = keys[i]
                if not k.startswith(prefix):
                    break
                vers = data.get(k)
                if vers:
                    j = bisect.bisect_right(
                        vers, read_ts, key=lambda x: x[0]
                    )
                    if j:
                        out.append((k, vers[j - 1][0], vers[j - 1][1]))
                i += 1
        return iter(out)

    def iterate_versions(
        self, prefix: bytes, read_ts: int, after: bytes = b""
    ) -> Iterator[Tuple[bytes, List[Tuple[int, bytes]]]]:
        """All versions per key (newest first) — rebuilds & backups.
        `after` seeks the scan strictly past a key (the tablet mover's
        page cursor: resuming a paged scan bisects instead of
        re-walking every already-sent key)."""
        keys = self._sorted_keys()
        start = prefix
        if after:
            nxt = after + b"\x00"
            if nxt > start:
                start = nxt
        i = bisect.bisect_left(keys, start)
        while i < len(keys):
            k = keys[i]
            if not k.startswith(prefix):
                break
            vs = self.versions(k, read_ts)
            if vs:
                yield (k, vs)
            i += 1

    # -- maintenance --------------------------------------------------------

    def delete_below(self, key: bytes, ts: int) -> None:
        with self._mu:
            self._delete_below_mem(key, ts)
            self._wal_append(_OP_DELETE_BELOW, key, ts)
            self._wal_flush()

    def _delete_below_mem(self, key: bytes, ts: int) -> None:
        vers = self._data.get(key)
        if not vers:
            return
        self._data[key] = [(t, v) for t, v in vers if t >= ts]

    def drop_prefix(self, prefix: bytes) -> None:
        with self._mu:
            self._drop_prefix_mem(prefix)
            self._wal_append(_OP_DROP_PREFIX, prefix, 0)
            self._wal_flush()

    def _drop_prefix_mem(self, prefix: bytes) -> None:
        for k in [k for k in self._data if k.startswith(prefix)]:
            del self._data[k]
        self._keys_dirty = True

    # -- durability ---------------------------------------------------------

    def _replay_wal(self, path: str) -> int:
        """Replay; returns the byte length of the valid prefix."""
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        n = len(data)
        while pos + _WAL_REC.size <= n:
            op, klen, ts, vlen = _WAL_REC.unpack_from(data, pos)
            if pos + _WAL_REC.size + klen + vlen > n or op > _OP_DELETE_BELOW:
                break  # torn tail write — stop replay (crash-consistent)
            pos += _WAL_REC.size
            key = data[pos : pos + klen]
            pos += klen
            val = data[pos : pos + vlen]
            pos += vlen
            if op == _OP_PUT:
                self._put_mem(key, ts, val)
            elif op == _OP_DROP_PREFIX:
                self._drop_prefix_mem(key)
            elif op == _OP_DELETE_BELOW:
                self._delete_below_mem(key, ts)
        return pos

    def snapshot_to(self, path: str):
        """Write a compact snapshot (all live versions)."""
        with self._mu, open(path + ".tmp", "wb") as f:
            for k in self._sorted_keys():
                for ts, v in self._data.get(k, []):
                    f.write(_WAL_REC.pack(_OP_PUT, len(k), ts, len(v)))
                    f.write(k)
                    f.write(v)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)

    def dump_bytes(self) -> bytes:
        """Serialize all live versions (raft snapshot payload)."""
        with self._mu:
            out = io.BytesIO()
            for k in self._sorted_keys():
                for ts, v in self._data.get(k, []):
                    out.write(_WAL_REC.pack(_OP_PUT, len(k), ts, len(v)))
                    out.write(k)
                    out.write(v)
            return out.getvalue()

    def load_bytes(self, blob: bytes):
        """Replace contents from a dump_bytes() payload (snapshot install).
        The WAL is restarted from the snapshot so replay stays consistent."""
        with self._mu:
            self._data.clear()
            self._keys = []
            self._keys_dirty = False
            pos, n = 0, len(blob)
            while pos + _WAL_REC.size <= n:
                op, klen, ts, vlen = _WAL_REC.unpack_from(blob, pos)
                pos += _WAL_REC.size
                key = blob[pos : pos + klen]
                pos += klen
                val = blob[pos : pos + vlen]
                pos += vlen
                self._put_mem(key, ts, val)
            if self._wal is not None:
                self._wal.close()
                self._wal = open(self._wal_path, "wb")
                self._wal.write(blob)
                self._wal.flush()

    def close(self):
        with self._mu:
            if self._wal is not None:
                self.sync()
                self._wal.close()
                self._wal = None


def open_kv(
    path: Optional[str] = None,
    backend: Optional[str] = None,
    encryption_key: Optional[bytes] = None,
) -> KV:
    """Open the default store; path=None gives a pure in-memory KV.

    backend (or DGRAPH_TPU_STORAGE): "mem" (WAL-backed in-memory, default)
    or "lsm" (spill-to-disk SSTables, storage/lsm.py — for datasets that
    must not live wholly in RAM).

    encryption_key: at-rest AES key. On the lsm backend whole entries
    (keys + values) are sealed on disk; on the mem backend values are
    sealed via EncryptedKV (keys, incl. index tokens, stay plaintext —
    use lsm for full sealing)."""
    if path is None:
        kv: KV = MemKV()
        if encryption_key is not None:
            from dgraph_tpu_torch.storage.encrypted import EncryptedKV

            kv = EncryptedKV(kv, encryption_key)
        return kv
    from dgraph_tpu_torch.x import config

    backend = backend or config.get("STORAGE")
    os.makedirs(path, exist_ok=True)
    if backend == "lsm":
        from dgraph_tpu_torch.storage.lsm import LsmKV

        return LsmKV(os.path.join(path, "lsm"), enc_key=encryption_key)
    kv = MemKV(wal_path=os.path.join(path, "wal.log"))
    if encryption_key is not None:
        from dgraph_tpu_torch.storage.encrypted import EncryptedKV

        kv = EncryptedKV(kv, encryption_key)
    return kv
