"""Durable Raft state: hardstate + log + snapshot files per node.

Mirrors the contract of dgraph/raftwal/storage.go:60 (DiskStorage:
HardState, entries, snapshot) without the badger backing: three files in a
per-node directory —

  hard.state  — (term, voted_for, snap_index, snap_term), atomic rewrite
  log.wal     — append-only records: APPEND(term, payload) | TRUNC(index)
                | COMPACT(snap_index, snap_term); replay reconstructs the
                in-memory entry window
  snap.bin    — latest snapshot payload, atomic replace

Raft safety requires hardstate + appended entries be on disk BEFORE a
vote/append response leaves the node (raft paper §5; the reference fsyncs
via badger WAL). `sync=True` fsyncs on every flush and is the production
default (alpha_process/zero_process cfg `wal_sync`, default True); tests
run sync=False (flush-only) for speed — that model survives process
crashes (data is in the OS page cache) but NOT power loss / kernel
panics. Either way the ordering is crash-consistent: a torn tail is
truncated at replay.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, List, Optional, Tuple

_REC = struct.Struct("<BI")  # kind, payload_len
_K_APPEND = 1
_K_TRUNC = 2
_K_COMPACT = 3


class RaftWal:
    def __init__(self, dirpath: str, sync: bool = False):
        self.dir = dirpath
        self.sync = sync
        os.makedirs(dirpath, exist_ok=True)
        self._hard_path = os.path.join(dirpath, "hard.state")
        self._log_path = os.path.join(dirpath, "log.wal")
        self._snap_path = os.path.join(dirpath, "snap.bin")
        self._log_f = None

    # -- hardstate -----------------------------------------------------------

    def save_hard(self, term: int, voted_for: Optional[int], snap_index: int, snap_term: int):
        blob = pickle.dumps((term, voted_for, snap_index, snap_term))
        tmp = self._hard_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, self._hard_path)

    def load_hard(self) -> Optional[Tuple[int, Optional[int], int, int]]:
        if not os.path.exists(self._hard_path):
            return None
        try:
            with open(self._hard_path, "rb") as f:
                return pickle.loads(f.read())
        except Exception:
            return None

    # -- log -----------------------------------------------------------------

    def _log_file(self):
        if self._log_f is None:
            self._log_f = open(self._log_path, "ab")
        return self._log_f

    def _append_rec(self, kind: int, payload: bytes):
        f = self._log_file()
        f.write(_REC.pack(kind, len(payload)))
        f.write(payload)

    def append_entry(self, term: int, data: Any):
        self._append_rec(_K_APPEND, pickle.dumps((term, data)))

    def truncate_from(self, index: int):
        """Entries at global index >= `index` are discarded (conflict)."""
        self._append_rec(_K_TRUNC, pickle.dumps(index))

    def compact(self, snap_index: int, snap_term: int):
        self._append_rec(_K_COMPACT, pickle.dumps((snap_index, snap_term)))

    def flush(self):
        if self._log_f is not None:
            self._log_f.flush()
            if self.sync:
                os.fsync(self._log_f.fileno())

    def replay_log(self) -> Tuple[int, int, List[Tuple[int, Any]]]:
        """Returns (snap_index, snap_term, entries) where entries[i] is the
        record at global index snap_index + 1 + i."""
        snap_index = snap_term = 0
        entries: List[Tuple[int, Any]] = []
        if not os.path.exists(self._log_path):
            return snap_index, snap_term, entries
        with open(self._log_path, "rb") as f:
            data = f.read()
        pos, n = 0, len(data)
        valid = 0
        while pos + _REC.size <= n:
            kind, plen = _REC.unpack_from(data, pos)
            if pos + _REC.size + plen > n or kind not in (
                _K_APPEND,
                _K_TRUNC,
                _K_COMPACT,
            ):
                break  # torn tail
            payload = data[pos + _REC.size : pos + _REC.size + plen]
            try:
                obj = pickle.loads(payload)
            except Exception:
                break
            pos += _REC.size + plen
            valid = pos
            if kind == _K_APPEND:
                entries.append(obj)
            elif kind == _K_TRUNC:
                idx = obj
                keep = idx - snap_index - 1
                del entries[max(0, keep):]
            else:
                new_si, new_st = obj
                drop = new_si - snap_index
                del entries[:max(0, drop)]
                snap_index, snap_term = new_si, new_st
        if valid < n:
            with open(self._log_path, "r+b") as f:
                f.truncate(valid)
        return snap_index, snap_term, entries

    def rewrite_log(self, snap_index: int, snap_term: int, entries: List[Tuple[int, Any]]):
        """Compaction housekeeping: rewrite the log file to just the live
        window so it stops growing (ref raftwal deleteUntil)."""
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None
        tmp = self._log_path + ".tmp"
        with open(tmp, "wb") as f:
            blob = pickle.dumps((snap_index, snap_term))
            f.write(_REC.pack(_K_COMPACT, len(blob)))
            f.write(blob)
            for term, data in entries:
                b = pickle.dumps((term, data))
                f.write(_REC.pack(_K_APPEND, len(b)))
                f.write(b)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, self._log_path)

    # -- snapshot --------------------------------------------------------------

    def save_snapshot(self, data: bytes):
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)

    def load_snapshot(self) -> Optional[bytes]:
        if not os.path.exists(self._snap_path):
            return None
        with open(self._snap_path, "rb") as f:
            return f.read()

    def close(self):
        if self._log_f is not None:
            self.flush()
            self._log_f.close()
            self._log_f = None
