"""Backup & restore: full + incremental with a validated manifest chain.

Mirrors dgraph/worker/backup*.go + backup/: a backup captures
all KV versions in (since_ts, read_ts]; the manifest chain records the
ts ranges so incrementals restore in order (ref backup_manifest.go).

Format (v2): records are `<IQII>(key_len, ts, val_len, crc32)` + key +
value inside gzip'd chunk files bounded by DGRAPH_TPU_BACKUP_CHUNK_BYTES
— the CRC covers (key, ts, value), so a flipped bit inside a record is
caught at restore, not replayed as a silent hole. The manifest entry
names every chunk file with its record count and the sha256 of its
DECOMPRESSED payload, and the manifest itself is committed last and
atomically (tmp + os.replace): a coordinator crash mid-backup leaves
files the manifest never names — detectably incomplete, never silently
short. Legacy v1 entries (single `path`, no CRCs) still restore, with
record-count verification standing in for the missing checksums.

Restore refuses manifest-chain gaps/overlaps (`ManifestChainError`) and
torn or corrupt backup files (`TornBackupError`); the online
`restore_to_cluster` journals applied chunks (idempotent resume after a
restore-coordinator crash) and finishes by advancing the Zero leases
AND the snapshot watermark, so restored data is immediately visible to
watermark reads (worker/harness.py query path).

The distributed coordinator (pinned cluster-wide read_ts, per-group
streaming, phase journal, move coordination) lives in
worker/backupdriver.py; `backup_engine` dispatches per engine shape.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from dgraph_tpu_torch.utils.observe import METRICS

_REC = struct.Struct("<IQI")  # v1 (legacy): key_len, ts, val_len
_REC2 = struct.Struct("<IQII")  # v2: key_len, ts, val_len, crc32
MANIFEST = "manifest.json"


class BackupError(RuntimeError):
    pass


class ManifestChainError(BackupError):
    """The manifest's since/read_ts chain has a gap or an overlap —
    restoring across it would silently lose (or double-count) the
    versions in between."""


class TornBackupError(BackupError):
    """A backup file is truncated, fails its checksum, or holds fewer
    records than its manifest entry promises: a coordinator (or disk)
    died mid-write. Restore refuses it rather than replaying a hole."""


def _crc(key: bytes, ts: int, val: bytes) -> int:
    return zlib.crc32(val, zlib.crc32(key, ts & 0xFFFFFFFF)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def load_manifest(backup_dir: str) -> dict:
    path = os.path.join(backup_dir, MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"backups": []}


def save_manifest(backup_dir: str, manifest: dict) -> None:
    """Atomic manifest commit: the entry becomes visible all-or-nothing
    (a torn manifest would make every chain link unreadable)."""
    path = os.path.join(backup_dir, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def validate_chain(manifest: dict) -> List[dict]:
    """Validate the since/read_ts chain and return the entries a
    restore must replay: the LAST full backup onward. Only that suffix
    is validated — a full backup (since=0) restarts the chain and
    never replays what precedes it, so a broken, superseded prefix
    must not block recovery (taking a `--full` backup is exactly how a
    damaged directory is healed). Adjacent live entries must tile
    exactly: entry.since == prev.read_ts."""
    entries = manifest.get("backups", [])
    if not entries:
        return []
    start = 0
    for i, e in enumerate(entries):
        if int(e["since"]) == 0:
            start = i
    live = entries[start:]
    for i, e in enumerate(live):
        since, read_ts = int(e["since"]), int(e["read_ts"])
        if since >= read_ts:
            raise ManifestChainError(
                f"entry {start + i + 1}: empty/inverted range "
                f"({since}, {read_ts}]"
            )
        if i == 0:
            if since != 0:
                raise ManifestChainError(
                    "first entry is incremental (no full backup to "
                    "chain from)"
                )
            continue
        prev_ts = int(live[i - 1]["read_ts"])
        if since > prev_ts:
            raise ManifestChainError(
                f"gap between entries {start + i} and {start + i + 1}: "
                f"versions in ({prev_ts}, {since}] are covered by no "
                f"backup"
            )
        if since < prev_ts:
            raise ManifestChainError(
                f"overlap between entries {start + i} and "
                f"{start + i + 1}: since {since} < previous read_ts "
                f"{prev_ts}"
            )
    return live


def chain_for_restore(
    backup_dir: str, until: Optional[int] = None
) -> List[dict]:
    manifest = load_manifest(backup_dir)
    if not manifest["backups"]:
        raise FileNotFoundError(f"no backups in {backup_dir}")
    entries = validate_chain(manifest)
    if until is not None:
        entries = [e for e in entries if int(e["since"]) < until]
    return entries


def verify_entries(backup_dir: str, entries: List[dict]) -> None:
    """Full verification pass (gzip, sha256, CRCs, record counts) over
    every file of every entry WITHOUT applying anything. Online restore
    runs this first: a torn file in a late incremental must refuse the
    whole restore up front, not strand a live cluster half-restored
    with earlier entries already proposed through raft."""
    for entry in entries:
        for _rec in iter_entry_records(backup_dir, entry):
            pass


# ---------------------------------------------------------------------------
# chunk files
# ---------------------------------------------------------------------------


class BackupWriter:
    """Chunked v2 backup files for one (backup idx, group): records
    accumulate in a payload buffer that flushes as
    `backup-<idx>-g<gid>-<seq>.gz` whenever it clears the chunk bound.
    Files land atomically (tmp + replace) so a resume overwriting a
    partial chunk by name can never splice two generations."""

    def __init__(
        self, backup_dir: str, idx: int, gid: int, chunk_bytes: int,
        seq0: int = 0,
    ):
        self.dir = backup_dir
        self.idx = int(idx)
        self.gid = int(gid)
        self.chunk = int(chunk_bytes)
        self.seq = int(seq0)
        self._buf = bytearray()
        self._records = 0
        self._files: List[dict] = []

    def add(self, key: bytes, ts: int, val: bytes) -> None:
        self._buf += _REC2.pack(
            len(key), ts, len(val), _crc(key, ts, val)
        )
        self._buf += key
        self._buf += val
        self._records += 1
        if len(self._buf) >= self.chunk:
            self._roll()

    def _roll(self) -> None:
        if not self._buf:
            return
        self.seq += 1
        name = f"backup-{self.idx:04d}-g{self.gid}-{self.seq:03d}.gz"
        payload = bytes(self._buf)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(gzip.compress(payload))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, name))
        self._files.append(
            {
                "name": name,
                "gid": self.gid,
                "records": self._records,
                "sha256": hashlib.sha256(payload).hexdigest(),
            }
        )
        METRICS.inc("backup_bytes_total", len(payload))
        self._buf = bytearray()
        self._records = 0

    def mark(self):
        """Flush the buffered tail to its own chunk and return a
        rollback point: everything added after it can be discarded
        with `rollback(mark)` without touching earlier tablets' files
        (the move-race retry keeps coordinator memory bounded to one
        chunk instead of buffering a whole tablet)."""
        self._roll()
        return (len(self._files), self.seq)

    def rollback(self, mark) -> int:
        """Discard everything added since `mark`: delete the rolled
        chunk files and drop the buffer. Returns records discarded."""
        nfiles, seq = mark
        dropped = self._records
        for f in self._files[nfiles:]:
            dropped += int(f["records"])
            try:
                os.remove(os.path.join(self.dir, f["name"]))
            except FileNotFoundError:
                pass
        self._files = self._files[:nfiles]
        self.seq = seq
        self._buf = bytearray()
        self._records = 0
        return dropped

    def finish(self) -> List[dict]:
        self._roll()
        return self._files


def _parse_records_v2(payload: bytes) -> Iterator[Tuple[bytes, int, bytes]]:
    pos, n = 0, len(payload)
    while pos < n:
        if pos + _REC2.size > n:
            raise TornBackupError(
                f"truncated record header at byte {pos}"
            )
        klen, ts, vlen, crc = _REC2.unpack_from(payload, pos)
        pos += _REC2.size
        if pos + klen + vlen > n:
            raise TornBackupError(f"truncated record body at byte {pos}")
        key = payload[pos : pos + klen]
        pos += klen
        val = payload[pos : pos + vlen]
        pos += vlen
        if _crc(key, ts, val) != crc:
            METRICS.inc("restore_verify_failures_total")
            raise TornBackupError(
                f"record CRC mismatch at byte {pos} (key {key[:32]!r})"
            )
        yield key, ts, val


def iter_file_records(
    backup_dir: str, fmeta: dict
) -> Iterator[Tuple[bytes, int, bytes]]:
    """Verified record stream of one v2 chunk file: gzip integrity,
    payload sha256 against the manifest, per-record CRCs, and the
    record count — any mismatch raises TornBackupError."""
    path = os.path.join(backup_dir, fmeta["name"])
    try:
        with open(path, "rb") as f:
            raw = f.read()
        payload = gzip.decompress(raw)
    except FileNotFoundError:
        raise TornBackupError(f"missing backup file {fmeta['name']}")
    except (OSError, EOFError, zlib.error) as e:
        METRICS.inc("restore_verify_failures_total")
        raise TornBackupError(
            f"corrupt gzip stream in {fmeta['name']}: {e}"
        ) from e
    want_sha = fmeta.get("sha256")
    if want_sha and hashlib.sha256(payload).hexdigest() != want_sha:
        METRICS.inc("restore_verify_failures_total")
        raise TornBackupError(
            f"{fmeta['name']}: payload sha256 does not match the "
            f"manifest"
        )
    n = 0
    for rec in _parse_records_v2(payload):
        n += 1
        yield rec
    if n != int(fmeta.get("records", n)):
        METRICS.inc("restore_verify_failures_total")
        raise TornBackupError(
            f"{fmeta['name']}: {n} records on disk, manifest promises "
            f"{fmeta.get('records')}"
        )


def _iter_legacy(
    backup_dir: str, entry: dict
) -> Iterator[Tuple[bytes, int, bytes]]:
    """v1 single-file entries: no CRCs; completeness is checked via the
    record count + trailing-garbage detection."""
    path = os.path.join(backup_dir, entry["path"])
    with gzip.open(path, "rb") as f:
        data = f.read()
    pos, n, count = 0, len(data), 0
    while pos + _REC.size <= n:
        klen, ts, vlen = _REC.unpack_from(data, pos)
        if pos + _REC.size + klen + vlen > n:
            break
        pos += _REC.size
        key = data[pos : pos + klen]
        pos += klen
        val = data[pos : pos + vlen]
        pos += vlen
        count += 1
        yield key, ts, val
    if pos != n or count != int(entry.get("records", count)):
        METRICS.inc("restore_verify_failures_total")
        raise TornBackupError(
            f"{entry['path']}: truncated legacy backup ({count} of "
            f"{entry.get('records')} records)"
        )


def iter_entry_records(
    backup_dir: str, entry: dict
) -> Iterator[Tuple[bytes, int, bytes]]:
    if "files" in entry:
        for fmeta in entry["files"]:
            yield from iter_file_records(backup_dir, fmeta)
    else:
        yield from _iter_legacy(backup_dir, entry)


# ---------------------------------------------------------------------------
# backup
# ---------------------------------------------------------------------------


def backup(server, backup_dir: str, incremental: bool = True) -> dict:
    """Single-engine backup (Server / anything with kv + zero.read_ts):
    chunked v2 files, atomic manifest commit. Returns the manifest
    entry."""
    from dgraph_tpu_torch.conn import faults
    from dgraph_tpu_torch.x import config

    os.makedirs(backup_dir, exist_ok=True)
    manifest = load_manifest(backup_dir)
    since = 0
    if incremental:
        # a full backup restarts the chain (since=0) and never replays
        # the old prefix — only incrementals need the chain sound, so
        # `--full` stays available to recover a broken directory
        chain = validate_chain(manifest)
        since = chain[-1]["read_ts"] if chain else 0
    read_ts = server.zero.read_ts()
    idx = len(manifest["backups"]) + 1
    faults.syncpoint("backup.begin")
    writer = BackupWriter(
        backup_dir, idx, 0,
        max(1 << 16, int(config.get("BACKUP_CHUNK_BYTES"))),
    )
    n = 0
    for key, vers in server.kv.iterate_versions(b"", read_ts):
        for ts, val in vers:  # newest first
            if ts <= since:
                break
            writer.add(bytes(key), int(ts), bytes(val))
            n += 1
    entry = {
        "since": int(since),
        "read_ts": int(read_ts),
        "records": n,
        "type": "incremental" if since else "full",
        "files": writer.finish(),
    }
    manifest["backups"].append(entry)
    save_manifest(backup_dir, manifest)
    faults.syncpoint("backup.manifest")
    METRICS.inc("backup_records_total", n)
    METRICS.inc("backup_files_total", len(entry["files"]))
    return entry


def backup_engine(engine, backup_dir: str, incremental: bool = True) -> dict:
    """Engine-shape dispatch: cluster engines (DistributedCluster,
    ProcCluster, a ClusterFacade over either) run the journaled
    distributed coordinator; single-node Servers take the local path."""
    from dgraph_tpu_torch.worker.backupdriver import BackupCoordinator

    cluster = getattr(engine, "cluster", engine)
    if hasattr(cluster, "_move_iter") and hasattr(cluster, "zero"):
        return BackupCoordinator(cluster, backup_dir).backup(
            incremental=incremental
        )
    return backup(engine, backup_dir, incremental=incremental)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def restore(server, backup_dir: str, until: Optional[int] = None) -> int:
    """Replay the validated manifest chain into the server's KV (ref
    online_restore). Returns the number of records restored."""
    entries = chain_for_restore(backup_dir, until)
    # same all-or-nothing verification contract as the online restore:
    # a torn late incremental refuses the restore before the first put
    verify_entries(backup_dir, entries)
    total = 0
    schema_texts: List[str] = []
    for entry in entries:
        writes = []
        for key, ts, val in iter_entry_records(backup_dir, entry):
            if until is not None and ts > until:
                continue
            writes.append((key, ts, val))
            total += 1
        server.kv.put_batch(writes)
        if entry.get("schema"):
            schema_texts.append(entry["schema"])
    # cluster-origin backups carry schema as text (cluster engines hold
    # no schema keys in the group KVs); apply before state recovery so
    # vector indexes and types exist
    for text in schema_texts:
        server.alter(text)
    # recover schema/type definitions, ts + uid leases, and vector
    # indexes from the restored keys — a fresh Server must be fully
    # usable without a prior alter() (ref online_restore schema
    # handling); also seeds the snapshot watermark past the restore
    server._load_persisted_state()
    METRICS.inc("restore_records_total", total)
    return total


def restore_to_cluster(
    cluster, backup_dir: str, until: Optional[int] = None
) -> int:
    """Online restore into a LIVE distributed cluster (ref worker/
    online_restore.go): records are verified, sharded by their owning
    tablet, and proposed through each group's raft log so every replica
    applies them; schema re-alters the cluster; leases AND the snapshot
    watermark advance past the restored timestamps so the data is
    immediately visible to watermark reads. Applied chunks journal to
    <data_dir>/restore.journal — a restore-coordinator crash resumes
    idempotently (same-ts puts) without re-proposing finished chunks."""
    from dgraph_tpu_torch.worker.backupdriver import RestoreJournal
    from dgraph_tpu_torch.x import keys as xkeys

    entries = chain_for_restore(backup_dir, until)
    # verify EVERYTHING before proposing ANYTHING: applying is not
    # atomic across entries, so verification failures must happen
    # while the cluster is still untouched
    verify_entries(backup_dir, entries)
    journal = None
    journal_path = None
    data_dir = getattr(cluster, "data_dir", None)
    if data_dir:
        journal_path = os.path.join(data_dir, "restore.journal")
        journal = RestoreJournal(journal_path)
    done = journal.done() if journal is not None else set()
    total = 0
    max_ts = 0
    max_uid = 0
    try:
        for entry in entries:
            # the token namespace includes `until`: a crashed
            # point-in-time restore's journal must not suppress chunks
            # of a later run with a different cut (their contents
            # differ — ts > until records were filtered out)
            tag = (
                f"{entry['since']}-{entry['read_ts']}"
                f"-u{'all' if until is None else int(until)}"
            )
            per_group: Dict[int, list] = {}
            schema_texts: List[str] = []
            if entry.get("schema"):
                schema_texts.append(entry["schema"])
            for key, ts, val in iter_entry_records(backup_dir, entry):
                if until is not None and ts > until:
                    continue
                max_ts = max(max_ts, ts)
                total += 1
                try:
                    pk = xkeys.parse_key(key)
                except Exception:
                    continue  # meta keys stay coordinator-local
                if pk.is_schema or pk.is_type:
                    schema_texts.append(val.decode("utf-8"))
                    continue
                if pk.uid is not None:
                    max_uid = max(max_uid, pk.uid)
                gid = cluster.zero.should_serve(pk.attr)
                per_group.setdefault(gid, []).append((key, ts, val))
            for text in schema_texts:
                cluster.alter(text)
            for gid, writes in sorted(per_group.items()):
                # chunked proposals keep raft entries bounded
                for ci, i in enumerate(range(0, len(writes), 5000)):
                    token = f"{tag}:{gid}:{ci}"
                    if token in done:
                        continue
                    chunk = writes[i : i + 5000]
                    if hasattr(cluster, "remote_groups"):
                        cluster.remote_groups[gid].propose(
                            ("delta", chunk)
                        )
                    else:
                        cluster._propose_and_wait(gid, ("delta", chunk))
                    if journal is not None:
                        journal.mark(token)
    finally:
        if journal is not None:
            journal.close()
    # the journal exists ONLY to resume an interrupted restore: clear
    # it on success, or a later restore into this data_dir (after a
    # wipe, or of a rebuilt chain with the same ts range) would skip
    # every chunk it journaled and report success having applied nothing
    if journal_path is not None and os.path.exists(journal_path):
        os.remove(journal_path)
    # advance leases past everything restored (works against a local
    # ZeroLite and a remote Zero quorum alike: lease until the cursor
    # clears the restored maxima)
    z = cluster.zero.zero
    cur_ts = z.next_ts()
    if cur_ts < max_ts:
        z.next_ts(max_ts - cur_ts)
    if max_uid:
        cur_uid = z.assign_uids(1)
        if cur_uid <= max_uid:
            z.assign_uids(max_uid - cur_uid + 1)
    # watermark: engines serving reads at the snapshot watermark
    # (ProcCluster) must advance it past the restored timestamps, or
    # restored data stays invisible until the next live commit
    bump = getattr(cluster, "_move_bump_snapshot", None)
    if bump is not None:
        bump()
    cluster.mem.clear()
    METRICS.inc("restore_records_total", total)
    return total


def restore_engine(engine, backup_dir: str, until: Optional[int] = None) -> int:
    """Engine-shape dispatch for restore (the /admin/restore seam)."""
    cluster = getattr(engine, "cluster", engine)
    if hasattr(cluster, "_move_iter") and hasattr(cluster, "zero"):
        return restore_to_cluster(cluster, backup_dir, until=until)
    return restore(engine, backup_dir, until=until)
