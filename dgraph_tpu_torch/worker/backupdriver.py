"""Distributed online backup driver: journaled, resumable, move-aware.

Mirrors the reference's worker/backup*.go coordinator: one cluster-wide
snapshot watermark `read_ts` is pinned up front (zero.read_ts() waits
out every commit leased below it, so the snapshot is complete), then
every tablet streams out of its owning group's LEADER via the same
paged `_move_iter` primitive the tablet mover uses (leader-only: a
follower may lag the applied index, and a backup must never silently
miss a committed version) into per-group chunked files with per-record
CRCs (admin/backup.py owns the file format).

Crash safety: every phase is journaled through the shared `AppendLog`
base (worker/tabletmove.py) BEFORE its effects become load-bearing —

  BEGIN        {idx, since, read_ts}   pinned snapshot, durable first
  GROUP_DONE   {gid, files, preds}     a group's chunk files are fully
                                       written and named; the preds
                                       they cover are captured
  COMMIT       idx                     the manifest entry landed

The manifest is committed LAST and atomically (tmp + os.replace), so a
coordinator crash at any boundary leaves a backup that is *detectably*
incomplete — restore only ever reads files the manifest names, and
`resume()` either finishes the journaled backup at its pinned read_ts
(groups already journaled keep their files; the rest re-stream, with
partial chunk files overwritten by deterministic names) or `abort()`
deletes the partials and clears the journal. A crash between the
manifest commit and the journal COMMIT is healed by resume() noticing
the entry already landed.

Move coordination (the mid-move capture contract): a predicate inside
an in-flight move (`zero.moves_hint()`) is drained first — the backup
waits out the bounded fence — and after streaming, the owner is
re-checked; if the flip raced the copy (the tablet now lives
elsewhere, so the source may be mid-drop), the buffered records are
discarded and the tablet re-streams from its new owner. Every tablet
is therefore captured exactly once, even mid-move.

Chaos coverage drives `conn/faults.syncpoint` crash rules at every
journaled boundary (backup.begin/group/manifest) under the bank
workload with a tablet move in flight — tests/test_ops_plane.py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from dgraph_tpu_torch.conn import faults
from dgraph_tpu_torch.conn.retry import Deadline, poll_policy
from dgraph_tpu_torch.utils.observe import METRICS, TRACER
from dgraph_tpu_torch.x import config, keys


class BackupJournal:
    """Durable phase journal of ONE in-flight backup, in the backup
    directory itself (so resume works from the destination alone).
    AppendLog record kinds fold to the latest un-COMMITted BEGIN."""

    _K_BEGIN = 1
    _K_GROUP = 2
    _K_COMMIT = 3

    def __init__(self, path: str):
        from dgraph_tpu_torch.worker.tabletmove import AppendLog

        self._log = AppendLog(
            path, kinds=(self._K_BEGIN, self._K_GROUP, self._K_COMMIT),
            sync=True,
        )

    def begin(self, idx: int, since: int, read_ts: int):
        self._log._append(
            self._K_BEGIN,
            {"idx": int(idx), "since": int(since), "read_ts": int(read_ts)},
        )

    def group_done(self, gid: int, files: List[dict], preds: List[str]):
        self._log._append(
            self._K_GROUP,
            {"gid": int(gid), "files": list(files), "preds": list(preds)},
        )

    def commit(self, idx: int):
        self._log._append(self._K_COMMIT, int(idx))

    def pending(self) -> Optional[dict]:
        """The un-COMMITted backup, or None: {idx, since, read_ts,
        groups: [group_done payloads]}."""
        cur: Optional[dict] = None
        for kind, obj in self._log._scan():
            if kind == self._K_BEGIN:
                cur = dict(obj, groups=[])
            elif kind == self._K_GROUP and cur is not None:
                cur["groups"].append(obj)
            elif kind == self._K_COMMIT:
                if cur is not None and cur["idx"] == obj:
                    cur = None
        return cur

    def close(self):
        self._log.close()


class RestoreJournal:
    """Idempotent-resume journal for an online restore: one DONE record
    per applied (entry, group, chunk) proposal. Re-running a crashed
    restore skips completed chunks; re-proposing an uncertain one is
    harmless (same-ts puts apply idempotently)."""

    _K_DONE = 1

    def __init__(self, path: str):
        from dgraph_tpu_torch.worker.tabletmove import AppendLog

        self._log = AppendLog(path, kinds=(self._K_DONE,), sync=True)

    def mark(self, token: str):
        self._log._append(self._K_DONE, str(token))

    def done(self) -> set:
        return {obj for _k, obj in self._log._scan()}

    def close(self):
        self._log.close()


def _moving(cluster, pred: str) -> bool:
    hint = cluster.zero.moves_hint()
    return pred in hint


def wait_move_drained(cluster, pred: str, timeout_s: float = 0.0):
    """Block until `pred` has no move in flight (the mover's fence is
    bounded by MOVE_FENCE_DEADLINE_S, so this converges). The backup
    never copies a tablet mid-fence: the flip could land between the
    page reads and tear the capture across two owners."""
    if not _moving(cluster, pred):
        return
    METRICS.inc("backup_moves_waited_total")
    budget = timeout_s or (
        float(config.get("MOVE_FENCE_DEADLINE_S")) + 30.0
    )
    dl = Deadline.after(budget)
    poll = poll_policy(0.05)
    attempt = 0
    while _moving(cluster, pred):
        if dl.expired():
            raise RuntimeError(
                f"backup: move of {pred!r} did not drain within "
                f"{budget:.0f}s"
            )
        attempt += 1
        poll.sleep(attempt, dl)


class BackupCoordinator:
    """Drives one distributed backup (or resumes a journaled one) over
    any cluster exposing the mover's read primitives:

      zero            ZeroService (tablets, moves_hint, read_ts lease)
      _move_iter(gid, prefix, ts, since_ts, page_bytes)
                      paged leader-only versioned reads
      _move_group_ids()
    """

    def __init__(self, cluster, backup_dir: str):
        self.c = cluster
        self.dir = backup_dir
        os.makedirs(backup_dir, exist_ok=True)

    # -- entry points -------------------------------------------------------

    def backup(self, incremental: bool = True) -> dict:
        """Run a new backup — after finishing any journaled one first
        (a crashed coordinator's backup resumes at its pinned — and by
        now stale — read_ts, so the chain stays gapless; the backup
        the caller asked for then runs as a FRESH snapshot on top)."""
        from dgraph_tpu_torch.admin import backup as bk

        journal = BackupJournal(self._journal_path())
        try:
            pend = journal.pending()
            if pend is not None:
                METRICS.inc("backup_resumed_total")
                self._run(journal, pend)
            manifest = bk.load_manifest(self.dir)
            since = 0
            if incremental:
                # a full backup (since=0) restarts the chain and never
                # replays the old prefix — only an incremental needs
                # the existing chain to be sound
                chain = bk.validate_chain(manifest)
                since = chain[-1]["read_ts"] if chain else 0
            read_ts = self.c.zero.zero.read_ts()
            idx = len(manifest["backups"]) + 1
            st = {"idx": idx, "since": since, "read_ts": read_ts,
                  "groups": []}
            journal.begin(idx, since, read_ts)
            faults.syncpoint("backup.begin")
            return self._run(journal, st)
        finally:
            journal.close()

    def resume(self) -> Optional[dict]:
        """Finish a journaled in-flight backup; None when none pending."""
        journal = BackupJournal(self._journal_path())
        try:
            pend = journal.pending()
            if pend is None:
                return None
            METRICS.inc("backup_resumed_total")
            return self._run(journal, pend)
        finally:
            journal.close()

    def abort(self) -> bool:
        """Drop a journaled in-flight backup: delete its chunk files
        and journal a COMMIT-less clear (a fresh journal BEGIN will
        supersede). The manifest never saw the entry, so the chain is
        untouched. Returns True when something was aborted."""
        journal = BackupJournal(self._journal_path())
        try:
            pend = journal.pending()
            if pend is None:
                return False
            for g in pend["groups"]:
                for f in g["files"]:
                    try:
                        os.remove(os.path.join(self.dir, f["name"]))
                    except FileNotFoundError:
                        pass
            # stray partials of un-journaled groups share the idx stem
            stem = f"backup-{pend['idx']:04d}-"
            for name in os.listdir(self.dir):
                if name.startswith(stem):
                    os.remove(os.path.join(self.dir, name))
            journal.commit(pend["idx"])
            return True
        finally:
            journal.close()

    # -- internals ----------------------------------------------------------

    def _journal_path(self) -> str:
        return os.path.join(self.dir, "backup.journal")

    def _run(self, journal: BackupJournal, st: dict) -> dict:
        from dgraph_tpu_torch.admin import backup as bk

        idx, since, read_ts = st["idx"], st["since"], st["read_ts"]
        manifest = bk.load_manifest(self.dir)
        if len(manifest["backups"]) >= idx:
            # crash landed between the manifest commit and the journal
            # COMMIT: the entry is already durable — just finalize
            entry = manifest["backups"][idx - 1]
            journal.commit(idx)
            return entry
        done_preds = {
            p for g in st["groups"] for p in g["preds"]
        }
        files: List[dict] = [
            dict(f) for g in st["groups"] for f in g["files"]
        ]
        # seed each group's chunk sequence from the journaled file
        # NAMES (a gid can appear in several GROUP_DONE records across
        # resumes; counting files would reuse — and overwrite — a
        # journaled chunk whose sha256 is already fixed)
        file_seq: Dict[int, int] = {}
        for f in files:
            seq = int(f["name"].rsplit("-", 1)[1].split(".")[0])
            gid = int(f["gid"])
            file_seq[gid] = max(file_seq.get(gid, 0), seq)
        records = sum(int(f.get("records", 0)) for f in files)
        chunk = max(1 << 16, int(config.get("BACKUP_CHUNK_BYTES")))

        with TRACER.span("backup", idx=idx):
            remaining = [
                p for p in sorted(self.c.zero.tablets)
                if p not in done_preds
            ]
            # group by current owner; ownership is re-checked per pred
            by_group: Dict[int, List[str]] = {}
            for pred in remaining:
                wait_move_drained(self.c, pred)
                gid = self.c.zero.belongs_to(pred)
                if gid is None:
                    continue
                by_group.setdefault(int(gid), []).append(pred)
            for gid in sorted(by_group):
                gfiles, gpreds, n = self._stream_group(
                    idx, gid, by_group[gid], read_ts, since, chunk,
                    file_seq,
                )
                files.extend(gfiles)
                records += n
                journal.group_done(gid, gfiles, gpreds)
                faults.syncpoint("backup.group", gid)

        entry = {
            "since": int(since),
            "read_ts": int(read_ts),
            "records": int(records),
            "type": "incremental" if since else "full",
            "files": files,
            "schema": self._schema_text(),
        }
        manifest["backups"].append(entry)
        bk.save_manifest(self.dir, manifest)
        faults.syncpoint("backup.manifest")
        journal.commit(idx)
        METRICS.inc("backup_records_total", records)
        METRICS.inc("backup_files_total", len(files))
        return entry

    def _stream_group(
        self, idx: int, gid: int, preds: List[str], read_ts: int,
        since: int, chunk: int, file_seq: Dict[int, int],
    ):
        """Stream `preds` out of group `gid` into chunked files.
        Returns (file metas, captured preds, record count). A predicate
        whose owner flips mid-copy re-streams from the new owner; its
        buffered records are discarded first, so it lands exactly once."""
        from dgraph_tpu_torch.admin.backup import BackupWriter

        writer = BackupWriter(
            self.dir, idx, gid, chunk, seq0=file_seq.get(gid, 0)
        )
        captured: List[str] = []
        total = 0
        for pred in preds:
            for attempt in range(4):
                cur = self.c.zero.belongs_to(pred)
                if cur is None:
                    break
                wait_move_drained(self.c, pred)
                # stream STRAIGHT into the writer (memory stays bounded
                # to one chunk, not one tablet); the mark lets a
                # detected ownership flip discard exactly this
                # tablet's records
                m = writer.mark()
                n = self._stream_pred(writer, pred, int(cur), read_ts,
                                      since)
                if (
                    self.c.zero.belongs_to(pred) == cur
                    and not _moving(self.c, pred)
                ):
                    total += n
                    captured.append(pred)
                    break
                # the flip raced the copy: the source may be mid-drop —
                # discard this tablet's records and retry against the
                # new owner
                writer.rollback(m)
                METRICS.inc("backup_move_races_total")
            else:
                raise RuntimeError(
                    f"backup: tablet {pred!r} kept moving across 4 "
                    f"capture attempts"
                )
        file_seq[gid] = writer.seq
        return writer.finish(), captured, total

    def _stream_pred(
        self, writer, pred: str, gid: int, read_ts: int, since: int
    ) -> int:
        n = 0
        for prefix in (
            keys.PredicatePrefix(pred),
            keys.SplitPredicatePrefix(pred),
        ):
            for key, vers in self.c._move_iter(
                gid, prefix, read_ts, since, 8 << 20
            ):
                for ts, val in vers:  # newest first; order is free here
                    if ts <= since:
                        break
                    writer.add(bytes(key), int(ts), bytes(val))
                    n += 1
        return n

    def _schema_text(self) -> str:
        """The cluster's schema as alterable text: cluster engines keep
        schema coordinator-side (not in the group KVs), so the backup
        must carry it for restore to reproduce types/indexes."""
        from dgraph_tpu_torch.admin.export import _schema_line

        lines = []
        schema = getattr(self.c, "schema", None)
        if schema is None:
            return ""
        for pred in schema.predicates():
            su = schema.get(pred)
            if su is not None and not pred.startswith("dgraph."):
                lines.append(_schema_line(su))
        for name in schema.types():
            tu = schema.get_type(name)
            if tu is not None:
                fields = "\n  ".join(tu.fields)
                lines.append(f"type {name} {{\n  {fields}\n}}")
        return "\n".join(lines) + ("\n" if lines else "")
