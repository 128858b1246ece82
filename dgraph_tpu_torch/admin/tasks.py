"""Async ops task queue: serialized background backup/export/rollup.

Mirrors dgraph/worker/queue.go: heavyweight admin operations run
one-at-a-time off the request path, identified by 64-bit task ids packing
kind + timestamp (queue.go:333), with status queryable afterwards — and
the reference's draft.go ops registry rule (startTask:106) that rollup/
backup/export are mutually exclusive falls out of the single-worker queue.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

KIND_BACKUP = 1
KIND_EXPORT = 2
KIND_ROLLUP = 3
KIND_MOVE = 4
KIND_RESTORE = 5

_KIND_NAMES = {
    KIND_BACKUP: "backup",
    KIND_EXPORT: "export",
    KIND_ROLLUP: "rollup",
    KIND_MOVE: "move",
    KIND_RESTORE: "restore",
}

QUEUED = "Queued"
RUNNING = "Running"
SUCCESS = "Success"
FAILED = "Failed"


_MAX_DONE_TASKS = 1000  # completed records kept for status queries


class TaskQueue:
    def __init__(self):
        self._q: "queue.Queue[int]" = queue.Queue()
        self._tasks: Dict[int, dict] = {}
        self._done_order: list = []
        self._events: Dict[int, threading.Event] = {}
        self._lock = threading.Lock()
        self._counter = 0
        self._stop = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _new_id(self, kind: int) -> int:
        """64-bit id: kind (8 bits) | unix-ts (32) | seq (24)
        (ref queue.go TaskMeta packing)."""
        with self._lock:
            self._counter = (self._counter + 1) & 0xFFFFFF
            return (kind << 56) | (int(time.time()) << 24) | self._counter

    def enqueue(self, kind: int, fn: Callable[[], Any]) -> int:
        tid = self._new_id(kind)
        with self._lock:
            self._tasks[tid] = {
                "id": f"{tid:#x}",
                "kind": _KIND_NAMES.get(kind, "?"),
                "status": QUEUED,
                "queued_at": time.time(),
                "result": None,
                "error": None,
            }
        with self._lock:
            self._events[tid] = threading.Event()
        self._q.put((tid, fn))
        return tid

    def status(self, tid: int) -> Optional[dict]:
        with self._lock:
            t = self._tasks.get(tid)
            return dict(t) if t else None

    def list(self) -> list:
        with self._lock:
            return [dict(t) for t in self._tasks.values()]

    def wait(self, tid: int, timeout: float = 30.0) -> dict:
        with self._lock:
            ev = self._events.get(tid)
        if ev is not None:
            ev.wait(timeout)
        return self.status(tid) or {}

    def _loop(self):
        while not self._stop:
            try:
                tid, fn = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._lock:
                self._tasks[tid]["status"] = RUNNING
            try:
                result = fn()
                with self._lock:
                    self._tasks[tid]["status"] = SUCCESS
                    self._tasks[tid]["result"] = result
            except Exception as e:  # noqa: BLE001 — task errors are recorded
                with self._lock:
                    self._tasks[tid]["status"] = FAILED
                    self._tasks[tid]["error"] = str(e)
            with self._lock:
                ev = self._events.pop(tid, None)
                # bound the retained history (ref queue.go ages out metadata)
                self._done_order.append(tid)
                while len(self._done_order) > _MAX_DONE_TASKS:
                    old = self._done_order.pop(0)
                    self._tasks.pop(old, None)
            if ev is not None:
                ev.set()

    def close(self):
        self._stop = True
        self._worker.join(timeout=2)


def enqueue_backup(server, dest: str, **kw) -> int:
    from dgraph_tpu_torch.admin.backup import backup_engine

    tq = _queue_of(server)
    return tq.enqueue(KIND_BACKUP, lambda: backup_engine(server, dest, **kw))


def enqueue_restore(server, src: str, **kw) -> int:
    from dgraph_tpu_torch.admin.backup import restore_engine

    tq = _queue_of(server)
    return tq.enqueue(
        KIND_RESTORE, lambda: {"records": restore_engine(server, src, **kw)}
    )


def enqueue_move(cluster, pred: str, dst_group: int) -> int:
    tq = _queue_of(cluster)
    return tq.enqueue(KIND_MOVE, lambda: cluster.move_tablet(pred, dst_group))


def enqueue_export(server, out_dir: str, **kw) -> int:
    from dgraph_tpu_torch.admin.export import export

    tq = _queue_of(server)
    return tq.enqueue(KIND_EXPORT, lambda: export(server, out_dir, **kw))


def enqueue_rollup(server, **kw) -> int:
    from dgraph_tpu_torch.posting.rollup import rollup_all

    tq = _queue_of(server)
    return tq.enqueue(KIND_ROLLUP, lambda: rollup_all(server, **kw))


_QUEUE_CREATE_LOCK = threading.Lock()


def _queue_of(server) -> TaskQueue:
    tq = getattr(server, "_task_queue", None)
    if tq is None:
        with _QUEUE_CREATE_LOCK:  # threaded HTTP handlers race here
            tq = getattr(server, "_task_queue", None)
            if tq is None:
                tq = server._task_queue = TaskQueue()
    return tq
