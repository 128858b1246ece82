"""Change Data Capture: replicated committed-mutation event stream.

Mirrors dgraph/worker/cdc.go: tail committed transactions and
emit JSON events {meta: {commit_ts, seq}, type, event: {...}} to a
sink, at-least-once with a DURABLE checkpoint. The CDC attaches to any
engine — single-node Server, in-process DistributedCluster,
multi-process ProcCluster, or a ClusterFacade over either — and every
commit entry point feeds it: the serial per-txn paths and the
group-commit batch barriers (which run FIFO in commit-ts order, so the
sink sees events strictly ordered by commit_ts).

Durability/loss model (ref cdc.go:151 checkpoint via raft):

  - The checkpoint rides the engine's replicated storage: proposed
    through a group's raft log on clusters (every replica holds it —
    a new coordinator after leader failover resumes from it), plain
    KV-resident on a single Server.
  - Sink delivery happens on a dedicated emitter thread draining a
    BOUNDED queue (DGRAPH_TPU_CDC_QUEUE_MAX); a full queue blocks the
    committer (backpressure) rather than dropping events. Sink
    failures retry via conn/retry.RetryPolicy backoff; the checkpoint
    only advances after the sink accepted the batch (at-least-once).
  - A crash between sink write and checkpoint save — or a dead sink
    at process death — loses nothing: `replay_from_checkpoint()`
    (run at attach time when a checkpoint exists) scans the KV for
    versions above the checkpoint and re-emits them, closing the
    sink-crash event-loss window. Downstream consumers dedup on the
    deterministic per-event (commit_ts, seq) id, which is stable
    across live emission and replay (events sort canonically before
    seq assignment).

Sinks: ndjson file (the reference's file sink) or a Python callback
(the Kafka-sink seam; admin/handlers.sink_for maps kafka:// URIs when
kafka-python is installed).
"""

from __future__ import annotations

import json
import logging
import struct
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from dgraph_tpu_torch.conn import faults
from dgraph_tpu_torch.conn.retry import Deadline, RetryPolicy
from dgraph_tpu_torch.posting.pl import (
    KIND_ROLLUP,
    OP_SET,
    Posting,
    decode_record,
)
from dgraph_tpu_torch.utils.observe import METRICS
from dgraph_tpu_torch.x import config, keys

CDC_CHECKPOINT_KEY = b"\x7fcdc_checkpoint"


def _jsonable(p: Posting):
    import datetime as _dt

    v = p.val().value
    if isinstance(v, _dt.datetime):
        # the shared RFC3339 formatter (query/valuefmt.py): CDC events
        # must round-trip through the live loader / RDF parser, and a
        # bare isoformat() without the Z suffix did not
        from dgraph_tpu_torch.query.valuefmt import rfc3339

        return rfc3339(v)
    if hasattr(v, "tolist"):
        return v.tolist()
    from decimal import Decimal

    if isinstance(v, Decimal):
        return float(v)
    return v


def events_for(commit_ts: int, deltas) -> List[dict]:
    """One commit's CDC events with deterministic (commit_ts, seq) ids:
    events sort by their canonical body before seq assignment, so a
    replayed commit reproduces byte-identical ids for dedup."""
    evs: List[dict] = []
    for key, posts in deltas.items():
        try:
            pk = keys.parse_key(bytes(key))
        except Exception:
            continue
        if not pk.is_data:
            continue  # index/reverse/count maintenance is derivable
        for p in posts:
            body = {
                "operation": "set" if p.op == OP_SET else "del",
                "uid": pk.uid,
                "attr": pk.attr,
                "namespace": pk.ns,
            }
            if p.is_value:
                try:
                    body["value"] = _jsonable(p)
                except Exception:
                    body["value"] = None
            else:
                body["value_uid"] = p.uid
            evs.append({"type": "mutation", "event": body})
    evs.sort(
        key=lambda e: json.dumps(e["event"], sort_keys=True, default=str)
    )
    for i, ev in enumerate(evs):
        ev["meta"] = {"commit_ts": int(commit_ts), "seq": i}
    return evs


def cdc_for_uri(engine, uri: str, **kw) -> "CDC":
    """Build a CDC for a sink URI: bare paths / file:// open the
    ndjson file sink directly; other schemes (kafka://) route through
    the admin/handlers.sink_for seam. ONE constructor shared by
    `dgraph-tpu alpha --cdc-file`/DGRAPH_TPU_CDC_SINK and the
    /admin/cdc endpoint, so the two cannot drift."""
    from urllib.parse import urlparse

    u = urlparse(uri)
    if u.scheme in ("", "file"):
        cdc = CDC(engine, sink_path=u.path or uri, **kw)
        cdc.sink_uri = uri
        return cdc
    from dgraph_tpu_torch.admin.handlers import sink_for

    sink = sink_for(uri)
    cdc = CDC(
        engine,
        sink_fn=lambda ev: sink.send(
            b"", json.dumps(ev, separators=(",", ":")).encode("utf-8")
        ),
        # the checkpoint must not advance past events still sitting in
        # a client-side producer buffer; close() must release the
        # producer, not just the (absent) file handle
        sink_flush=sink.flush,
        sink_close=sink.close,
        **kw,
    )
    cdc.sink_uri = uri
    return cdc


class _Hooks:
    """Engine-shape adapter: where the checkpoint lives and how the
    replay scan reads the store."""

    def __init__(self, engine):
        cluster = getattr(engine, "cluster", None)
        self.target = cluster if cluster is not None else engine
        t = self.target
        if hasattr(t, "remote_groups"):
            self.kind = "proc"
            self.gid = min(t.remote_groups)
        elif hasattr(t, "groups"):
            self.kind = "dist"
            self.gid = min(t.groups)
        else:
            self.kind = "server"
            self.gid = 0

    def read_view(self):
        if self.kind == "server":
            return self.target.kv
        return self.target.read_kv()

    def scan_above(self, since: int):
        """(key, versions-with-ts>since) for the replay scan. Cluster
        engines use the mover's PAGED, since-aware `_move_iter` per
        tablet (the server side filters below `since`, responses are
        byte-bounded) — replay cost scales with checkpoint LAG, not
        with total store size. The single-Server path filters its
        in-process iterator."""
        t = self.target
        if self.kind != "server" and hasattr(t, "_move_iter"):
            for pred in sorted(t.zero.tablets):
                gid = t.zero.belongs_to(pred)
                if gid is None:
                    continue
                for prefix in (
                    keys.PredicatePrefix(pred),
                    keys.SplitPredicatePrefix(pred),
                ):
                    for key, vers in t._move_iter(
                        gid, prefix, 1 << 62, since, 8 << 20
                    ):
                        vers = [(ts, v) for ts, v in vers if ts > since]
                        if vers:
                            yield key, vers
            return
        for key, vers in self.read_view().iterate_versions(b"", 1 << 62):
            vers = [(ts, v) for ts, v in vers if ts > since]
            if vers:
                yield key, vers

    def ckpt_get(self) -> int:
        t = self.target
        if self.kind == "server":
            got = t.kv.get(CDC_CHECKPOINT_KEY, 1 << 62)
            return struct.unpack("<Q", got[1])[0] if got else 0
        if self.kind == "dist":
            got = t.groups[self.gid].any_replica().kv.get(
                CDC_CHECKPOINT_KEY, 1 << 62
            )
            return struct.unpack("<Q", got[1])[0] if got else 0
        from dgraph_tpu_torch.conn.messages import GetRequest

        got = t.remote_groups[self.gid].read(
            "kv.get", GetRequest(key=CDC_CHECKPOINT_KEY, ts=1 << 62)
        )
        return struct.unpack("<Q", got.value)[0] if got.found else 0

    def ckpt_put(self, ts: int) -> None:
        blob = struct.pack("<Q", int(ts))
        t = self.target
        if self.kind == "server":
            t.kv.put(CDC_CHECKPOINT_KEY, int(ts), blob)
        elif self.kind == "dist":
            # replicated: the checkpoint is a raft-applied delta, so
            # every replica (and any future coordinator) holds it
            t._propose_and_wait(
                self.gid, ("delta", [(CDC_CHECKPOINT_KEY, int(ts), blob)])
            )
        else:
            t.remote_groups[self.gid].propose(
                ("delta", [(CDC_CHECKPOINT_KEY, int(ts), blob)])
            )


class CDC:
    def __init__(
        self,
        engine,
        sink_path: Optional[str] = None,
        sink_fn: Optional[Callable[[dict], None]] = None,
        queue_max: Optional[int] = None,
        retry: Optional[RetryPolicy] = None,
        replay: bool = True,
        sink_flush: Optional[Callable[[], None]] = None,
        sink_close: Optional[Callable[[], None]] = None,
    ):
        self.hooks = _Hooks(engine)
        self.engine = engine
        self.sink_path = sink_path
        self.sink_uri = sink_path  # cdc_for_uri overrides for kafka://
        self.sink_fn = sink_fn
        self._sink_flush = sink_flush
        self._sink_close = sink_close
        self._f = open(sink_path, "a") if sink_path else None
        self._retry = retry or RetryPolicy(base=0.05, mult=2.0, cap=1.0)
        self._max = int(queue_max or config.get("CDC_QUEUE_MAX"))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # (commit_ts, events, replayed)
        self._depth = 0
        self._stop = False
        self.dead: Optional[BaseException] = None
        # the checkpoint never regresses: a replayed (old-ts) batch
        # delivered after a newer live commit must not rewind it
        self._ckpt_saved = self.hooks.ckpt_get()
        METRICS.set_gauge("cdc_emitter_dead", 0)
        self._thread = threading.Thread(
            target=self._emit_loop, daemon=True, name="cdc-emitter"
        )
        self._thread.start()
        # attach to the commit paths BEFORE the replay scan: a commit
        # landing mid-scan is then caught live (possibly ALSO replayed
        # — a harmless duplicate the (commit_ts, seq) ids dedup),
        # never lost in the scan/attach window with the checkpoint
        # advancing past it
        engine._cdc = self
        if self.hooks.target is not engine:
            self.hooks.target._cdc = self
        if replay and self._ckpt_saved > 0:
            self.replay_from_checkpoint()

    # -- checkpoint ---------------------------------------------------------

    @property
    def checkpoint(self) -> int:
        return self.hooks.ckpt_get()

    def _save_checkpoint(self, ts: int):
        if ts <= self._ckpt_saved:
            return  # monotonic: replayed batches never rewind it
        self.hooks.ckpt_put(ts)
        self._ckpt_saved = int(ts)
        METRICS.set_gauge("cdc_checkpoint_ts", int(ts))

    # -- ingest (called by every engine commit path) ------------------------

    def emit_commit(self, commit_ts: int, deltas):
        """Queue one commit's events for sink delivery. Called in
        commit-ts order by the engines (serial paths under the commit
        lock; group-commit batches from their FIFO barriers). Blocks
        on a full queue — backpressure, never silent loss."""
        events = events_for(commit_ts, deltas)
        if events:
            self._enqueue(commit_ts, events, replayed=False)

    def _enqueue(self, commit_ts: int, events: List[dict], replayed: bool):
        with self._cv:
            waited = False
            while (
                self._depth + len(events) > self._max
                and self._depth > 0
                and not self._stop
                and self.dead is None
            ):
                if not waited:
                    METRICS.inc("cdc_backpressure_waits_total")
                    waited = True
                self._cv.wait(timeout=0.5)
            if self._stop or self.dead is not None:
                # the emitter is gone: the events stay recoverable via
                # replay-from-checkpoint (checkpoint never advanced)
                return
            self._q.append((int(commit_ts), events, replayed))
            self._depth += len(events)
            METRICS.set_gauge("cdc_queue_depth", self._depth)
            self._cv.notify_all()

    # -- emitter ------------------------------------------------------------

    def _emit_loop(self):
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(timeout=0.2)
                if not self._q and self._stop:
                    return
                # drain the WHOLE backlog per wakeup: one sink pass and
                # ONE checkpoint persist (a raft propose on clusters)
                # amortized over every queued commit — per-commit
                # checkpointing would throttle all commits to the
                # raft-proposal rate through the queue's backpressure
                batches = list(self._q)
            try:
                self._deliver(batches)
            except BaseException as e:
                # InjectedCrash (simulated sink/emitter death) or a
                # sink that stayed broken through close(): events stay
                # queued, the checkpoint stays put — replay recovers.
                # LOUD, not silent: the gauge + status probe surface it
                # (a dead emitter defers every later commit to replay).
                with self._cv:
                    self.dead = e
                    self._cv.notify_all()
                METRICS.set_gauge("cdc_emitter_dead", 1)
                logging.getLogger(__name__).warning(
                    "cdc emitter died (%s: %s); events defer to "
                    "replay-from-checkpoint on re-enable/restart",
                    type(e).__name__, e,
                )
                return
            with self._cv:
                for _ in batches:
                    _ts, evs, _rp = self._q.popleft()
                    self._depth -= len(evs)
                METRICS.set_gauge("cdc_queue_depth", self._depth)
                self._cv.notify_all()

    def _deliver(self, batches):
        faults.syncpoint("cdc.emit")
        attempt = 0
        while True:
            try:
                for _ts, events, _rp in batches:
                    self._send(events)
                break
            except faults.InjectedCrash:
                raise
            except Exception:
                METRICS.inc("cdc_sink_retries_total")
                attempt += 1
                if self._stop:
                    raise  # closing with a dead sink: give up, replay heals
                self._retry.sleep(attempt)
        n = n_replayed = 0
        for _ts, events, replayed in batches:
            n += len(events)
            if replayed:
                n_replayed += len(events)
        METRICS.inc("cdc_events_total", n)
        if n_replayed:
            METRICS.inc("cdc_replayed_events_total", n_replayed)
        # at-least-once: the sink accepted everything BEFORE the
        # checkpoint advances; a crash between the two re-emits on
        # replay and the (commit_ts, seq) ids dedup downstream. The
        # save itself retries — a transient oracle/group hiccup must
        # not kill the stream.
        faults.syncpoint("cdc.checkpoint")
        top = max(ts for ts, _e, _r in batches)
        attempt = 0
        while True:
            try:
                self._save_checkpoint(top)
                return
            except faults.InjectedCrash:
                raise
            except Exception:
                attempt += 1
                if self._stop or attempt > 8:
                    # give up: checkpoint stays behind — strictly MORE
                    # replay on recovery, never loss
                    return
                self._retry.sleep(attempt)

    def _send(self, events: List[dict]):
        if self._f is not None:
            for ev in events:
                self._f.write(json.dumps(ev, separators=(",", ":")) + "\n")
            self._f.flush()
        if self.sink_fn is not None:
            for ev in events:
                self.sink_fn(ev)
        if self._sink_flush is not None:
            # buffering sinks (Kafka producer) must durably accept the
            # batch BEFORE the checkpoint advances; a flush failure
            # retries the whole batch like any send failure
            self._sink_flush()

    # -- replay -------------------------------------------------------------

    def replay_from_checkpoint(self) -> int:
        """Re-emit every committed version above the durable checkpoint
        by scanning the KV (ref cdc.go's re-read of raft entries after
        restart): closes the window where a sink crash lost events that
        were committed but never delivered, and hands the stream over
        after a leader/coordinator failover. Returns events queued."""
        ckpt = self.checkpoint
        per_ts: Dict[int, Dict[bytes, list]] = {}
        for key, vers in self.hooks.scan_above(ckpt):
            try:
                pk = keys.parse_key(bytes(key))
            except Exception:
                continue
            if not pk.is_data:
                continue
            for ts, rec in vers:
                try:
                    kind, pack, posts, _splits = decode_record(bytes(rec))
                except Exception:
                    continue
                posts = list(posts)
                if kind == KIND_ROLLUP and pack is not None:
                    # a rollup above the checkpoint holds the full uid
                    # set; re-emitting it as sets is at-least-once
                    from dgraph_tpu_torch.codec import uidpack as _up

                    posts.extend(
                        Posting(uid=int(u), op=OP_SET)
                        for u in _up.decode(pack)
                    )
                per_ts.setdefault(int(ts), {}).setdefault(
                    bytes(key), []
                ).extend(posts)
        n = 0
        for ts in sorted(per_ts):
            events = events_for(ts, per_ts[ts])
            if events:
                self._enqueue(ts, events, replayed=True)
                n += len(events)
        return n

    # -- lifecycle ----------------------------------------------------------

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the queue drained (or the emitter died / the
        bound expired). Returns True when fully drained."""
        dl = Deadline.after(timeout_s)
        with self._cv:
            while self._q and self.dead is None and not dl.expired():
                self._cv.wait(timeout=0.2)
            return not self._q

    def close(self):
        self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._sink_close is not None:
            try:
                self._sink_close()
            except Exception:
                pass  # a dead sink at close: replay heals on re-enable
            self._sink_close = None
        for host in (self.engine, self.hooks.target):
            if getattr(host, "_cdc", None) is self:
                host._cdc = None
