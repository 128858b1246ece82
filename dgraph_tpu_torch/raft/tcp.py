"""TCP transport for Raft: the cross-host network seam.

The reference's conn/node.go batches raft messages onto long-lived gRPC
streams between peers (BatchAndSendMessages:338, streamMessages:398). This
is the socket equivalent for dgraph-tpu: one listener per node, persistent
outbound connections per peer with automatic reconnect, length-prefixed
frames via conn/frame.py — small control messages stay JSON; bulk
payloads (snapshot installs, big append batches) ride as raw
zlib-compressed blobs (the snappy framing of conn/snappy.go +
worker/snapshot.go:177). Implements the same send/drain interface as
InProcNetwork, so RaftNode is unchanged.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.conn import faults
from dgraph_tpu_torch.conn.frame import MAX_FRAME, pack_body, unpack_body
from dgraph_tpu_torch.conn.messages import RaftEnvelope
from dgraph_tpu_torch.raft.raft import Message
from dgraph_tpu_torch.utils.observe import TRACER, parse_traceparent

_LEN = struct.Struct(">I")


class TcpNetwork:
    """Per-process endpoint: local inboxes + outbound peer connections."""

    def __init__(self, peers: Dict[int, Tuple[str, int]]):
        """peers: node_id -> (host, port) for every cluster member."""
        self.peers = peers
        self.inboxes: Dict[int, List[Message]] = {}
        self.lock = threading.Lock()
        self._conns: Dict[int, socket.socket] = {}
        # serializes connect + sendall per peer: frames must not interleave
        # when several locally-hosted nodes write to the same remote socket
        self._send_locks: Dict[int, threading.Lock] = {}
        self._servers: List[socketserver.ThreadingTCPServer] = []
        self.down: set = set()  # local fault injection parity
        self._drop_logged: set = set()

    # -- server side ---------------------------------------------------------

    def register(self, node_id: int):
        """Start listening for this (locally hosted) node."""
        self.inboxes[node_id] = []
        host, port = self.peers[node_id]
        net = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    hdr = self.rfile.read(_LEN.size)
                    if len(hdr) < _LEN.size:
                        return
                    (n,) = _LEN.unpack(hdr)
                    if n > MAX_FRAME:
                        return  # corrupt length header: drop the conn
                    body = self.rfile.read(n)
                    if len(body) < n:
                        return
                    try:
                        env = RaftEnvelope.decode(body)
                        msg = Message(
                            kind=env.kind, frm=env.frm, to=env.to,
                            term=env.term,
                            payload=unpack_body(env.payload)
                            if env.payload
                            else {},
                            trace=env.trace,
                        )
                    except (ValueError, KeyError, TypeError):
                        continue
                    plan = faults.active()
                    if plan is not None:
                        act = plan.decide("raft_recv", str(msg.frm), msg.kind)
                        if act is not None:
                            if act.action in ("drop", "partition"):
                                continue
                            if act.action == "disconnect":
                                return
                            if act.action == "delay":
                                time.sleep(act.delay_s)
                    if msg.trace:
                        # a traced proposal's replication hop: join the
                        # proposer's trace so the follower-side arrival
                        # is attributable in the merged view
                        ctx = parse_traceparent(msg.trace)
                        if ctx is not None:
                            with TRACER.span(
                                "raft_recv", parent=ctx, kind=msg.kind,
                                frm=msg.frm, to=msg.to,
                            ):
                                pass
                    with net.lock:
                        if msg.to in net.inboxes:
                            net.inboxes[msg.to].append(msg)

        class _Server(socketserver.ThreadingTCPServer):
            # must be set on the class: the constructor binds immediately,
            # and a restarting node must rebind through TIME_WAIT
            allow_reuse_address = True
            daemon_threads = True

        srv = _Server((host, port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self._servers.append(srv)
        # update port if OS-assigned (port=0)
        self.peers[node_id] = srv.server_address[:2]

    # -- client side ---------------------------------------------------------

    def _conn_to(self, node_id: int) -> Optional[socket.socket]:
        s = self._conns.get(node_id)
        if s is not None:
            return s
        try:
            s = socket.create_connection(self.peers[node_id], timeout=1.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns[node_id] = s
            return s
        except OSError:
            return None

    def send(self, msg: Message):
        if msg.frm in self.down or msg.to in self.down:
            return
        if msg.to in self.inboxes:  # local fast path
            with self.lock:
                self.inboxes[msg.to].append(msg)
            return
        act = None
        plan = faults.active()
        if plan is not None:
            act = plan.decide("raft_send", str(msg.to), msg.kind)
            if act is not None:
                if act.action in ("drop", "partition"):
                    return  # lost on the wire: raft retries via timeouts
                if act.action == "disconnect":
                    with self.lock:
                        s = self._conns.pop(msg.to, None)
                    if s is not None:
                        try:
                            s.close()
                        except OSError:
                            pass
                    return
                if act.action == "delay":
                    time.sleep(act.delay_s)
        try:
            body = RaftEnvelope(
                kind=msg.kind, frm=msg.frm, to=msg.to, term=msg.term,
                payload=pack_body(msg.payload) if msg.payload else b"",
                # the proposer's trace context (RaftNode stamps it on
                # the append broadcast that replicates a traced
                # proposal; "" on the untraced tick/heartbeat plane) —
                # msg.trace is the ONLY stamping point: sends happen on
                # the tick thread, so any ambient context here would
                # belong to an unrelated trace
                trace=msg.trace,
            ).encode()
            frame = _LEN.pack(len(body)) + body
        except (TypeError, ValueError):
            # an unserializable payload must never kill the tick thread —
            # but a silent drop would retry forever, so log once per type
            tname = type(msg.payload).__name__
            if tname not in self._drop_logged:
                self._drop_logged.add(tname)
                import logging

                logging.getLogger("dgraph_tpu_torch.raft.tcp").error(
                    "dropping unserializable raft payload (%s) — "
                    "these messages can never succeed", tname,
                )
            return
        with self.lock:
            plock = self._send_locks.setdefault(msg.to, threading.Lock())
        with plock:
            s = self._conn_to(msg.to)
            if s is None:
                return  # peer unreachable: raft retries via timeouts
            try:
                s.sendall(frame)
                if act is not None and act.action == "dup":
                    s.sendall(frame)  # duplicate delivery
            except OSError:
                self._conns.pop(msg.to, None)
                try:
                    s.close()
                except OSError:
                    pass

    def drain(self, node_id: int) -> List[Message]:
        with self.lock:
            msgs = self.inboxes.get(node_id, [])
            self.inboxes[node_id] = []
            return msgs

    def close(self):
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()
        with self.lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
