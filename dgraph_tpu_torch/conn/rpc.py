"""Request/response RPC over TCP: the conn/pool.go equivalent.

The reference maintains one gRPC ClientConn per peer inside a Pool with
health checks (conn/pool.go:52 Pool, :233 MonitorHealth, :292
IsHealthy). This is the socket equivalent for dgraph-tpu's cross-process
cluster: length-prefixed frames (conn/frame.py codec), persistent
pooled connections with reconnect, periodic heartbeat pings, and
per-peer health state with a circuit breaker (open after `max_misses`
consecutive failures; half-open probes ride the heartbeat, so a dead
peer costs a fail-fast instead of a full timeout per call).

Framing: 4-byte big-endian length + body (bounded by frame.MAX_FRAME),
where body is either plain JSON or conn/frame.py's binary multipart:
  request:  {"id": n, "m": method, "a": args[, "c": client_id, "q": seq]}
  response: {"id": n, "r": result} | {"id": n, "e": error_string}

`c`/`q` are the idempotency key: a connection-independent client id and
a per-logical-call sequence number, attached when the caller marks a
call `idem=True` (proposals, zero.exec, lease grants — anything whose
reconnect-and-resend must not double-apply). The server keeps a small
LRU of completed (client, seq) -> response, plus in-flight tracking so
a retransmit racing the original waits for it rather than re-running.

Failure handling is uniform (conn/retry.py): every call runs under a
Deadline (explicit, ambient via deadline_scope, or derived from the
timeout) with exponential-backoff + full-jitter retries, and the
transports consult conn/faults.py at the send/recv/resp points so chaos
schedules can deterministically drop/delay/duplicate/disconnect.

JSON (not pickle) on purpose: the wire should never execute code.
"""

from __future__ import annotations

import os
import socket
import socketserver
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from dgraph_tpu_torch.conn import faults
from dgraph_tpu_torch.conn.frame import MAX_FRAME, FrameError, pack_body, unpack_body
from dgraph_tpu_torch.conn.retry import Deadline, RetryPolicy
from dgraph_tpu_torch.utils.observe import (
    METRICS,
    TRACER,
    current_profile,
    parse_traceparent,
)

_LEN = struct.Struct(">I")


class RpcError(RuntimeError):
    pass


class PeerDownError(RpcError):
    """Fail-fast refusal: the peer's circuit is open (it missed
    `max_misses` consecutive probes). Heartbeat pings keep probing and
    close the circuit when the peer answers again."""


class OversizeFrameError(RpcError):
    """The frame we are about to SEND exceeds MAX_FRAME. Not retryable —
    the receiver would reject it every time; fail the call immediately
    with a clear error instead of resending until the deadline."""


def _send_frame(sock: socket.socket, obj: dict):
    body = pack_body(obj)
    if len(body) > MAX_FRAME:
        METRICS.inc("frame_oversize_total")
        raise OversizeFrameError(
            f"outgoing frame of {len(body)} bytes exceeds the "
            f"{MAX_FRAME}-byte cap (DGRAPH_TPU_MAX_FRAME_BYTES); bulk "
            f"payloads this large must stream in chunks"
        )
    sock.sendall(_LEN.pack(len(body)) + body)


def _respond(conn: socket.socket, resp: dict) -> bool:
    """Send a response frame; an oversized response degrades to a small
    error reply so the connection (and handler thread) survive."""
    try:
        _send_frame(conn, resp)
        return True
    except OversizeFrameError as e:
        try:
            _send_frame(conn, {"id": resp.get("id"), "e": f"RpcError: {e}"})
            return True
        except OSError:
            return False
    except OSError:
        return False


def _recv_frame(rfile) -> Optional[dict]:
    hdr = rfile.read(_LEN.size)
    if len(hdr) < _LEN.size:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        # a corrupt length header must not drive an n-byte allocation;
        # raising (a ValueError) makes both sides drop the connection
        METRICS.inc("frame_oversize_total")
        raise FrameError(f"frame length {n} exceeds {MAX_FRAME}-byte cap")
    body = rfile.read(n)
    if len(body) < n:
        return None
    return unpack_body(body)


class RpcServer:
    """Serves registered handlers; one thread per connection.

    Requests carrying an idempotency key (`c`, `q`) are deduplicated
    against a bounded LRU of completed responses, so a client resending
    after a lost ack cannot double-apply a non-idempotent handler."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 idem_cache: int = 1024, instance: str = ""):
        # per-process label stamped on rpc_server spans and piggybacked
        # profile fragments (alpha/zero processes set "alpha-<id>" etc.)
        self.instance = instance or f"pid{os.getpid()}"
        self.handlers: Dict[str, Callable[[dict], Any]] = {}
        self.register("ping", lambda a: {"pong": True, "t": time.time()})
        self._idem_cap = idem_cache
        self._idem: "OrderedDict[Tuple[str, int], dict]" = OrderedDict()
        self._inflight: Dict[Tuple[str, int], threading.Event] = {}
        self._idem_lock = threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                peer = "%s:%s" % tuple(self.client_address[:2])
                while True:
                    try:
                        req = _recv_frame(self.rfile)
                    except (OSError, ValueError, struct.error):
                        return  # oversized/corrupt frame: drop the conn
                    if req is None:
                        return
                    method = req.get("m") or ""
                    act = _fault("recv", peer, method)
                    if act is not None:
                        if act.action == "drop":
                            continue  # request lost before handling
                        if act.action in ("disconnect", "partition"):
                            return
                        if act.action == "delay":
                            time.sleep(act.delay_s)
                    resp = outer._dispatch(req)
                    act = _fault("resp", peer, method)
                    if act is not None:
                        if act.action == "drop":
                            continue  # applied, but the ack is lost
                        if act.action in ("disconnect", "partition"):
                            return
                        if act.action == "delay":
                            time.sleep(act.delay_s)
                        elif act.action == "dup":
                            if not _respond(self.connection, resp):
                                return
                    if not _respond(self.connection, resp):
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Server((host, port), Handler)
        self.addr: Tuple[str, int] = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )

    # -- request execution ---------------------------------------------------

    def _execute(self, req: dict) -> dict:
        """Run the handler. A request carrying a `tp` traceparent joins
        the caller's trace: its context is attached around the handler
        so server-side spans parent correctly, one rpc_server span
        covers the execution, and a profile fragment (instance, method,
        ms) rides back on the response (`p`) for the client's
        QueryProfile — the reference's per-query server-side latency
        attribution, made cross-process."""
        rid = req.get("id")
        method = req.get("m")
        fn = self.handlers.get(method)
        ctx = parse_traceparent(req["tp"]) if req.get("tp") else None
        token = TRACER.attach(ctx) if ctx is not None else None
        t0 = time.perf_counter()
        try:
            if fn is None:
                raise RpcError(f"no such method {method!r}")
            from dgraph_tpu_torch.conn.messages import Message, from_wire, to_wire

            args = req.get("a") or {}
            typed = from_wire(args)
            if ctx is not None:
                METRICS.inc("rpc_server_requests_total")
                with TRACER.span(
                    "rpc_server", method=method, instance=self.instance
                ):
                    result = fn(typed if typed is not None else args)
            else:
                result = fn(typed if typed is not None else args)
            if isinstance(result, Message):
                result = to_wire(result)
            resp = {"id": rid, "r": result}
        except Exception as e:  # surface to caller, keep serving
            resp = {"id": rid, "e": f"{type(e).__name__}: {e}"}
        finally:
            if token is not None:
                TRACER.detach(token)
        if ctx is not None:
            resp["p"] = {
                "i": self.instance,
                "m": method,
                "ms": round((time.perf_counter() - t0) * 1e3, 3),
            }
        return resp

    def _dispatch(self, req: dict) -> dict:
        """Execute with idempotency-key dedup: a completed (client, seq)
        returns its cached response; a retransmit racing the original
        waits for it instead of re-running the handler."""
        cid, seq = req.get("c"), req.get("q")
        if cid is None or seq is None:
            return self._execute(req)
        rid = req.get("id")
        try:
            key = (str(cid), int(seq))
        except (TypeError, ValueError):
            # a malformed key must not kill the connection (and every
            # pipelined request on it) — answer the one bad request
            return {"id": rid, "e": "RpcError: malformed idempotency key"}
        owner = False
        with self._idem_lock:
            hit = self._idem.get(key)
            if hit is not None:
                self._idem.move_to_end(key)
                METRICS.inc("idem_hits_total")
                return dict(hit, id=rid)
            ev = self._inflight.get(key)
            if ev is None:
                ev = self._inflight[key] = threading.Event()
                owner = True
        if not owner:
            METRICS.inc("idem_inflight_waits_total")
            ev.wait(timeout=30.0)
            with self._idem_lock:
                hit = self._idem.get(key)
            if hit is not None:
                METRICS.inc("idem_hits_total")
                return dict(hit, id=rid)
            return {"id": rid, "e": "RpcError: duplicate still in flight"}
        resp = None
        try:
            resp = self._execute(req)  # never raises (errors become "e")
            return resp
        finally:
            with self._idem_lock:
                if resp is not None:
                    self._idem[key] = {
                        k: v for k, v in resp.items() if k != "id"
                    }
                    while len(self._idem) > self._idem_cap:
                        self._idem.popitem(last=False)
                self._inflight.pop(key, None)
            ev.set()

    # -- lifecycle -----------------------------------------------------------

    def register(self, method: str, fn: Callable[[dict], Any]):
        self.handlers[method] = fn

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def _fault(point: str, peer, method: str = ""):
    plan = faults.active()
    if plan is None:
        return None
    return plan.decide(point, peer, method)


class RpcClient:
    """One persistent connection to a peer, with reconnect.

    Reconnect-and-resend is safe for `idem=True` calls: the logical
    call's (client_id, seq) stays constant across attempts, so the
    server's dedup LRU answers retransmits from cache."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 5.0,
                 retry: Optional[RetryPolicy] = None):
        self.addr = tuple(addr)
        self.timeout = timeout
        self.retry = retry or RetryPolicy(base=0.02, cap=1.0)
        self.client_id = uuid.uuid4().hex[:16]
        self._seq = 0
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._lock = threading.Lock()
        self._next_id = 0

    def _connect(self, timeout: Optional[float] = None):
        s = socket.create_connection(
            self.addr, timeout=timeout or self.timeout
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(self.timeout)
        self._sock = s
        self._rfile = s.makefile("rb")

    def call(self, method: str, args: Optional[dict] = None, timeout=None,
             idem: bool = False, deadline: Optional[Deadline] = None):
        from dgraph_tpu_torch.conn.messages import Message, from_wire, to_wire

        if isinstance(args, Message):
            args = to_wire(args)  # typed control-plane message
        per_attempt = timeout or self.timeout
        # propagate the ambient trace context (W3C traceparent) — stable
        # across every reconnect/resend attempt of this logical call
        tp = TRACER.current_traceparent()
        with self._lock:
            dl = deadline or Deadline.after(per_attempt)
            self._seq += 1
            seq = self._seq  # stable across every attempt of THIS call
            last_err: Optional[Exception] = None
            attempt = 0
            while dl.remaining() > 0:
                try:
                    act = _fault("send", self.addr, method)
                    if act is not None:
                        if act.action == "delay":
                            time.sleep(act.delay_s)
                        elif act.action == "drop":
                            # request lost in transit: we'd wait out the
                            # attempt timeout hearing nothing
                            raise socket.timeout("fault-injected drop")
                        elif act.action == "disconnect":
                            raise OSError("fault-injected disconnect")
                        elif act.action == "partition":
                            raise ConnectionRefusedError(
                                "fault-injected partition"
                            )
                    if self._sock is None:
                        self._connect(timeout=dl.clamp(per_attempt))
                    self._next_id += 1
                    rid = self._next_id
                    # per-attempt timeout, clamped to the deadline; the
                    # client DEFAULT is restored after the reply so one
                    # long-deadline call can't slow later failure
                    # detection (the old settimeout leak)
                    self._sock.settimeout(dl.clamp(per_attempt))
                    req = {"id": rid, "m": method, "a": args or {}}
                    if tp:
                        req["tp"] = tp
                    if idem:
                        req["c"] = self.client_id
                        req["q"] = seq
                    _send_frame(self._sock, req)
                    if act is not None and act.action == "dup":
                        _send_frame(self._sock, req)  # duplicate delivery
                    while True:
                        resp = _recv_frame(self._rfile)
                        if resp is None:
                            raise OSError("connection closed")
                        if resp.get("id") == rid:
                            break
                        # stale reply (e.g. the extra response to a
                        # duplicated request): skip to ours
                        METRICS.inc("rpc_stale_responses_total")
                    self._sock.settimeout(self.timeout)
                    frag = resp.get("p")
                    if frag:
                        prof = current_profile()
                        if prof is not None:
                            prof.record_rpc_fragment(frag)
                    if resp.get("e"):
                        raise RpcError(resp["e"])
                    r = resp.get("r")
                    typed = from_wire(r)
                    return typed if typed is not None else r
                except ConnectionRefusedError as e:
                    # a refusal is definitive — the peer is down or
                    # partitioned; fail fast and let the caller pick
                    # another replica instead of burning the deadline
                    self.close_conn()
                    METRICS.inc("rpc_refused_total")
                    raise RpcError(
                        f"rpc {method} to {self.addr} refused: {e}"
                    ) from e
                except (OSError, socket.timeout, ValueError) as e:
                    last_err = e
                    self.close_conn()
                    attempt += 1
                    METRICS.inc("rpc_retries_total")
                    if self.retry.exhausted(attempt):
                        break
                    self.retry.sleep(attempt, dl)
            METRICS.inc("rpc_giveups_total")
            raise RpcError(
                f"rpc {method} to {self.addr} failed after {attempt} "
                f"attempts: {last_err}"
            )

    def close_conn(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None


class RpcPool:
    """Pool of peer clients with heartbeat health (conn/pool.go:233).

    `healthy(addr)` is False once a peer misses `max_misses` consecutive
    pings; a successful ping (or call) restores it. While a peer's
    circuit is open, `call` fails fast with PeerDownError instead of
    paying connect/timeout cost — except for half-open probes: the
    background heartbeat keeps pinging (the primary prober), and pools
    without heartbeats let one trial call through per heartbeat window."""

    def __init__(
        self,
        heartbeat_s: float = 1.0,
        timeout: float = 5.0,
        max_misses: int = 3,
    ):
        self.timeout = timeout
        self.heartbeat_s = heartbeat_s
        self.max_misses = max_misses
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._misses: Dict[Tuple[str, int], int] = {}
        self._last_ok: Dict[Tuple[str, int], float] = {}
        self._last_probe: Dict[Tuple[str, int], float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    def get(self, addr) -> RpcClient:
        addr = tuple(addr)
        with self._lock:
            c = self._clients.get(addr)
            if c is None:
                c = RpcClient(addr, timeout=self.timeout)
                self._clients[addr] = c
                self._misses.setdefault(addr, 0)
            return c

    def call(self, addr, method, args=None, timeout=None,
             idem: bool = False, deadline: Optional[Deadline] = None):
        addr = tuple(addr)
        c = self.get(addr)
        if self._failfast(addr):
            METRICS.inc("circuit_failfast_total")
            raise PeerDownError(f"peer {addr} down (circuit open)")
        try:
            out = c.call(method, args, timeout=timeout, idem=idem,
                         deadline=deadline)
            self._mark(addr, ok=True)
            return out
        except RpcError:
            self._mark(addr, ok=False)
            raise

    def _failfast(self, addr) -> bool:
        with self._lock:
            if self._misses.get(addr, 0) < self.max_misses:
                return False
            now = time.time()
            # half-open: without a heartbeat thread, admit one trial
            # call per heartbeat window as the probe
            if now - self._last_probe.get(addr, 0.0) >= self.heartbeat_s:
                self._last_probe[addr] = now
                METRICS.inc("circuit_halfopen_probes_total")
                return False
            return True

    def _mark(self, addr, ok: bool):
        addr = tuple(addr)
        with self._lock:
            was_open = self._misses.get(addr, 0) >= self.max_misses
            if ok:
                self._misses[addr] = 0
                self._last_ok[addr] = time.time()
                if was_open:
                    METRICS.inc("circuit_close_total")
            else:
                self._misses[addr] = self._misses.get(addr, 0) + 1
                if not was_open and self._misses[addr] >= self.max_misses:
                    METRICS.inc("circuit_open_total")
                    # a freshly-opened circuit waits a full heartbeat
                    # window before its first half-open probe
                    self._last_probe[addr] = time.time()
                if self._misses[addr] >= self.max_misses:
                    c = self._clients.get(addr)
                    if c is not None:
                        c.close_conn()  # prune the dead socket

    def healthy(self, addr) -> bool:
        return self._misses.get(tuple(addr), 0) < self.max_misses

    def start_heartbeats(self):
        """Background pinger marking peer health (MonitorHealth analog);
        doubles as the circuit breaker's half-open prober."""
        if self._hb_thread is not None:
            return self
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True)
        self._hb_thread.start()
        return self

    def _hb_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            with self._lock:
                addrs = list(self._clients)
            for addr in addrs:
                try:
                    # direct client call: probes bypass the breaker
                    self.get(addr).call("ping", timeout=self.heartbeat_s)
                    self._mark(addr, ok=True)
                except RpcError:
                    self._mark(addr, ok=False)

    def close(self):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        with self._lock:
            for c in self._clients.values():
                c.close_conn()
            self._clients.clear()
