"""Minimal RFC6455 websocket frames + the graphql-transport-ws protocol.

The reference serves GraphQL subscriptions over websockets
(dgraph/graphql/subscription/poller.go with the graphql-ws
message protocol); this module gives the HTTP front-end the same
transport with no external dependencies: handshake, text-frame codec
(client->server frames are masked per the RFC), ping/pong, and the
message flow connection_init -> connection_ack, subscribe -> next*/
complete, with both the modern `graphql-transport-ws` and legacy
`graphql-ws` (start/data/stop) vocabularies accepted.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
from typing import Optional

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def is_upgrade(headers) -> bool:
    return (
        headers.get("Upgrade", "").lower() == "websocket"
        and "upgrade" in headers.get("Connection", "").lower()
    )


def handshake(handler) -> bool:
    """Complete the server side of the websocket handshake on a
    BaseHTTPRequestHandler. Returns True when the socket is upgraded."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key:
        handler.send_response(400)
        handler.end_headers()
        return False
    accept = base64.b64encode(
        hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    ).decode()
    proto = handler.headers.get("Sec-WebSocket-Protocol", "")
    chosen = ""
    for p in (x.strip() for x in proto.split(",")):
        if p in ("graphql-transport-ws", "graphql-ws"):
            chosen = p
            break
    lines = [
        "HTTP/1.1 101 Switching Protocols",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Accept: {accept}",
    ]
    if chosen:
        lines.append(f"Sec-WebSocket-Protocol: {chosen}")
    handler.connection.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
    return True


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            return None
        buf += got
    return buf


def recv_frame(sock):
    """Returns (opcode, payload bytes) or None on close/EOF."""
    hdr = _read_exact(sock, 2)
    if hdr is None:
        return None
    b1, b2 = hdr
    opcode = b1 & 0x0F
    masked = bool(b2 & 0x80)
    ln = b2 & 0x7F
    if ln == 126:
        ext = _read_exact(sock, 2)
        if ext is None:
            return None
        (ln,) = struct.unpack(">H", ext)
    elif ln == 127:
        ext = _read_exact(sock, 8)
        if ext is None:
            return None
        (ln,) = struct.unpack(">Q", ext)
    mask = b""
    if masked:
        mask = _read_exact(sock, 4)
        if mask is None:
            return None
    payload = _read_exact(sock, ln) if ln else b""
    if payload is None:
        return None
    if masked and payload:
        payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return opcode, payload


def send_frame(sock, payload: bytes, opcode: int = 0x1) -> None:
    n = len(payload)
    hdr = bytes([0x80 | opcode])
    if n < 126:
        hdr += bytes([n])
    elif n < 1 << 16:
        hdr += bytes([126]) + struct.pack(">H", n)
    else:
        hdr += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(hdr + payload)


def send_json(sock, obj) -> None:
    send_frame(sock, json.dumps(obj).encode())


def serve_graphql_ws(handler, engine) -> None:
    """Run the graphql-transport-ws session loop on an upgraded socket.

    `subscribe` payloads execute through the engine's GraphQL layer when
    the operation targets it (default), and re-run on every commit that
    touches their predicates — the reference's poller semantics
    (subscription/poller.go) driven by commit events instead of a timer.
    """
    sock = handler.connection
    sock.settimeout(None)
    sub_ids: dict = {}  # ws op id -> Subscriptions sid
    subs = getattr(engine, "_subscriptions", None)
    if subs is None:
        from dgraph_tpu_torch.api.subscriptions import Subscriptions

        subs = Subscriptions(engine)
    import threading

    send_lock = threading.Lock()

    def push(obj):
        with send_lock:
            send_json(sock, obj)

    try:
        while True:
            got = recv_frame(sock)
            if got is None:
                break
            opcode, payload = got
            if opcode == 0x8:  # close
                break
            if opcode == 0x9:  # ping -> pong
                with send_lock:
                    send_frame(sock, payload, opcode=0xA)
                continue
            if opcode not in (0x1, 0x2):
                continue
            try:
                msg = json.loads(payload.decode() or "{}")
            except Exception:
                continue
            mtype = msg.get("type")
            if mtype == "connection_init":
                push({"type": "connection_ack"})
            elif mtype in ("subscribe", "start"):
                op_id = msg.get("id")
                q = (msg.get("payload") or {}).get("query", "")
                variables = (msg.get("payload") or {}).get("variables")
                data_type = "next" if mtype == "subscribe" else "data"

                def cb(result, _id=op_id, _dt=data_type):
                    push({"id": _id, "type": _dt, "payload": result})

                try:
                    sid = subs.subscribe_graphql(
                        q, cb, variables=variables
                    )
                    sub_ids[op_id] = sid
                except Exception as e:
                    push(
                        {
                            "id": op_id,
                            "type": "error",
                            "payload": [{"message": str(e)}],
                        }
                    )
            elif mtype in ("complete", "stop"):
                sid = sub_ids.pop(msg.get("id"), None)
                if sid is not None:
                    subs.unsubscribe(sid)
            elif mtype == "ping":
                push({"type": "pong"})
    finally:
        for sid in sub_ids.values():
            subs.unsubscribe(sid)
        try:
            sock.close()
        except Exception:
            pass
