"""Typed control-plane messages over the binary frame layer.

The reference's internal planes speak typed protobuf
(dgraph/protos/pb.proto:559-604 — services Raft/Zero/Worker;
badgerpb4.KV for streamed records). This module is the analog: a
protobuf-WIRE-FORMAT codec (varint tags, length-delimited fields — so
the bytes are inspectable with any proto tool) plus one schema for
every message the Alpha/Zero/Raft processes exchange. JSON stays only
where the reference also nests opaque app bytes (raftpb.Entry.Data,
ZeroProposal internals).

Encoding rules (proto3 subset):
  tag   = (field_num << 3) | wire_type
  wire 0 = varint  (uint/bool)
  wire 2 = length-delimited (bytes/str/nested message/repeated message)
Unknown fields are skipped on decode (forward compatibility).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _put_varint(out: List[bytes], v: int):
    if v < 0:
        raise ValueError(f"varint cannot encode negative value {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(bytes([b | 0x80]))
        else:
            out.append(bytes([b]))
            return


def _get_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


class Message:
    """Base: subclasses declare FIELDS = {name: (num, spec)} where spec
    is 'uint' | 'bool' | 'bytes' | 'str' | ('msg', cls) |
    ('rep', inner_spec)."""

    FIELDS: Dict[str, Tuple[int, Any]] = {}

    def __init__(self, **kw):
        for name, (_, spec) in self.FIELDS.items():
            v = kw.pop(name, None)
            if v is None:
                v = self._zero(spec)
            setattr(self, name, v)
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)}")

    @staticmethod
    def _zero(spec):
        if spec == "uint":
            return 0
        if spec == "bool":
            return False
        if spec == "bytes":
            return b""
        if spec == "str":
            return ""
        if isinstance(spec, tuple) and spec[0] == "rep":
            return []
        return None  # nested message

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n in self.FIELDS
        )

    def __repr__(self):
        inner = ", ".join(
            f"{n}={getattr(self, n)!r}" for n in self.FIELDS
        )
        return f"{type(self).__name__}({inner})"

    # -- encode ---------------------------------------------------------

    def encode(self) -> bytes:
        out: List[bytes] = []
        for name, (num, spec) in self.FIELDS.items():
            v = getattr(self, name)
            self._enc_field(out, num, spec, v)
        return b"".join(out)

    @classmethod
    def _enc_field(cls, out, num, spec, v):
        if isinstance(spec, tuple) and spec[0] == "rep":
            for item in v or []:
                cls._enc_field(out, num, spec[1], item)
            return
        if spec == "uint":
            if v:
                _put_varint(out, (num << 3) | 0)
                _put_varint(out, int(v))
            return
        if spec == "bool":
            if v:
                _put_varint(out, (num << 3) | 0)
                _put_varint(out, 1)
            return
        if spec in ("bytes", "str"):
            b = v.encode("utf-8") if spec == "str" else bytes(v)
            if b:
                _put_varint(out, (num << 3) | 2)
                _put_varint(out, len(b))
                out.append(b)
            return
        if isinstance(spec, tuple) and spec[0] == "msg":
            if v is not None:
                b = v.encode()
                _put_varint(out, (num << 3) | 2)
                _put_varint(out, len(b))
                out.append(b)
            return
        raise TypeError(f"bad field spec {spec!r}")

    # -- decode ---------------------------------------------------------

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        m = cls()
        by_num = {num: (name, spec) for name, (num, spec) in cls.FIELDS.items()}
        pos = 0
        n = len(data)
        while pos < n:
            tag, pos = _get_varint(data, pos)
            num, wt = tag >> 3, tag & 7
            if wt == 0:
                val, pos = _get_varint(data, pos)
                payload: Any = val
            elif wt == 2:
                ln, pos = _get_varint(data, pos)
                if pos + ln > n:
                    raise ValueError("truncated field")
                payload = data[pos : pos + ln]
                pos += ln
            else:
                raise ValueError(f"unsupported wire type {wt}")
            got = by_num.get(num)
            if got is None:
                continue  # unknown field: skip (forward compat)
            name, spec = got
            rep = isinstance(spec, tuple) and spec[0] == "rep"
            inner = spec[1] if rep else spec
            if inner == "uint":
                val2: Any = int(payload)
            elif inner == "bool":
                val2 = bool(payload)
            elif inner == "bytes":
                val2 = bytes(payload)
            elif inner == "str":
                val2 = bytes(payload).decode("utf-8")
            elif isinstance(inner, tuple) and inner[0] == "msg":
                val2 = inner[1].decode(bytes(payload))
            else:
                raise TypeError(f"bad field spec {spec!r}")
            if rep:
                getattr(m, name).append(val2)
            else:
                setattr(m, name, val2)
        return m


# ---------------------------------------------------------------------------
# control-plane schemas (pb.proto:559-604 analogs)
# ---------------------------------------------------------------------------


class KV(Message):
    """badgerpb4.KV analog: one versioned record."""

    FIELDS = {"key": (1, "bytes"), "ts": (2, "uint"), "value": (3, "bytes")}


class KVList(Message):
    """pb.KVS analog: a streamed record batch. `more` marks a paged
    iterate_versions response truncated at a key boundary by the
    request's max_bytes cap — the caller resumes with after=<last key>
    (the tablet-move copy stream; old decoders skip the field)."""

    FIELDS = {"kv": (1, ("rep", ("msg", KV))), "more": (2, "bool")}


class HealthInfo(Message):
    """pb.HealthInfo analog (service Raft.Heartbeat)."""

    FIELDS = {
        "ok": (1, "bool"),
        "node": (2, "uint"),
        "group": (3, "uint"),
        "is_leader": (4, "bool"),
        "term": (5, "uint"),
        "applied": (6, "uint"),
    }


class GetRequest(Message):
    FIELDS = {"key": (1, "bytes"), "ts": (2, "uint")}


class GetResponse(Message):
    FIELDS = {"found": (1, "bool"), "ts": (2, "uint"), "value": (3, "bytes")}


class IterateRequest(Message):
    """Prefix scan. The optional fields page and filter a versions scan
    so one response frame stays bounded (tablet moves stream tablets
    far larger than DGRAPH_TPU_MAX_FRAME_BYTES in chunks):
      since     only versions with ts > since (delta-phase catch-up)
      after     resume strictly after this key (page cursor)
      max_bytes stop at the first key boundary past this many record
                bytes and set KVList.more (0 = unpaged)."""

    FIELDS = {
        "prefix": (1, "bytes"),
        "ts": (2, "uint"),
        "since": (3, "uint"),
        "after": (4, "bytes"),
        "max_bytes": (5, "uint"),
    }


class Proposal(Message):
    """Raft proposal envelope; data is the app-level op (opaque bytes,
    like raftpb.Entry.Data)."""

    FIELDS = {"data": (1, "bytes")}


class ProposalResponse(Message):
    FIELDS = {
        "ok": (1, "bool"),
        "error": (2, "str"),
        "leader_hint": (3, "uint"),
        "index": (4, "uint"),
    }


class Ack(Message):
    """api.Payload/Status analog for fire-and-forget admin ops."""

    FIELDS = {"ok": (1, "bool")}


class ZeroState(Message):
    """MembershipState analog; the state snapshot rides as structured
    JSON (it is a full coordinator dump, not a hot-path record)."""

    FIELDS = {"state_json": (1, "bytes")}


class ZeroCommitReq(Message):
    """One member of a batched commit exchange: a txn's start ts plus
    its conflict-key fingerprints (pb.TxnContext analog — the keys are
    already 64-bit fingerprints on this plane, varint-encoded here)."""

    FIELDS = {"start_ts": (1, "uint"), "cks": (2, ("rep", "uint"))}


class ZeroCommitBatch(Message):
    """The group-commit oracle exchange: N (start_ts, conflict_keys)
    sets decided in ONE Zero round trip, verdicts returned per txn (an
    aborted member never fails its batchmates). Rides as a typed
    nested field on ZeroExec — u64 fingerprint lists stay varints
    instead of JSON numerals, and the zero-process arg normalizer
    never sees (and can't mangle) the nested list shape."""

    FIELDS = {"txns": (1, ("rep", ("msg", ZeroCommitReq)))}


class ZeroExec(Message):
    """ZeroProposal analog: one Zero state-machine op. args is the
    op-specific body (structured JSON — Zero ops are heterogeneous,
    like pb.ZeroProposal's oneof); `commit_batch` is the typed body of
    the batched commit op (decoders that predate it skip the field)."""

    FIELDS = {
        "op": (1, "str"),
        "args_json": (2, "bytes"),
        "commit_batch": (3, ("msg", ZeroCommitBatch)),
    }


class RaftEnvelope(Message):
    """raftpb.Message analog for the raft TCP plane; payload nests the
    kind-specific body as an opaque framed blob (entries carry app
    proposal data, like raftpb.Entry.Data — the frame codec keeps bulk
    snapshot bytes raw instead of base64). `trace` carries the ambient
    W3C traceparent of the sender (empty for untraced tick traffic) so
    a traced proposal's replication hop stays attributable; decoders
    that predate the field skip it (forward compat)."""

    FIELDS = {
        "kind": (1, "str"),
        "frm": (2, "uint"),
        "to": (3, "uint"),
        "term": (4, "uint"),
        "payload": (5, "bytes"),
        "trace": (6, "str"),
    }


# registry for the frame layer: name -> class
REGISTRY: Dict[str, type] = {
    c.__name__: c
    for c in (
        KV, KVList, HealthInfo, GetRequest, GetResponse,
        IterateRequest, Proposal, ProposalResponse, Ack, ZeroState,
        ZeroExec, ZeroCommitReq, ZeroCommitBatch, RaftEnvelope,
    )
}


def to_wire(msg: Message) -> dict:
    """Envelope a typed message for the JSON+blob frame layer."""
    return {"__typed__": type(msg).__name__, "__pb__": msg.encode()}


def from_wire(obj) -> Optional[Message]:
    if isinstance(obj, dict) and "__typed__" in obj:
        cls = REGISTRY.get(obj["__typed__"])
        if cls is None:
            raise ValueError(f"unknown typed message {obj['__typed__']}")
        return cls.decode(obj["__pb__"])
    return None
