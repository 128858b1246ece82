"""Binary multipart framing for the inter-node data plane.

The reference's internal RPC is typed protobuf over gRPC with snappy
compression for bulk payloads (conn/snappy.go; worker/snapshot.go:177
streams raft snapshots, predicate moves stream tablet KVs). Our control
plane speaks length-prefixed JSON (conn/rpc.py) — fine for small
messages, but base64-tagging every key/value byte string inflates bulk
transfers ~1.33x and burns CPU on encode/decode.

This codec keeps JSON for structure and lifts LARGE byte strings out as
raw binary blobs, zlib-compressed when that pays:

    body := 0x01 | u32 json_len | json | blob*
    blob := u32 len | u8 flag | payload
    flag 0: payload = raw bytes (len of them)
    flag 1: payload = bare zlib stream (legacy; decode-only, inflated
            under the absolute cap)
    flag 2: payload = u32 raw_len | zlib stream (the raw_len header
            bounds decompression per blob, and the decoder also caps
            the aggregate inflated size of a frame, so a corrupt or
            hostile frame cannot expand past _MAX_INFLATE total)

Inside the JSON, an extracted blob is {"__blob__": i}; small byte
strings keep the existing {"__b64__": ...} tag (b64 overhead on 50
bytes is noise, and it keeps frames introspectable). A body starting
with '{' (0x7b) is plain JSON — the decoder accepts both, so the two
framings coexist on one socket protocol.

JSON (not pickle) remains deliberate: the wire never executes code.

Version note: flag-2 blobs and __esc__ wrapping require every node to
run this revision or later (older decoders pass both through wrong).
The cluster deploys from one tree and compression is opt-in
(DGRAPH_TPU_WIRE_COMPRESS), so no negotiation layer is carried here;
if rolling upgrades across framing revisions become real, bump MAGIC
and negotiate per-connection in conn/rpc.py's hello exchange.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from typing import Any, List, Tuple

from dgraph_tpu_torch.x import config

MAGIC = 0x01
_U32 = struct.Struct(">I")
# Hard cap on a single wire frame (header-declared length). A corrupt or
# hostile 4-byte length prefix must never drive an arbitrarily large
# allocation in _recv_frame readers; matches the reference's 256MB gRPC
# message cap (conn/pool.go grpc.MaxCallRecvMsgSize). Shared by
# conn/rpc.py and raft/tcp.py so both planes enforce the same bound.
MAX_FRAME = int(config.get("MAX_FRAME_BYTES"))
_BLOB_MIN = 256  # bytes values at least this long leave the JSON
_ZLIB_LEVEL = 1
# Compression default OFF: raw blobs already beat the old JSON+b64 path
# 10x on encode+decode CPU and 1.33x on bytes (FRAMING_BENCH.json), and
# zlib-1 (~100MB/s) is SLOWER than LAN/ICI-class links — the reference
# affords always-on compression only because snappy is ~free, which the
# Python stdlib cannot match. Set DGRAPH_TPU_WIRE_COMPRESS=1 for
# DCN-class links where 2.8x fewer bytes wins; blobs are sample-probed
# so incompressible payloads skip the cost either way.
_COMPRESS = bool(config.get("WIRE_COMPRESS"))
_ZLIB_MIN = 1 << 16  # probe/compress only genuinely bulk blobs
_PROBE = 4096


def _worth_compressing(b: bytes) -> bool:
    sample = b[:_PROBE]
    return len(zlib.compress(sample, _ZLIB_LEVEL)) < (len(sample) * 7) // 8


# A user-level dict whose single key collides with a codec sentinel
# ({"__blob__": …}, {"__b64__": …}, {"__esc__": …}) is wrapped in
# {"__esc__": …} on extract and unwrapped on restore, so payload data
# can never be misread as a blob reference.
_SENTINELS = frozenset(("__blob__", "__b64__", "__esc__"))


def _extract(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, (bytes, bytearray)):
        b = bytes(obj)
        if len(b) >= _BLOB_MIN:
            blobs.append(b)
            return {"__blob__": len(blobs) - 1}
        return {"__b64__": base64.b64encode(b).decode()}
    if isinstance(obj, (list, tuple)):
        return [_extract(x, blobs) for x in obj]
    if isinstance(obj, dict):
        out = {k: _extract(v, blobs) for k, v in obj.items()}
        if len(out) == 1 and next(iter(out)) in _SENTINELS:
            return {"__esc__": out}
        return out
    return obj


def _restore(obj: Any, blobs: List[bytes]) -> Any:
    if isinstance(obj, list):
        return [_restore(x, blobs) for x in obj]
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__esc__"}:
            inner = obj["__esc__"]
            if not isinstance(inner, dict):
                raise FrameError("__esc__ payload must be an object")
            # the escaped dict's own key is literal — only its value is
            # recursed, so a payload {"__blob__": x} survives round-trip
            return {k: _restore(v, blobs) for k, v in inner.items()}
        if set(obj.keys()) == {"__blob__"}:
            i = obj["__blob__"]
            if not isinstance(i, int) or isinstance(i, bool) or not (
                0 <= i < len(blobs)
            ):
                raise FrameError(f"dangling blob ref: {i!r}")
            return blobs[i]
        if set(obj.keys()) == {"__b64__"}:
            v = obj["__b64__"]
            if not isinstance(v, str):
                raise FrameError("__b64__ payload must be a string")
            try:
                return base64.b64decode(v)
            except (ValueError, TypeError) as e:
                raise FrameError(f"bad base64 payload: {e}") from e
        return {k: _restore(v, blobs) for k, v in obj.items()}
    return obj


def pack_body(obj: Any) -> bytes:
    """Serialize to either plain JSON (no big byte strings) or the
    binary multipart body."""
    blobs: List[bytes] = []
    jobj = _extract(obj, blobs)
    jb = json.dumps(jobj).encode()
    if not blobs:
        return jb
    out = [bytes([MAGIC]), _U32.pack(len(jb)), jb]
    for b in blobs:
        if _COMPRESS and len(b) >= _ZLIB_MIN and _worth_compressing(b):
            comp = zlib.compress(b, _ZLIB_LEVEL)
            if len(comp) + 4 < len(b):
                out.append(_U32.pack(len(comp) + 4))
                out.append(b"\x02")
                out.append(_U32.pack(len(b)))
                out.append(comp)
                continue
        out.append(_U32.pack(len(b)))
        out.append(b"\x00")
        out.append(b)
    return b"".join(out)


class FrameError(ValueError):
    """Corrupt or truncated frame body. Subclasses ValueError so the
    transports' existing malformed-input guards catch it."""


# Absolute inflation ceiling: raw_len is sender-declared, so it alone
# can't bound a hostile frame. Matches the reference's 256MB gRPC
# message cap (conn/pool.go grpc.MaxCallRecvMsgSize) — anything bulkier
# is streamed in chunks by the snapshot/move paths, never one frame.
_MAX_INFLATE = 256 << 20


def _check_stream_end(d, raw_len) -> None:
    if d.unconsumed_tail or d.flush():
        raise FrameError(
            f"compressed blob inflates past declared {raw_len} bytes"
        )
    if d.unused_data:
        # bytes after the stream's end marker: junk or a covert channel
        raise FrameError("trailing bytes after compressed stream")
    if not d.eof:
        # stream truncated before its adler32 trailer: the checksum was
        # never verified, so the bytes cannot be trusted
        raise FrameError("compressed blob truncated (checksum unverified)")


def _inflate(raw: bytes, budget: int) -> bytes:
    """Decompress a flag-2 blob payload with its declared raw_len as a
    hard output bound (a hostile 1KB frame could otherwise inflate to
    gigabytes — the length prefix only bounds the compressed size).
    `budget` is the frame's remaining aggregate allowance."""
    if len(raw) < 4:
        raise FrameError("compressed blob too short for raw_len header")
    (raw_len,) = _U32.unpack_from(raw, 0)
    if raw_len > budget:
        raise FrameError(
            f"blob declares {raw_len} bytes, frame budget is {budget}"
        )
    d = zlib.decompressobj()
    # max_length=0 would mean "unbounded" to zlib; a declared-empty blob
    # still gets a 1-byte cap so the length check below can reject it
    out = d.decompress(raw[4:], max(raw_len, 1))
    if len(out) != raw_len:
        raise FrameError(
            f"compressed blob declared {raw_len} bytes, got {len(out)}"
        )
    _check_stream_end(d, raw_len)
    return out


def _inflate_legacy(raw: bytes, budget: int) -> bytes:
    """Flag-1 (bare zlib, no raw_len header) decode for frames from
    pre-raw_len senders; bounded by the frame's remaining budget."""
    d = zlib.decompressobj()
    out = d.decompress(raw, budget + 1)
    if len(out) > budget:
        raise FrameError(
            f"legacy compressed blob exceeds frame budget {budget}"
        )
    _check_stream_end(d, len(out))
    return out


def unpack_body(body: bytes) -> Any:
    """Inverse of pack_body; accepts plain-JSON bodies too. Raises
    FrameError (a ValueError) on any corruption — truncated headers,
    overrunning blob lengths, bad zlib streams, dangling blob refs."""
    try:
        if not body or body[0] != MAGIC:
            return _restore(json.loads(body), [])
        (jlen,) = _U32.unpack_from(body, 1)
        pos = 5 + jlen
        jobj = json.loads(body[5:pos])
        blobs: List[bytes] = []
        end = len(body)
        # aggregate inflation budget: many small blobs must not add up
        # past the cap any more than one big one may
        budget = _MAX_INFLATE
        while pos < end:
            (n,) = _U32.unpack_from(body, pos)
            flag = body[pos + 5 - 1]
            pos += 5
            if pos + n > end:
                raise FrameError(
                    f"blob overruns frame: need {n} bytes at {pos}, "
                    f"have {end - pos}"
                )
            raw = body[pos : pos + n]
            pos += n
            if flag == 2:
                b = _inflate(raw, budget)
            elif flag == 1:
                b = _inflate_legacy(raw, budget)
            elif flag == 0:
                b = raw
            else:
                raise FrameError(f"unknown blob flag {flag}")
            budget -= len(b)
            if budget < 0:
                # flag-0 raw blobs spend the same budget: a frame's
                # total decoded payload may never exceed the cap, and a
                # negative budget must not reach zlib's max_length
                raise FrameError(
                    f"frame payload exceeds {_MAX_INFLATE}-byte cap"
                )
            blobs.append(b)
        return _restore(jobj, blobs)
    except FrameError:
        raise
    except (
        struct.error,
        zlib.error,
        IndexError,
        TypeError,
        json.JSONDecodeError,
    ) as e:
        raise FrameError(f"corrupt frame: {type(e).__name__}: {e}") from e
