"""The state carried across from the reference engine.

This system has no weights; what a deployment carries is its store. A
`dgraph_tpu` engine's in-memory store dumps to plain bytes
(`MemKV.dump_bytes()`), and with the schema text and Zero's lease
watermarks that is all the port needs to answer on exactly the same data.
Vector predicates come across too: their indexes are rebuilt from the
carried store on the server's device, so `similar_to` answers as on the
source engine. Nothing of the reference is imported: the inputs are bytes
and ints.
"""

from __future__ import annotations

from dgraph_tpu_torch.api.server import Server


def carry_state(
    kv_blob: bytes, schema_text: str, max_uid: int, max_ts: int, device="cuda"
) -> Server:
    """A port Server that answers on a carried store: `kv_blob` from
    `MemKV.dump_bytes()`, the schema text it was written under, and the
    highest uid and timestamp the source engine's Zero had leased."""
    s = Server(device=device)
    s.carry(kv_blob, schema_text, max_uid, max_ts)
    return s
