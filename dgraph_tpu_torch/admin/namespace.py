"""Multi-tenancy namespaces (ref dgraph/edgraph/multi_tenancy.go,
namespace.go): each namespace is an isolated logical database sharing the
physical cluster; keys carry the namespace in their attr prefix
(x/keys.py namespace_attr). Creating a namespace bootstraps its own
groot/guardians; deleting drops every key in it. Only guardians of the
galaxy (ns 0) may administer namespaces.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from dgraph_tpu_torch.x import keys

_NS_COUNTER_KEY = b"\x7fns_counter"


class NamespaceManager:
    def __init__(self, server):
        self.server = server

    def _next_ns(self) -> int:
        got = self.server.kv.get(_NS_COUNTER_KEY, 1 << 62)
        cur = struct.unpack("<Q", got[1])[0] if got else 0
        nxt = cur + 1
        self.server.kv.put(
            _NS_COUNTER_KEY, self.server.zero.next_ts(), struct.pack("<Q", nxt)
        )
        bump = getattr(self.server, "bump_snapshot", None)
        if bump is not None:  # direct-KV write: watermark must cover it
            bump()
        return nxt

    def create_namespace(self, groot_password: str = "password") -> int:
        ns = self._next_ns()
        acl = getattr(self.server, "acl", None)
        if acl is not None:
            acl.bootstrap(ns=ns, groot_password=groot_password)
        return ns

    def delete_namespace(self, ns: int):
        if ns == keys.GALAXY_NS:
            raise ValueError("cannot delete the galaxy namespace")
        doomed: List[bytes] = []
        for key, _, _ in self.server.kv.iterate(b"", 1 << 62):
            if len(key) < 11:
                continue
            try:
                pk = keys.parse_key(key)
            except Exception:
                continue
            if pk.ns == ns:
                doomed.append(key)
        for k in doomed:
            self.server.kv.drop_prefix(k)

    def list_namespaces(self) -> List[int]:
        seen = set()
        for key, _, _ in self.server.kv.iterate(b"", 1 << 62):
            if len(key) < 11:
                continue
            try:
                pk = keys.parse_key(key)
            except Exception:
                continue
            seen.add(pk.ns)
        return sorted(seen)
