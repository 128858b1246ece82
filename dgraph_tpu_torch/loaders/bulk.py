"""Bulk loader: offline map-reduce load writing rollup records directly.

Mirrors dgraph/dgraph/cmd/bulk (mapStage loader.go:354 +
reduceStage :554): instead of pushing every edge through the transactional
write path, edges are grouped host-side per key ("map"), then each key's
postings are compacted straight into a rollup record at one timestamp
("reduce") — the same two-phase shape as the reference's sorted map files
-> badger SSTs, minus the external sort since everything is in-memory
per-shard here. Index/reverse/count keys are built in the same pass
(ref bulk count_index.go, vector_indexer.go).

10-100x faster than live loading for initial imports; output is normal KV
state readable by the engine immediately.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.codec import uidpack
from dgraph_tpu_torch.loaders.rdf import NQuad, parse_nquad
from dgraph_tpu_torch.loaders.xidmap import XidMap
from dgraph_tpu_torch.posting.pl import (
    OP_SET,
    Posting,
    encode_rollup,
    lang_uid,
    value_uid,
)
from dgraph_tpu_torch.schema.schema import State
from dgraph_tpu_torch.tok.tok import build_tokens
from dgraph_tpu_torch.types.types import TypeID, Val, convert, to_binary
from dgraph_tpu_torch.x import keys


class BulkLoader:
    def __init__(self, server):
        self.server = server
        self.schema: State = server.schema
        self.xidmap = XidMap(server.zero)
        # map phase accumulators
        self._uid_edges: Dict[bytes, List[int]] = defaultdict(list)
        self._value_posts: Dict[bytes, List[Posting]] = defaultdict(list)
        self._index_uids: Dict[bytes, List[int]] = defaultdict(list)
        self._counts: Dict[Tuple[str, int, int], List[int]] = defaultdict(list)
        self._vectors: List[Tuple[str, int, np.ndarray]] = []
        self._nquads = 0

    # -- map phase -----------------------------------------------------------

    def _resolve(self, ref: str) -> int:
        if ref.startswith("0x"):
            return int(ref, 16)
        if ref.isdigit():
            return int(ref)
        return self.xidmap.assign_uid(ref)

    def add_nquad(self, nq: NQuad, ns: int = keys.GALAXY_NS):
        self._nquads += 1
        subj = self._resolve(nq.subject)
        attr = nq.predicate
        su = self.schema.get(attr)
        if su is None:
            tid = (
                TypeID.UID
                if nq.object_id
                else (nq.object_value.tid if nq.object_value else TypeID.DEFAULT)
            )
            su = self.schema.ensure_default(attr, tid)

        if nq.object_id:
            obj = self._resolve(nq.object_id)
            self._uid_edges[keys.DataKey(attr, subj, ns)].append(obj)
            if su.directive_reverse:
                self._uid_edges[keys.ReverseKey(attr, obj, ns)].append(subj)
            return

        stored = (
            convert(nq.object_value, su.value_type)
            if su.value_type != TypeID.DEFAULT
            else nq.object_value
        )
        vbytes = to_binary(stored)
        puid = (
            value_uid(stored)
            if su.is_list
            else lang_uid(nq.lang if su.lang else "")
        )
        fb = {k: to_binary(v) for k, v in nq.facets.items()}
        ft = {k: v.tid for k, v in nq.facets.items()}
        self._value_posts[keys.DataKey(attr, subj, ns)].append(
            Posting(
                uid=puid,
                op=OP_SET,
                value=vbytes,
                value_type=stored.tid,
                lang=nq.lang,
                facets=fb,
                facet_types=ft,
            )
        )
        for tokb in build_tokens(stored, su.tokenizer_objs()):
            self._index_uids[keys.IndexKey(attr, tokb, ns)].append(subj)
        if su.vector_specs:
            self._vectors.append((attr, subj, np.asarray(stored.value)))

    def add_rdf(self, text: str):
        from dgraph_tpu_torch.loaders.rdf import parse_rdf

        for nq in parse_rdf(text):
            self.add_nquad(nq)

    def add_rdf_file(self, path: str):
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            self.add_rdf(f.read())

    # -- reduce phase ---------------------------------------------------------

    def finish(self) -> int:
        """Compact accumulators into rollup records at one commit ts.
        Returns the ts. Ref reduce.go:51 (k-way merge -> posting packs)."""
        server = self.server
        ts = server.zero.next_ts()
        kv = server.kv
        writes = []

        from dgraph_tpu_torch.posting.pl import rollup_writes

        for key, uids in self._uid_edges.items():
            u = np.unique(np.asarray(uids, np.uint64))
            # count index on the fly (ref bulk count_index.go)
            pk = keys.parse_key(key)
            su = self.schema.get(pk.attr)
            if su is not None and su.count and pk.is_data:
                self._counts[(pk.attr, len(u), pk.ns)].append(pk.uid)
            writes.extend(rollup_writes(key, u, [], ts))

        for key, posts in self._value_posts.items():
            dedup: Dict[int, Posting] = {}
            for p in posts:
                dedup[p.uid] = p  # last wins
            ordered = [dedup[u] for u in sorted(dedup)]
            writes.append(
                (
                    key,
                    ts,
                    encode_rollup(
                        uidpack.encode(np.zeros((0,), np.uint64)), ordered
                    ),
                )
            )

        stats = getattr(server, "stats", None)
        for key, uids in self._index_uids.items():
            u = np.unique(np.asarray(uids, np.uint64))
            if stats is not None:
                pk = keys.parse_key(key)
                stats.record(pk.attr, pk.term, len(u))
            writes.extend(rollup_writes(key, u, [], ts))

        for (attr, cnt, ns), uids in self._counts.items():
            pack = uidpack.encode(np.unique(np.asarray(uids, np.uint64)))
            writes.append(
                (
                    keys.CountKey(attr, cnt, False, ns),
                    ts,
                    encode_rollup(pack, []),
                )
            )

        kv.put_batch(writes)

        for attr, subj, vec in self._vectors:
            server._ensure_vector_index(self.schema.get(attr))
            server.vector_indexes[attr].insert(subj, vec)

        self._uid_edges.clear()
        self._value_posts.clear()
        self._index_uids.clear()
        self._counts.clear()
        self._vectors.clear()
        # direct-KV writes bypassed the commit path: advance the
        # snapshot watermark so watermark reads see the loaded data
        bump = getattr(server, "bump_snapshot", None)
        if bump is not None:
            bump()
        return ts


def bulk_load_rdf(server, rdf_text: str = "", path: Optional[str] = None) -> int:
    loader = BulkLoader(server)
    if rdf_text:
        loader.add_rdf(rdf_text)
    if path:
        loader.add_rdf_file(path)
    return loader.finish()
