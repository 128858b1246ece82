"""Live loader: batched transactional load through the running engine.

Mirrors dgraph/dgraph/cmd/live (batch.go): RDF/JSON input is
chunked into batches of N nquads, each applied in its own transaction with
retry-on-conflict, with xid->uid assignment shared across batches.
"""

from __future__ import annotations

from typing import Iterable, Optional

from dgraph_tpu_torch.loaders.rdf import NQuad, parse_nquad
from dgraph_tpu_torch.loaders.xidmap import XidMap
from dgraph_tpu_torch.posting.pl import OP_SET
from dgraph_tpu_torch.zero.zero import TxnConflictError


class LiveLoader:
    def __init__(self, server, batch_size: int = 1000, retries: int = 3):
        self.server = server
        self.batch_size = batch_size
        self.retries = retries
        self.xidmap = XidMap(server.zero)
        self.nquads_loaded = 0
        self.txns_committed = 0
        self.aborts = 0

    def _resolve(self, ref: str) -> int:
        if ref.startswith("0x"):
            return int(ref, 16)
        if ref.isdigit():
            return int(ref)
        return self.xidmap.assign_uid(ref)

    def _apply_batch(self, batch):
        for attempt in range(self.retries + 1):
            txn = self.server.new_txn()
            try:
                for nq in batch:
                    self.server._apply_nquad(
                        txn.txn, nq, self._resolve, OP_SET
                    )
                txn.commit()
                self.txns_committed += 1
                self.nquads_loaded += len(batch)
                return
            except TxnConflictError:
                self.aborts += 1
                if attempt == self.retries:
                    raise

    def load_nquads(self, nquads: Iterable[NQuad]):
        batch = []
        for nq in nquads:
            batch.append(nq)
            if len(batch) >= self.batch_size:
                self._apply_batch(batch)
                batch = []
        if batch:
            self._apply_batch(batch)

    def load_rdf(self, text: str):
        from dgraph_tpu_torch.loaders.rdf import parse_rdf

        self.load_nquads(parse_rdf(text))

    def load_rdf_file(self, path: str):
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            self.load_rdf(f.read())
