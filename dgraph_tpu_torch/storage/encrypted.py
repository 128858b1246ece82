"""At-rest encryption for the KV store.

Mirrors badger's encryption-at-rest as the reference deploys it
(enc/util.go key plumbing + badger data-key block encryption behind
--encryption key-file): every record value is AES-CTR sealed before it
reaches the backing store (and therefore its WAL / SSTables / snapshots),
and unsealed on read. Key bytes select AES-128/192/256.

Scope note vs badger: badger encrypts whole blocks, hiding keys too; this
wrapper seals values only — key bytes (predicate names, uids) remain
visible to the storage layer. The posting payloads, which carry the
actual graph data, are what's sealed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from dgraph_tpu_torch.enc.enc import decrypt_stream, encrypt_stream
from dgraph_tpu_torch.storage.kv import KV


class EncryptedKV(KV):
    def __init__(self, inner: KV, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError("encryption key must be 16/24/32 bytes")
        self.inner = inner
        self.key = key

    # -- writes ---------------------------------------------------------------

    def put(self, key: bytes, ts: int, value: bytes) -> None:
        self.inner.put(key, ts, encrypt_stream(value, self.key))

    def put_batch(self, items) -> None:
        self.inner.put_batch(
            (k, ts, encrypt_stream(v, self.key)) for k, ts, v in items
        )

    # -- reads ----------------------------------------------------------------

    def get(self, key: bytes, read_ts: int) -> Optional[Tuple[int, bytes]]:
        got = self.inner.get(key, read_ts)
        if got is None:
            return None
        return (got[0], decrypt_stream(got[1], self.key))

    def versions(self, key: bytes, read_ts: int) -> List[Tuple[int, bytes]]:
        return [
            (ts, decrypt_stream(v, self.key))
            for ts, v in self.inner.versions(key, read_ts)
        ]

    def iterate(self, prefix: bytes, read_ts: int):
        for k, ts, v in self.inner.iterate(prefix, read_ts):
            yield (k, ts, decrypt_stream(v, self.key))

    def iterate_versions(self, prefix: bytes, read_ts: int):
        for k, vers in self.inner.iterate_versions(prefix, read_ts):
            yield (k, [(ts, decrypt_stream(v, self.key)) for ts, v in vers])

    # -- maintenance / passthrough -------------------------------------------

    def delete_below(self, key: bytes, ts: int) -> None:
        self.inner.delete_below(key, ts)

    def drop_prefix(self, prefix: bytes) -> None:
        self.inner.drop_prefix(prefix)

    def sync(self):
        self.inner.sync()

    def snapshot_to(self, path: str):
        self.inner.snapshot_to(path)  # ciphertext snapshot

    def dump_bytes(self) -> bytes:
        return self.inner.dump_bytes()  # ciphertext (safe to ship)

    def load_bytes(self, blob: bytes):
        self.inner.load_bytes(blob)

    def close(self):
        self.inner.close()
