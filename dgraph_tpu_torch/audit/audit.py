"""Audit logging: append-only (optionally encrypted) request log.

Mirrors dgraph/audit/ (interceptor.go:65,97 + audit.go:127
rolling encrypted logs): every API request is recorded as one JSON line
{ts, user, ns, endpoint, req_body, status}; files roll at max_bytes; with
an encryption key each line is AES-CTR sealed (enc/enc.py).
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from typing import Optional


class AuditLog:
    def __init__(
        self,
        out_dir: str,
        key: Optional[bytes] = None,
        max_bytes: int = 10 * 1024 * 1024,
    ):
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self.key = key
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._seq = 0
        self._open()

    def _open(self):
        self.path = os.path.join(self.dir, f"audit-{self._seq:04d}.log")
        self._f = open(self.path, "ab")

    def _roll_if_needed(self):
        if self._f.tell() >= self.max_bytes:
            self._f.close()
            self._seq += 1
            self._open()

    def record(
        self,
        endpoint: str,
        user: str = "",
        ns: int = 0,
        body: str = "",
        status: str = "OK",
    ):
        entry = {
            "ts": time.time(),
            "endpoint": endpoint,
            "user": user,
            "namespace": ns,
            "body": body[:4096],
            "status": status,
        }
        line = json.dumps(entry, separators=(",", ":")).encode()
        if self.key is not None:
            from dgraph_tpu_torch.enc.enc import encrypt_stream

            line = base64.b64encode(encrypt_stream(line, self.key))
        with self._lock:
            self._f.write(line + b"\n")
            self._f.flush()
            self._roll_if_needed()

    def read_all(self) -> list:
        """Decrypt + parse all audit entries (ops tooling)."""
        out = []
        for fname in sorted(os.listdir(self.dir)):
            if not fname.startswith("audit-"):
                continue
            with open(os.path.join(self.dir, fname), "rb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if self.key is not None:
                        from dgraph_tpu_torch.enc.enc import decrypt_stream

                        line = decrypt_stream(base64.b64decode(line), self.key)
                    out.append(json.loads(line))
        return out

    def close(self):
        self._f.close()
