"""Encryption-at-rest helpers: AES-CTR streams for backups/exports.

Mirrors dgraph/enc/util.go (GetReaderWriter: AES-CTR with a
random IV prepended to the stream) and the key-file plumbing of
x/acl_enc_keys.go. Key sizes 16/24/32 select AES-128/192/256.
"""

from __future__ import annotations

import os
from typing import Optional

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

IV_SIZE = 16


def read_key_file(path: str) -> bytes:
    with open(path, "rb") as f:
        key = f.read().strip()
    if len(key) not in (16, 24, 32):
        raise ValueError(
            f"encryption key must be 16/24/32 bytes, got {len(key)}"
        )
    return key


def encrypt_stream(data: bytes, key: bytes) -> bytes:
    """IV || AES-CTR(data) (ref enc/util.go:20 GetWriter)."""
    iv = os.urandom(IV_SIZE)
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return iv + enc.update(data) + enc.finalize()


def decrypt_stream(data: bytes, key: bytes) -> bytes:
    iv, body = data[:IV_SIZE], data[IV_SIZE:]
    dec = Cipher(algorithms.AES(key), modes.CTR(iv)).decryptor()
    return dec.update(body) + dec.finalize()
