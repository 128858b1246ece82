"""Backup destination handlers + CDC sinks behind URI schemes.

Mirrors dgraph/worker/backup_handler.go (UriHandler: file://,
s3://, minio:// destinations) and worker/sink_handler.go (CDC sinks:
file / Kafka). The local handlers are fully functional; the network ones
(S3, Kafka) carry the full request/produce shape but are gated behind
their optional client libraries — this image has no egress, so they
activate when boto3 / kafka-python exist and otherwise raise a clear
configuration error (stub-or-gate policy).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional
from urllib.parse import urlparse


class HandlerError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Backup destination handlers (worker/backup_handler.go UriHandler)
# ---------------------------------------------------------------------------


class UriHandler:
    """Write/read named blobs at a destination."""

    def put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def ls(self) -> List[str]:
        raise NotImplementedError


class FileHandler(UriHandler):
    def __init__(self, path: str):
        self.dir = path
        os.makedirs(path, exist_ok=True)

    def put(self, name, data):
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self.dir, name))

    def get(self, name):
        with open(os.path.join(self.dir, name), "rb") as f:
            return f.read()

    def exists(self, name):
        return os.path.exists(os.path.join(self.dir, name))

    def ls(self):
        return sorted(os.listdir(self.dir))


class S3Handler(UriHandler):
    """s3://bucket/prefix or minio://host:port/bucket/prefix
    (worker/backup_handler.go s3 paths). Needs boto3."""

    def __init__(self, uri: str):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise HandlerError(
                "s3:// destinations need boto3, which is not installed in "
                "this environment — use file:// or install boto3"
            ) from e
        import boto3

        u = urlparse(uri)
        if u.scheme == "minio":
            endpoint = f"http://{u.netloc}"
            parts = u.path.lstrip("/").split("/", 1)
            self.bucket = parts[0]
            self.prefix = parts[1] if len(parts) > 1 else ""
            self.client = boto3.client("s3", endpoint_url=endpoint)
        else:
            self.bucket = u.netloc
            self.prefix = u.path.lstrip("/")
            self.client = boto3.client("s3")

    def _key(self, name):
        return f"{self.prefix.rstrip('/')}/{name}" if self.prefix else name

    def put(self, name, data):
        self.client.put_object(
            Bucket=self.bucket, Key=self._key(name), Body=data
        )

    def get(self, name):
        out = self.client.get_object(Bucket=self.bucket, Key=self._key(name))
        return out["Body"].read()

    def exists(self, name):
        try:
            self.client.head_object(Bucket=self.bucket, Key=self._key(name))
            return True
        except Exception:
            return False

    def ls(self):
        out = self.client.list_objects_v2(
            Bucket=self.bucket, Prefix=self.prefix
        )
        pre = len(self.prefix.rstrip("/")) + 1 if self.prefix else 0
        return sorted(
            obj["Key"][pre:] for obj in out.get("Contents", [])
        )


def handler_for(uri: str) -> UriHandler:
    u = urlparse(uri)
    if u.scheme in ("", "file"):
        return FileHandler(u.path or uri)
    if u.scheme in ("s3", "minio"):
        return S3Handler(uri)
    raise HandlerError(f"unsupported backup destination scheme {u.scheme!r}")


def backup_to_uri(server, uri: str, incremental: bool = True) -> dict:
    """Run a backup through a UriHandler destination: the local backup/
    manifest machinery writes to a staging dir, then blobs ship to the
    handler (how the reference streams badger backups to the handler)."""
    import tempfile

    from dgraph_tpu_torch.admin.backup import backup as _local_backup

    h = handler_for(uri)
    if isinstance(h, FileHandler):
        return _local_backup(server, h.dir, incremental=incremental)
    staging = tempfile.mkdtemp(prefix="dgraph_backup_stage_")
    # seed staging with the remote manifest ONLY: backup() reads just
    # the manifest to chain its `since`, so downloading (and later
    # re-uploading) every historical chunk file would cost O(backup
    # history) transfer per incremental for nothing
    man_blob = h.get("manifest.json") if h.exists("manifest.json") else None
    if man_blob is not None:
        with open(os.path.join(staging, "manifest.json"), "wb") as f:
            f.write(man_blob)
    out = _local_backup(server, staging, incremental=incremental)
    # upload only what this backup produced: its chunk files + the
    # updated manifest
    for name in [f["name"] for f in out.get("files", [])] + [
        "manifest.json"
    ]:
        with open(os.path.join(staging, name), "rb") as f:
            h.put(name, f.read())
    shutil.rmtree(staging)
    return out


# ---------------------------------------------------------------------------
# CDC sinks (worker/sink_handler.go)
# ---------------------------------------------------------------------------


class Sink:
    def send(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Block until every send() so far is durably accepted by the
        sink — the CDC checkpoint must not advance past events a
        client-side buffer could still drop (admin/cdc.py)."""

    def close(self) -> None:
        pass


class FileSink(Sink):
    def __init__(self, path: str):
        self._f = open(path, "ab")

    def send(self, key, value):
        self._f.write(value.rstrip(b"\n") + b"\n")
        self._f.flush()

    def close(self):
        self._f.close()


class KafkaSink(Sink):
    """kafka://host:9092/topic?sasl_user=..&sasl_password=..
    (worker/sink_handler.go newKafkaSink). Needs kafka-python."""

    def __init__(self, uri: str):
        try:
            from kafka import KafkaProducer  # noqa: F401
        except ImportError as e:
            raise HandlerError(
                "kafka:// CDC sinks need kafka-python, which is not "
                "installed in this environment — use a file sink"
            ) from e
        from kafka import KafkaProducer

        u = urlparse(uri)
        from urllib.parse import parse_qs

        qs = parse_qs(u.query)
        kwargs = {"bootstrap_servers": u.netloc}
        if "sasl_user" in qs:
            kwargs.update(
                security_protocol="SASL_PLAINTEXT",
                sasl_mechanism="PLAIN",
                sasl_plain_username=qs["sasl_user"][0],
                sasl_plain_password=qs.get("sasl_password", [""])[0],
            )
        self.topic = u.path.lstrip("/") or "dgraph-cdc"
        self.producer = KafkaProducer(**kwargs)

    def send(self, key, value):
        self.producer.send(self.topic, key=key, value=value)

    def flush(self):
        # producer.send only buffers client-side; the CDC checkpoint
        # waits on this before advancing
        self.producer.flush()

    def close(self):
        self.producer.flush()
        self.producer.close()


def sink_for(uri: str) -> Sink:
    u = urlparse(uri)
    if u.scheme in ("", "file"):
        return FileSink(u.path or uri)
    if u.scheme == "kafka":
        return KafkaSink(uri)
    raise HandlerError(f"unsupported CDC sink scheme {u.scheme!r}")
