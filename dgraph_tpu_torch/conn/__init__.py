"""Cluster RPC layer (ref dgraph/conn/): pooled connections,
heartbeat health + circuit breaking, request/response framing over TCP,
deterministic fault injection (faults.py) and the shared
retry/deadline vocabulary (retry.py)."""

from dgraph_tpu_torch.conn.retry import Deadline, RetryPolicy, deadline_scope
from dgraph_tpu_torch.conn.rpc import (
    PeerDownError,
    RpcClient,
    RpcError,
    RpcPool,
    RpcServer,
)

__all__ = [
    "Deadline",
    "PeerDownError",
    "RetryPolicy",
    "RpcClient",
    "RpcError",
    "RpcPool",
    "RpcServer",
    "deadline_scope",
]
