"""Bundled gRPC client: the pydgraph surface over the api.Dgraph wire.

Mirrors pydgraph's DgraphClientStub/DgraphClient/Txn trio (the dgo
contract, ref protos/pb.proto service Dgraph): works against this
framework's gRPC server AND any server speaking the same protocol.

    stub = DgraphClientStub("localhost:9080")
    client = DgraphClient(stub)
    client.alter(schema="name: string @index(exact) .")
    txn = client.txn()
    txn.mutate(set_nquads='_:a <name> "Alice" .')
    txn.commit()
    print(client.txn(read_only=True).query('{ q(func: has(name)) { name } }'))
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import grpc

from dgraph_tpu_torch.protos import load_api_pb2

pb = load_api_pb2()


class DgraphClientStub:
    def __init__(self, addr: str = "localhost:9080", credentials=None):
        self.addr = addr
        self.channel = (
            grpc.secure_channel(addr, credentials)
            if credentials is not None
            else grpc.insecure_channel(addr)
        )
        u = self.channel.unary_unary
        self.login = u(
            "/api.Dgraph/Login",
            request_serializer=pb.LoginRequest.SerializeToString,
            response_deserializer=pb.Response.FromString,
        )
        self.query = u(
            "/api.Dgraph/Query",
            request_serializer=pb.Request.SerializeToString,
            response_deserializer=pb.Response.FromString,
        )
        self.alter = u(
            "/api.Dgraph/Alter",
            request_serializer=pb.Operation.SerializeToString,
            response_deserializer=pb.Payload.FromString,
        )
        self.commit_or_abort = u(
            "/api.Dgraph/CommitOrAbort",
            request_serializer=pb.TxnContext.SerializeToString,
            response_deserializer=pb.TxnContext.FromString,
        )
        self.check_version = u(
            "/api.Dgraph/CheckVersion",
            request_serializer=pb.Check.SerializeToString,
            response_deserializer=pb.Version.FromString,
        )

    def close(self):
        self.channel.close()


class Txn:
    """A transaction bound to one client stub (pydgraph Txn surface)."""

    def __init__(self, client: "DgraphClient", read_only: bool = False):
        self._client = client
        self._read_only = read_only
        self._start_ts = 0
        self._finished = False

    def query(
        self, q: str, variables: Optional[Dict[str, str]] = None
    ) -> dict:
        req = pb.Request(
            query=q,
            start_ts=self._start_ts,
            read_only=self._read_only,
        )
        for k, v in (variables or {}).items():
            req.vars[k] = v
        resp = self._client._stub.query(req)
        if resp.txn.start_ts:
            self._start_ts = resp.txn.start_ts
        return json.loads(resp.json or b"{}")

    def mutate(
        self,
        set_nquads: str = "",
        del_nquads: str = "",
        set_obj=None,
        del_obj=None,
        cond: Optional[str] = None,
        commit_now: bool = False,
    ) -> dict:
        if self._read_only:
            raise RuntimeError("read-only transactions cannot mutate")
        req = pb.Request(start_ts=self._start_ts, commit_now=commit_now)
        m = req.mutations.add()
        if set_nquads:
            m.set_nquads = set_nquads.encode()
        if del_nquads:
            m.del_nquads = del_nquads.encode()
        if set_obj is not None:
            m.set_json = json.dumps(set_obj).encode()
        if del_obj is not None:
            m.delete_json = json.dumps(del_obj).encode()
        if cond:
            m.cond = cond
        resp = self._client._stub.query(req)
        if resp.txn.start_ts:
            self._start_ts = resp.txn.start_ts
        if commit_now:
            self._finished = True
        return dict(resp.uids)

    def do_request(self, query: str, mutations, commit_now: bool = True):
        """Upsert block: query + conditional mutations (pydgraph
        txn.do_request shape). mutations: [(set_nquads, cond)]"""
        req = pb.Request(
            start_ts=self._start_ts, query=query, commit_now=commit_now
        )
        for set_nq, cond in mutations:
            m = req.mutations.add()
            m.set_nquads = set_nq.encode()
            if cond:
                m.cond = cond
        resp = self._client._stub.query(req)
        if commit_now:
            self._finished = True
        return dict(resp.uids)

    def commit(self) -> int:
        if self._finished:
            raise RuntimeError("transaction already finished")
        self._finished = True
        if not self._start_ts:
            return 0  # nothing happened
        ctx = self._client._stub.commit_or_abort(
            pb.TxnContext(start_ts=self._start_ts)
        )
        return ctx.commit_ts

    def discard(self):
        if self._finished or not self._start_ts:
            self._finished = True
            return
        self._finished = True
        self._client._stub.commit_or_abort(
            pb.TxnContext(start_ts=self._start_ts, aborted=True)
        )


class DgraphClient:
    def __init__(self, *stubs: DgraphClientStub):
        if not stubs:
            raise ValueError("at least one stub required")
        self._stubs = list(stubs)
        self._i = 0

    @property
    def _stub(self) -> DgraphClientStub:
        # round-robin across stubs (pydgraph any_client)
        self._i = (self._i + 1) % len(self._stubs)
        return self._stubs[self._i]

    def login(self, userid: str, password: str, namespace: int = 0) -> dict:
        resp = self._stub.login(
            pb.LoginRequest(
                userid=userid, password=password, namespace=namespace
            )
        )
        return json.loads(resp.json or b"{}")

    def alter(
        self,
        schema: str = "",
        drop_attr: str = "",
        drop_all: bool = False,
    ):
        op = pb.Operation(schema=schema, drop_attr=drop_attr, drop_all=drop_all)
        return self._stub.alter(op)

    def txn(self, read_only: bool = False) -> Txn:
        return Txn(self, read_only=read_only)

    def check_version(self) -> str:
        return self._stub.check_version(pb.Check()).tag
