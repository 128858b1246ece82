"""gRPC front-end: the api.Dgraph service stock clients speak.

Mirrors dgraph/edgraph/server.go (Query/doQuery:1396,
CommitOrAbort:2108, Alter:355) behind the public wire protocol
(protos/api.proto here; ref protos/pb.proto:559-604 service Dgraph), so a
dgo/pydgraph-style client can login, run txn queries, mutate, and commit
without knowing this isn't the reference implementation.

Txn protocol (the dgo contract): the first Query/Mutate in a txn carries
start_ts=0; the server opens a txn and returns its start_ts in
Response.txn. Later requests carry that start_ts; CommitOrAbort ends it.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from typing import Dict, Optional

import grpc

from dgraph_tpu_torch.api.server import Server, TxnHandle
from dgraph_tpu_torch.protos import load_api_pb2

pb = load_api_pb2()


class DgraphServicer:
    def __init__(self, engine: Server):
        self.engine = engine
        self._txns: Dict[int, TxnHandle] = {}
        self._lock = threading.Lock()

    # -- txn bookkeeping ------------------------------------------------------

    def _txn_for(self, start_ts: int) -> TxnHandle:
        with self._lock:
            if start_ts == 0:
                h = self.engine.new_txn()
                self._txns[h.start_ts] = h
                return h
            h = self._txns.get(start_ts)
            if h is None:
                # a read at an established ts from another replica/client:
                # synthesize a read-only view at that snapshot
                h = TxnHandle.__new__(TxnHandle)
                h.server = self.engine
                h.start_ts = start_ts
                from dgraph_tpu_torch.posting.lists import Txn

                h.txn = Txn(self.engine.kv, start_ts, mem=self.engine.mem)
                h.read_only = True
                h.finished = False
                self._txns[start_ts] = h
            return h

    def _drop_txn(self, start_ts: int):
        with self._lock:
            self._txns.pop(start_ts, None)

    # -- rpc methods ----------------------------------------------------------

    def Login(self, request, context):
        jwt = {"accessJwt": "", "refreshJwt": ""}
        if self.engine.acl is not None:
            try:
                out = self.engine.login(
                    request.userid, request.password, request.namespace
                )
                jwt = {
                    "accessJwt": out["accessJwt"],
                    "refreshJwt": out.get("refreshJwt", ""),
                }
            except Exception as e:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
        resp = pb.Response()
        resp.json = json.dumps(jwt).encode()
        return resp

    def Query(self, request, context):
        t0 = time.monotonic_ns()
        resp = pb.Response()
        try:
            if request.mutations:
                return self._do_mutations(request, resp, t0)
            variables = dict(request.vars) if request.vars else None
            # EXPLAIN/ANALYZE over gRPC: a reserved "debug" entry in
            # Request.vars (stripped before parse — it is a transport
            # flag, not a query variable) turns on plan capture
            debug = False
            if variables is not None:
                debug = variables.pop("debug", "") in ("true", "1")
                variables = variables or None
            if request.resp_format == pb.Request.RDF:
                resp.rdf = self.engine.query_rdf(
                    request.query, variables=variables
                ).encode()
                resp.txn.start_ts = 0
                resp.latency.total_ns = time.monotonic_ns() - t0
                return resp
            if request.read_only:
                out = self.engine.query(
                    request.query, variables=variables, want="raw",
                    debug=debug,
                )
                resp.txn.start_ts = 0
            else:
                h = self._txn_for(request.start_ts)
                h.txn.materialize_cols()  # read-your-writes over columns
                out = self.engine._query_parsed(
                    __import__("dgraph_tpu_torch.dql", fromlist=["parse"]).parse(
                        request.query, variables
                    ),
                    h.txn.cache,
                    0,
                    None,
                    want="raw",
                )
                resp.txn.start_ts = h.start_ts
            d = out["data"]
            # pre-encoded arena bytes splice straight into the proto
            # Json field (query/streamjson.py); plain dicts (schema
            # blocks, the txn path) dump as before
            rawb = getattr(d, "raw", None)
            resp.json = rawb if rawb is not None else json.dumps(d).encode()
            plan = (out.get("extensions") or {}).get("plan")
            if debug and plan is not None:
                # the EXPLAIN plan rides the hdrs side channel so the
                # Json payload stays byte-identical to a non-debug run
                resp.hdrs.append("plan=" + json.dumps(plan))
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        resp.latency.total_ns = time.monotonic_ns() - t0
        return resp

    def _do_mutations(self, request, resp, t0):
        """Request carrying mutations: plain mutate or upsert block
        (ref edgraph/server.go doMutate/buildUpsert)."""
        h = self._txn_for(request.start_ts)
        resp.txn.start_ts = h.start_ts
        uids: Dict[str, str] = {}
        commit_now = request.commit_now or any(
            m.commit_now for m in request.mutations
        )
        for m in request.mutations:
            if request.query:
                got = h.upsert(
                    request.query,
                    set_rdf=m.set_nquads.decode() if m.set_nquads else "",
                    del_rdf=m.del_nquads.decode() if m.del_nquads else "",
                    cond=m.cond or None,
                    commit_now=False,
                )
            elif m.set_json or m.delete_json:
                got = h.mutate_json(
                    set_obj=json.loads(m.set_json) if m.set_json else None,
                    del_obj=(
                        json.loads(m.delete_json) if m.delete_json else None
                    ),
                    commit_now=False,
                )
            else:
                got = h.mutate_rdf(
                    set_rdf=m.set_nquads.decode() if m.set_nquads else "",
                    del_rdf=m.del_nquads.decode() if m.del_nquads else "",
                    commit_now=False,
                )
            uids.update(got or {})
        if commit_now:
            commit_ts = h.commit()
            resp.txn.commit_ts = commit_ts
            self._drop_txn(h.start_ts)
        for k, v in uids.items():
            resp.uids[k] = v
        resp.latency.total_ns = time.monotonic_ns() - t0
        return resp

    def Alter(self, request, context):
        try:
            if request.drop_all or request.drop_op == pb.Operation.ALL:
                self.engine.alter(drop_all=True)
            elif request.drop_attr or request.drop_op == pb.Operation.ATTR:
                self.engine.alter(
                    drop_attr=request.drop_attr or request.drop_value
                )
            else:
                self.engine.alter(schema_text=request.schema)
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        out = pb.Payload()
        out.Data = b"Done"
        return out

    def CommitOrAbort(self, request, context):
        h = self._txns.get(request.start_ts)
        ctx = pb.TxnContext()
        ctx.start_ts = request.start_ts
        if request.aborted:
            if h is not None and not h.finished:
                h.discard()
            self._drop_txn(request.start_ts)
            ctx.aborted = True
            return ctx
        if h is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"no transaction at start_ts {request.start_ts}",
            )
        try:
            ctx.commit_ts = h.commit()
        except Exception as e:
            ctx.aborted = True
            self._drop_txn(request.start_ts)
            context.abort(grpc.StatusCode.ABORTED, str(e))
        self._drop_txn(request.start_ts)
        return ctx

    def CheckVersion(self, request, context):
        v = pb.Version()
        v.tag = "dgraph-tpu"
        return v


def serve(engine: Server, host: str = "127.0.0.1", port: int = 0):
    """Start the gRPC server; returns (grpc_server, bound_port)."""
    servicer = DgraphServicer(engine)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    handlers = {
        "Login": grpc.unary_unary_rpc_method_handler(
            servicer.Login,
            request_deserializer=pb.LoginRequest.FromString,
            response_serializer=pb.Response.SerializeToString,
        ),
        "Query": grpc.unary_unary_rpc_method_handler(
            servicer.Query,
            request_deserializer=pb.Request.FromString,
            response_serializer=pb.Response.SerializeToString,
        ),
        "Alter": grpc.unary_unary_rpc_method_handler(
            servicer.Alter,
            request_deserializer=pb.Operation.FromString,
            response_serializer=pb.Payload.SerializeToString,
        ),
        "CommitOrAbort": grpc.unary_unary_rpc_method_handler(
            servicer.CommitOrAbort,
            request_deserializer=pb.TxnContext.FromString,
            response_serializer=pb.TxnContext.SerializeToString,
        ),
        "CheckVersion": grpc.unary_unary_rpc_method_handler(
            servicer.CheckVersion,
            request_deserializer=pb.Check.FromString,
            response_serializer=pb.Version.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("api.Dgraph", handlers),)
    )
    bound = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server, bound
