"""ClusterFacade: the Server surface over a DistributedCluster.

The HTTP and gRPC front-ends (api/http_server.py, api/grpc_server.py)
speak to the single-node Server interface. This adapter lets the same
front-ends serve a sharded, replicated cluster (ref edgraph/server.go
running on every alpha, with worker/ fanning out): queries read through
the tablet-routed KV, transactions commit through group raft proposals,
alter fans schema to the cluster, admin ops (export/backup) stream
through the routing view.
"""

from __future__ import annotations

from typing import Dict, Optional

from dgraph_tpu_torch.worker.groups import ClusterTxn, DistributedCluster
from dgraph_tpu_torch.x import keys


class _ZeroFace:
    """ZeroLite-compatible face over the cluster's ZeroService."""

    def __init__(self, svc):
        self._svc = svc

    def __getattr__(self, name):
        return getattr(self._svc.zero, name)


class _TxnFace(ClusterTxn):
    """ClusterTxn + the TxnHandle surface the front-ends use."""

    def __init__(self, cluster, facade):
        super().__init__(cluster)
        self._facade = facade
        self.finished = False

    def query(self, q: str, access_jwt: Optional[str] = None) -> dict:
        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.query.streamjson import encode_response_data
        from dgraph_tpu_torch.query.subgraph import Executor

        ex = Executor(
            self.txn.cache,
            self.cluster.schema,
            vector_indexes=self.cluster.vector_indexes,
        )
        nodes = ex.process(dql.parse(q))
        data, _ = encode_response_data(
            nodes, val_vars=ex.val_vars, schema=self.cluster.schema
        )
        return {"data": data}

    def mutate_json(
        self, set_obj=None, del_obj=None, commit_now=False, access_jwt=None
    ):
        # reuse the single-node JSON walker against the cluster txn
        uids = self._facade._apply_json(self.txn, set_obj, del_obj)
        if commit_now:
            self.commit()
        return uids

    def mutate_rdf(self, set_rdf="", del_rdf="", commit_now=False,
                   access_jwt=None):
        # register tablets for written predicates, then reuse the
        # single-node RDF applier
        from dgraph_tpu_torch.loaders.rdf import parse_rdf

        for nq in parse_rdf(set_rdf) + parse_rdf(del_rdf):
            self.cluster.zero.should_serve(nq.predicate)
        uids = self._facade._apply_rdf(self.txn, set_rdf, del_rdf)
        if commit_now:
            self.commit()
        return uids

    def upsert(self, query, set_rdf="", del_rdf="", cond=None,
               commit_now=True, access_jwt=None):
        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.api.server import Server, _eval_cond
        from dgraph_tpu_torch.query.subgraph import Executor

        ex = Executor(
            self.txn.cache,
            self.cluster.schema,
            vector_indexes=self.cluster.vector_indexes,
        )
        ex.process(dql.parse(query))
        uid_vars = {k: [int(u) for u in v] for k, v in ex.uid_vars.items()}
        if cond is not None and not _eval_cond(cond, uid_vars):
            if commit_now:
                self.commit()
            return {}
        from dgraph_tpu_torch.loaders.rdf import parse_rdf

        for nq in parse_rdf(set_rdf) + parse_rdf(del_rdf):
            self.cluster.zero.should_serve(nq.predicate)
        out = self._facade._apply_rdf_with_vars(
            self.txn, set_rdf, del_rdf, uid_vars, ex.val_vars
        )
        if commit_now:
            self.commit()
        return out

    def commit(self) -> int:
        if self.finished:
            raise RuntimeError("transaction already finished")
        self.finished = True
        return super().commit()

    def discard(self):
        self.finished = True
        self.cluster.zero.zero.abort(self.start_ts)


class ClusterFacade:
    """Duck-types the api.server.Server attributes the front-ends touch."""

    def __init__(self, cluster: DistributedCluster):
        self.cluster = cluster
        self.kv = cluster.read_kv()
        self.zero = _ZeroFace(cluster.zero)
        self.acl = None
        self.audit = None
        self.draining = False
        self.slow_query_ms = 1000.0
        from dgraph_tpu_torch.utils.cmsketch import StatsHolder

        self.stats = StatsHolder()

    # attribute pass-throughs -------------------------------------------------

    @property
    def schema(self):
        return self.cluster.schema

    @property
    def mem(self):
        return self.cluster.mem

    @property
    def vector_indexes(self):
        return self.cluster.vector_indexes

    def _audit(self, *a, **kw):
        pass

    # telemetry passthroughs: the HTTP /debug endpoints duck-type these
    # off the engine (cluster views when available)

    def health(self) -> dict:
        return self.cluster.health()

    def merged_tablets(self) -> dict:
        return self.cluster.merged_tablets()

    # borrow the single-node mutation appliers (they only touch
    # self.zero/self.schema, both duck-typed here)
    from dgraph_tpu_torch.api.server import Server as _S

    _nquad_edge = _S._nquad_edge
    _apply_nquad = _S._apply_nquad
    _apply_nquads = _S._apply_nquads
    _apply_rdf = _S._apply_rdf
    _apply_rdf_with_vars = _S._apply_rdf_with_vars
    _apply_json = _S._apply_json
    _authorize_mutation = _S._authorize_mutation
    del _S

    # server surface ----------------------------------------------------------

    def alter(self, schema_text: str = "", drop_attr: str = "",
              drop_all: bool = False):
        if drop_all:
            self.cluster.drop_all()
            return
        if drop_attr:
            self.cluster.drop_attr(drop_attr)
            return
        self.cluster.alter(schema_text)

    def new_txn(self, read_only: bool = False) -> _TxnFace:
        return _TxnFace(self.cluster, self)

    def query(
        self,
        q: str,
        read_ts: Optional[int] = None,
        access_jwt: Optional[str] = None,
        variables: Optional[Dict[str, str]] = None,
        timeout_ms: Optional[float] = None,
        want: str = "dict",
        debug: bool = False,
    ) -> dict:
        import time as _time

        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.posting.lists import LocalCache
        from dgraph_tpu_torch.query.streamjson import encode_response_data
        from dgraph_tpu_torch.query.subgraph import Executor
        from dgraph_tpu_torch.utils.observe import profile_scope

        t0 = _time.perf_counter()
        ts = read_ts if read_ts is not None else self.cluster.zero.zero.read_ts()
        cache = LocalCache(self.kv, ts, mem=self.cluster.mem)
        ex = Executor(
            cache,
            self.cluster.schema,
            vector_indexes=self.cluster.vector_indexes,
            stats=self.stats,
            deadline=(
                _time.monotonic() + timeout_ms / 1e3
                if timeout_ms is not None
                else None
            ),
        )
        with profile_scope(debug=debug) as prof:
            nodes = ex.process(dql.parse(q, variables))
        data, _ = encode_response_data(
            nodes, val_vars=ex.val_vars, schema=self.cluster.schema,
            want=want,
        )
        out = {"data": data}
        if prof.plan is not None:
            prof.plan.meta = {
                "read_ts": int(ts),
                "wall_ns": int((_time.perf_counter() - t0) * 1e9),
            }
            out["extensions"] = {"plan": prof.plan.to_dict()}
        return out

    def query_rdf(self, q, read_ts=None, variables=None) -> str:
        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.posting.lists import LocalCache
        from dgraph_tpu_torch.query.outputrdf import encode_rdf
        from dgraph_tpu_torch.query.subgraph import Executor

        ts = read_ts if read_ts is not None else self.cluster.zero.zero.read_ts()
        ex = Executor(
            LocalCache(self.kv, ts, mem=self.cluster.mem),
            self.cluster.schema,
            vector_indexes=self.cluster.vector_indexes,
        )
        return encode_rdf(ex.process(dql.parse(q, variables)))
