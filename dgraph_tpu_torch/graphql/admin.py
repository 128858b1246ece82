"""Admin GraphQL endpoint (/admin).

Mirrors dgraph/graphql/admin (admin.go: the ops schema served at
/admin — health/state/getGQLSchema queries; updateGQLSchema, export,
backup, draining, shutdown, config mutations) resolved directly against
the engine, reusing the operation parser.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from dgraph_tpu_torch.graphql.parser import Operation, Selection, parse_operation

_START = time.time()


class AdminGraphQL:
    def __init__(self, engine):
        self.engine = engine

    def execute(self, query: str, variables: Optional[dict] = None) -> dict:
        try:
            op = parse_operation(query, variables)
            data: Dict[str, Any] = {}
            for sel in op.selections:
                if op.kind == "mutation":
                    data[sel.key] = self._mutation(sel)
                else:
                    data[sel.key] = self._query(sel)
            return {"data": data}
        except Exception as e:  # noqa: BLE001 — GraphQL error envelope
            return {"data": None, "errors": [{"message": str(e)}]}

    # -- queries -------------------------------------------------------------

    def _query(self, sel: Selection):
        if sel.name == "health":
            return [
                {
                    "instance": "alpha",
                    "status": "healthy",
                    "version": "0.1.0",
                    "uptime": int(time.time() - _START),
                }
            ]
        if sel.name == "state":
            return {
                "counter": self.engine.zero.max_assigned,
                "maxUID": self.engine.zero._max_uid,
                "groups": {
                    "1": {
                        "tablets": {
                            p: {"predicate": p}
                            for p in self.engine.schema.predicates()
                        }
                    }
                },
            }
        if sel.name == "getGQLSchema":
            gql = getattr(self.engine, "graphql", None)
            return {"schema": gql.sdl if gql else ""}
        if sel.name == "config":
            return {
                "cacheMb": getattr(self.engine, "cache_mb", 0),
                "logDQLRequest": False,
            }
        if sel.name == "task":
            from dgraph_tpu_torch.admin import tasks

            tid = int(str(sel.args.get("input", {}).get("id", "0x0")), 16)
            st = tasks._queue_of(self.engine).status(tid)
            return st or {"status": "Unknown"}
        raise ValueError(f"unknown admin query {sel.name!r}")

    # -- mutations -----------------------------------------------------------

    def _mutation(self, sel: Selection):
        if sel.name == "updateGQLSchema":
            from dgraph_tpu_torch.graphql import GraphQLServer

            sdl = sel.args.get("input", {}).get("set", {}).get("schema", "")
            self.engine.graphql = GraphQLServer(self.engine, sdl)
            return {"gqlSchema": {"schema": sdl}}
        if sel.name == "export":
            import tempfile

            from dgraph_tpu_torch.admin import tasks

            dest = sel.args.get("input", {}).get(
                "destination", tempfile.mkdtemp(prefix="dgraph_export_")
            )
            tid = tasks.enqueue_export(self.engine, dest)
            st = tasks._queue_of(self.engine).wait(tid)
            return {
                "response": {
                    "code": st.get("status", "Unknown"),
                    "message": f"export to {dest}",
                },
                "taskId": f"{tid:#x}",
            }
        if sel.name == "backup":
            from dgraph_tpu_torch.admin import tasks

            dest = sel.args.get("input", {}).get(
                "destination", "/tmp/dgraph_tpu_backup"
            )
            tid = tasks.enqueue_backup(self.engine, dest)
            st = tasks._queue_of(self.engine).wait(tid)
            return {
                "response": {
                    "code": st.get("status", "Unknown"),
                    "message": f"backup to {dest}",
                },
                "taskId": f"{tid:#x}",
            }
        if sel.name == "draining":
            enable = bool(sel.args.get("enable", True))
            self.engine.draining = enable
            return {
                "response": {
                    "code": "Success",
                    "message": f"draining mode set to {enable}",
                }
            }
        if sel.name == "shutdown":
            return {"response": {"code": "Success", "message": "Done"}}
        if sel.name == "config":
            cache = sel.args.get("input", {}).get("cacheMb")
            if cache is not None:
                self.engine.cache_mb = cache
            return {"response": {"code": "Success", "message": "Done"}}
        if sel.name == "addNamespace":
            from dgraph_tpu_torch.admin.namespace import NamespaceManager

            pw = sel.args.get("input", {}).get("password", "password")
            ns = NamespaceManager(self.engine).create_namespace(pw)
            return {
                "namespaceId": ns,
                "message": f"Created namespace {ns}",
            }
        if sel.name == "deleteNamespace":
            from dgraph_tpu_torch.admin.namespace import NamespaceManager

            ns = int(sel.args.get("input", {}).get("namespaceId", -1))
            NamespaceManager(self.engine).delete_namespace(ns)
            return {
                "namespaceId": ns,
                "message": f"Deleted namespace {ns}",
            }
        raise ValueError(f"unknown admin mutation {sel.name!r}")
