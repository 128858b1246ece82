"""MCP server: expose the engine to LLM agents over JSON-RPC.

Mirrors dgraph/dgraph/cmd/mcp (mcp_server.go:58 NewMCPServer):
tools RunQuery / RunMutation / AlterSchema / GetSchema / GetCommonQueries
over the Model Context Protocol (JSON-RPC 2.0, stdio framing or direct
handle() calls for embedding/tests).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional

_TOOLS = [
    {
        "name": "run_query",
        "description": "Run a DQL query and return JSON results",
        "inputSchema": {
            "type": "object",
            "properties": {"query": {"type": "string"}},
            "required": ["query"],
        },
    },
    {
        "name": "run_mutation",
        "description": "Apply an RDF mutation (set and/or delete N-Quads)",
        "inputSchema": {
            "type": "object",
            "properties": {
                "set_rdf": {"type": "string"},
                "del_rdf": {"type": "string"},
            },
        },
    },
    {
        "name": "alter_schema",
        "description": "Apply a schema definition",
        "inputSchema": {
            "type": "object",
            "properties": {"schema": {"type": "string"}},
            "required": ["schema"],
        },
    },
    {
        "name": "get_schema",
        "description": "Fetch the current schema",
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "get_common_queries",
        "description": "Example DQL queries for this database",
        "inputSchema": {"type": "object", "properties": {}},
    },
]


class McpServer:
    def __init__(self, engine):
        self.engine = engine

    # -- JSON-RPC ------------------------------------------------------------

    def handle(self, request: dict) -> Optional[dict]:
        rid = request.get("id")
        method = request.get("method", "")
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": "2024-11-05",
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": "dgraph-tpu-mcp", "version": "0.1.0"},
                }
            elif method == "tools/list":
                result = {"tools": _TOOLS}
            elif method == "tools/call":
                params = request.get("params", {})
                out = self._call_tool(
                    params.get("name", ""), params.get("arguments", {}) or {}
                )
                result = {
                    "content": [
                        {"type": "text", "text": json.dumps(out, default=str)}
                    ]
                }
            elif method == "notifications/initialized":
                return None
            else:
                return _err(rid, -32601, f"method not found: {method}")
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except Exception as e:  # noqa: BLE001 — protocol error envelope
            return _err(rid, -32000, str(e))

    def _call_tool(self, name: str, args: Dict[str, Any]):
        if name == "run_query":
            return self.engine.query(args["query"])
        if name == "run_mutation":
            txn = self.engine.new_txn()
            uids = txn.mutate_rdf(
                set_rdf=args.get("set_rdf", ""),
                del_rdf=args.get("del_rdf", ""),
                commit_now=True,
            )
            return {"uids": uids}
        if name == "alter_schema":
            self.engine.alter(args["schema"])
            return {"code": "Success"}
        if name == "get_schema":
            from dgraph_tpu_torch.admin.export import _schema_line

            return {
                "schema": "\n".join(
                    _schema_line(self.engine.schema.get(p))
                    for p in self.engine.schema.predicates()
                )
            }
        if name == "get_common_queries":
            return {
                "examples": [
                    '{ q(func: has(<pred>)) { uid expand(_all_) } }',
                    '{ q(func: eq(<pred>, "value")) { uid } }',
                    '{ q(func: similar_to(<vec-pred>, 5, "[...]")) { uid } }',
                ]
            }
        raise ValueError(f"unknown tool {name!r}")

    # -- stdio loop (ref mcp stdio transport) ---------------------------------

    def serve_stdio(self, stdin=None, stdout=None):
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = self.handle(req)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()


def _err(rid, code, msg):
    return {
        "jsonrpc": "2.0",
        "id": rid,
        "error": {"code": code, "message": msg},
    }
