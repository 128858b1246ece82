"""HTTP front-end: the Alpha endpoint surface.

Mirrors dgraph/dgraph/cmd/alpha (setupServer run.go:458, http.go,
admin.go): /query, /mutate, /commit, /alter, /health, /state,
/admin/schema, /admin/export, /admin/backup, /debug/prometheus_metrics.
JSON bodies and response envelope follow the reference's
{"data": ..., "extensions": {"server_latency": ...}} shape.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch.acl.acl import AclError
from dgraph_tpu_torch.acl.jwt import JwtError
from dgraph_tpu_torch.dql.parser import ParseError
from dgraph_tpu_torch.query import streamjson
from dgraph_tpu_torch.query.functions import QueryError
from dgraph_tpu_torch.api.server import Server, TxnHandle
from dgraph_tpu_torch.serving import TooManyRequestsError
from dgraph_tpu_torch.worker.remote import RetryBudgetExhausted
from dgraph_tpu_torch.worker.tabletmove import TabletFencedError
from dgraph_tpu_torch.zero.zero import TxnConflictError


class _Handler(BaseHTTPRequestHandler):
    server_version = "dgraph-tpu/0.1"
    engine: Server = None  # type: ignore[assignment]
    txns: Dict[int, TxnHandle] = {}
    txn_owner: Dict[int, str] = {}
    metrics: Dict[str, float] = {}

    def log_message(self, *a):  # quiet
        pass

    # -- helpers -------------------------------------------------------------

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def _reply(self, obj, code=200):
        # responses whose `data` carries pre-encoded wire bytes (the
        # streaming arena encoder, query/streamjson.py) are SPLICED —
        # the result tree never runs through json.dumps a second time
        raw = (
            streamjson.response_bytes(obj)
            if isinstance(obj, dict)
            else None
        )
        data = raw if raw is not None else json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _error(self, msg, code=400):
        self._reply(
            {"errors": [{"message": str(msg), "extensions": {"code": "Error"}}]},
            code,
        )

    def _count(self, name):
        self.metrics[name] = self.metrics.get(name, 0) + 1

    # -- routes ---------------------------------------------------------------

    def do_GET(self):
        parsed_url = urlparse(self.path)
        path = parsed_url.path
        get_qs = parse_qs(parsed_url.query)
        if path == "/graphql":
            from dgraph_tpu_torch.api import ws

            if ws.is_upgrade(self.headers):
                # GraphQL subscriptions over websocket (ref
                # graphql/subscription/poller.go transport)
                if ws.handshake(self):
                    ws.serve_graphql_ws(self, self.engine)
                self.close_connection = True
                return
        if path == "/health":
            self._reply(
                [
                    {
                        "instance": "alpha",
                        "status": "healthy",
                        "version": "0.1.0",
                        "uptime": int(time.time() - _START),
                    }
                ]
            )
        elif path == "/state":
            self._reply(
                {
                    "counter": self.engine.zero.max_assigned,
                    "maxUID": self.engine.zero._max_uid,
                    "groups": {"1": {"tablets": {
                        p: {"predicate": p}
                        for p in self.engine.schema.predicates()
                    }}},
                }
            )
        elif path == "/admin/schema":
            from dgraph_tpu_torch.admin.export import _schema_line

            lines = [
                _schema_line(self.engine.schema.get(p))
                for p in self.engine.schema.predicates()
            ]
            self._reply({"data": {"schema": "\n".join(lines)}})
        elif path == "/debug/traces":
            from dgraph_tpu_torch.utils.observe import TRACER

            # a cluster engine (ProcCluster) merges every process's
            # spans; single-process engines serve the local ring
            merged_traces = getattr(self.engine, "merged_traces", None)
            if merged_traces is not None:
                self._reply({"spans": merged_traces(200)})
            else:
                self._reply({"spans": TRACER.recent(200)})
        elif path == "/debug/tablets":
            from dgraph_tpu_torch.utils.observe import TABLETS

            # cluster engines merge every alpha's traffic rows (plus
            # unreachable_instances); single-process engines serve the
            # local accumulator
            merged_tablets = getattr(self.engine, "merged_tablets", None)
            if merged_tablets is not None:
                self._reply(merged_tablets())
            else:
                TABLETS.publish()
                self._reply({"tablets": TABLETS.snapshot()})
        elif path == "/debug/healthz":
            from dgraph_tpu_torch.utils import observe

            health = getattr(self.engine, "health", None)
            self._reply(health() if health is not None else observe.healthz())
        elif path == "/debug/digests":
            # cluster engines merge every process's digest store
            # (rows summed by (ns, shape)); single-process engines
            # serve the local store
            merged_digests = getattr(self.engine, "merged_digests", None)
            if merged_digests is not None:
                self._reply(merged_digests())
            else:
                from dgraph_tpu_torch.serving.digest import DIGESTS

                self._reply({"digests": DIGESTS.snapshot()})
        elif path == "/debug/history":
            from dgraph_tpu_torch.utils.observe import HISTORY

            try:
                window = float(get_qs.get("window", ["600"])[0])
            except ValueError:
                window = 600.0
            merged_history = getattr(self.engine, "merged_history", None)
            if merged_history is not None:
                self._reply(merged_history(window))
            else:
                self._reply(HISTORY.report(window))
        elif path == "/debug/profile":
            from dgraph_tpu_torch.utils.profiler import AUTO, PROFILER

            if get_qs.get("last"):
                folded = AUTO.last() or ""
                data = folded.encode()
                self.send_response(200 if folded else 404)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                try:
                    seconds = float(get_qs.get("seconds", ["5"])[0])
                except ValueError:
                    seconds = 5.0
                data = PROFILER.profile(
                    min(max(seconds, 0.05), 60.0)
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
        elif path == "/debug/slowlog":
            from dgraph_tpu_torch.utils.observe import slow_query_log

            body = b""
            log = slow_query_log()
            if log is not None:
                try:
                    with open(log.path, "rb") as f:
                        body = f.read()
                except OSError:
                    body = b""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/debug/config":
            from dgraph_tpu_torch.x import config as _cfg

            self._reply(_cfg.resolved())
        elif path == "/debug/bundle":
            bundle = getattr(self.engine, "debug_bundle", None)
            if bundle is None:
                return self._error("no cluster engine behind this facade", 404)
            try:
                window = float(get_qs.get("window", ["600"])[0])
            except ValueError:
                window = 600.0
            self._reply(bundle(window))
        elif path == "/debug/openmetrics":
            from dgraph_tpu_torch.utils.observe import METRICS

            data = METRICS.render_openmetrics().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8",
            )
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path == "/debug/prometheus_metrics":
            from dgraph_tpu_torch.utils.observe import METRICS

            out = []
            for k, v in sorted(self.metrics.items()):
                out.append(f"# TYPE dgraph_tpu_http_{k} counter")
                out.append(f"dgraph_tpu_http_{k} {v}")
            # cluster engines scrape every alpha/zero process and merge
            # (counters summed, histogram buckets merged, per-instance
            # labels); single-process engines render the local registry
            merged = getattr(self.engine, "merged_metrics", None)
            out.append(merged() if merged is not None else METRICS.render())
            data = ("\n".join(out) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._error(f"no route {path}", 404)

    def do_POST(self):
        t0 = time.time()
        parsed = urlparse(self.path)
        path = parsed.path
        qs = parse_qs(parsed.query)
        token = self.headers.get("X-Dgraph-AccessToken")
        # admin/DDL routes are guardian-only once ACL is enabled
        # (ref edgraph alter/admin guardian checks)
        _GUARDED = (
            "/alter", "/admin", "/admin/export", "/admin/backup",
            "/admin/restore", "/admin/cdc",
            "/admin/schema/graphql", "/admin/draining", "/admin/shutdown",
            "/admin/task",
            # GraphQL resolvers run inside the engine without per-predicate
            # enforcement this round; guardian-only when ACL is on (the
            # reference gates GraphQL with its own @auth system instead)
            "/graphql",
        )
        try:
            if self.engine.acl is not None and path in _GUARDED:
                if not self.engine.acl.is_guardian(token):
                    return self._error(
                        "only guardians can access this endpoint", 403
                    )
            if self.engine.acl is not None and path == "/commit":
                # commits/aborts are bound to the txn owner's identity
                ts_q = int(qs.get("startTs", ["0"])[0])
                owner = self.txn_owner.get(ts_q)
                try:
                    caller = self.engine.acl.claims(token)["userid"] if token else None
                except Exception:
                    caller = None
                if caller is None or (owner is not None and owner != caller):
                    return self._error(
                        "access token required to commit this transaction", 401
                    )
            if path == "/login":
                if self.engine.acl is None:
                    return self._error("ACL not enabled", 400)
                body = json.loads(self._body().decode("utf-8"))
                if body.get("refreshToken"):
                    toks = self.engine.acl.refresh(body["refreshToken"])
                    self.engine._audit("login-refresh")
                else:
                    toks = self.engine.login(
                        body.get("userid", ""),
                        body.get("password", ""),
                        int(body.get("namespace", 0)),
                    )
                self._reply({"data": toks})
            elif path == "/query":
                self._count("num_queries")
                if qs.get("respFormat", [""])[0] == "rdf":
                    raw = self._body().decode("utf-8")
                    rdf = self.engine.query_rdf(raw)
                    data = rdf.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/n-quads")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                raw = self._body().decode("utf-8")
                variables = None
                # EXPLAIN/ANALYZE: ?debug=true (the reference's debug
                # query param) or a "debug": true JSON body field turns
                # on plan capture; data bytes are unchanged by it
                debug = qs.get("debug", ["false"])[0] == "true"
                if "json" in self.headers.get("Content-Type", ""):
                    body = json.loads(raw)
                    if not isinstance(body, dict):
                        raise ValueError("JSON query body must be an object")
                    raw = body.get("query", "")
                    variables = body.get("variables")
                    if variables is not None and not isinstance(variables, dict):
                        raise ValueError('"variables" must be an object')
                    # accept only explicit truthy spellings: a client
                    # sending the STRING "false" must not enable debug
                    debug = body.get("debug", debug) in (True, "true", "1")
                timeout_ms = None
                if qs.get("timeout"):
                    t = qs["timeout"][0]  # "5s" / "500ms" (ref ?timeout=)
                    timeout_ms = (
                        float(t[:-2]) if t.endswith("ms")
                        else float(t.rstrip("s")) * 1e3
                    )
                res = self.engine.query(
                    raw,
                    access_jwt=token,
                    variables=variables,
                    timeout_ms=timeout_ms,
                    # serving surface: data stays wire bytes end-to-end
                    # (no dict parse-back; _reply splices the arena)
                    want="raw",
                    debug=debug,
                )
                # keep the engine's server_latency/profile/trace_id and
                # stamp the HTTP-layer total on top (reference envelope)
                ext = res.setdefault("extensions", {})
                lat = ext.setdefault("server_latency", {})
                lat["total_ns"] = int((time.time() - t0) * 1e9)
                self._reply(res)
            elif path == "/mutate":
                if getattr(self.engine, "draining", False):
                    return self._error(
                        "the server is in draining mode", 503
                    )
                self._count("num_mutations")
                self._handle_mutate(qs, token)
            elif path == "/commit":
                ts = int(qs.get("startTs", ["0"])[0])
                txn = self.txns.pop(ts, None)
                self.txn_owner.pop(ts, None)
                if txn is None:
                    return self._error(f"no pending txn with startTs {ts}")
                if qs.get("abort", ["false"])[0] == "true":
                    txn.discard()
                    return self._reply({"data": {"code": "Success", "message": "Done"}})
                commit_ts = txn.commit()
                self._reply({"data": {"code": "Success", "commitTs": commit_ts}})
            elif path == "/alter":
                if getattr(self.engine, "draining", False):
                    return self._error("the server is in draining mode", 503)
                body = self._body().decode("utf-8")
                try:
                    op = json.loads(body)
                except json.JSONDecodeError:
                    op = {"schema": body}
                if op.get("drop_all"):
                    self.engine.alter(drop_all=True)
                elif op.get("drop_attr"):
                    self.engine.alter(drop_attr=op["drop_attr"])
                else:
                    self.engine.alter(op.get("schema", ""))
                self._reply({"data": {"code": "Success", "message": "Done"}})
            elif path == "/graphql":
                body = json.loads(self._body().decode("utf-8"))
                gql = getattr(self.engine, "graphql", None)
                if gql is None:
                    return self._error("no GraphQL schema configured", 400)
                # @auth JWT: read the header named by Dgraph.Authorization
                token = None
                if gql.auth_config is not None:
                    token = self.headers.get(gql.auth_config.header)
                self._reply(
                    gql.execute(
                        body.get("query", ""),
                        body.get("variables"),
                        jwt_token=token,
                    )
                )
            elif path == "/admin":
                # the admin GraphQL schema (ref graphql/admin/admin.go)
                from dgraph_tpu_torch.graphql.admin import AdminGraphQL

                body = json.loads(self._body().decode("utf-8"))
                self._reply(
                    AdminGraphQL(self.engine).execute(
                        body.get("query", ""), body.get("variables")
                    )
                )
            elif path == "/admin/schema/graphql":
                # upload an SDL schema (ref graphql/admin updateGQLSchema)
                from dgraph_tpu_torch.graphql import GraphQLServer

                sdl = self._body().decode("utf-8")
                self.engine.graphql = GraphQLServer(self.engine, sdl)
                self._reply({"data": {"code": "Success", "message": "Done"}})
            elif path == "/admin/export":
                import tempfile

                from dgraph_tpu_torch.admin import tasks

                out_dir = qs.get(
                    "destination", [tempfile.mkdtemp(prefix="dgraph_export_")]
                )[0]
                tid = tasks.enqueue_export(self.engine, out_dir)
                st = tasks._queue_of(self.engine).wait(tid)
                ok = st.get("status") == "Success"
                self._reply(
                    {"data": {"code": st.get("status", "Unknown"), **st}},
                    200 if ok else 500,
                )
            elif path == "/admin/backup":
                from dgraph_tpu_torch.admin import tasks

                dest = qs.get("destination", ["/tmp/dgraph_tpu_backup"])[0]
                full = qs.get("full", ["false"])[0] == "true"
                tid = tasks.enqueue_backup(
                    self.engine, dest, incremental=not full
                )
                if qs.get("wait", ["true"])[0] == "true":
                    # distributed online backups can legitimately run
                    # long (move drains alone cost up to the fence
                    # deadline per tablet) — the queue default of 30s
                    # would 500 a backup that later succeeds
                    st = tasks._queue_of(self.engine).wait(
                        tid, timeout=300
                    )
                    ok = st.get("status") == "Success"
                    self._reply(
                        {"data": {"code": st.get("status", "Unknown"), **st}},
                        200 if ok else 500,
                    )
                else:
                    self._reply(
                        {"data": {"code": "Success", "taskId": f"{tid:#x}"}}
                    )
            elif path == "/admin/restore":
                from dgraph_tpu_torch.admin import tasks

                src = qs.get("source", [""])[0]
                if not src:
                    return self._error("restore needs ?source=<dir>")
                tid = tasks.enqueue_restore(self.engine, src)
                if qs.get("wait", ["true"])[0] == "true":
                    st = tasks._queue_of(self.engine).wait(tid, timeout=300)
                    ok = st.get("status") == "Success"
                    self._reply(
                        {"data": {"code": st.get("status", "Unknown"), **st}},
                        200 if ok else 500,
                    )
                else:
                    self._reply(
                        {"data": {"code": "Success", "taskId": f"{tid:#x}"}}
                    )
            elif path == "/admin/cdc":
                from dgraph_tpu_torch.admin.cdc import cdc_for_uri

                sink = qs.get("sink", [""])[0]
                cdc = getattr(self.engine, "_cdc", None)
                if qs.get("disable", [""])[0] == "true":
                    if cdc is not None:
                        cdc.close()
                    self._reply({"data": {"code": "Success",
                                          "enabled": False}})
                elif sink:
                    if cdc is not None:
                        cdc.close()
                    cdc = cdc_for_uri(self.engine, sink)
                    self._reply(
                        {
                            "data": {
                                "code": "Success",
                                "enabled": True,
                                "sink": sink,
                                "checkpoint": cdc.checkpoint,
                            }
                        }
                    )
                else:
                    # status probe; `dead` means the emitter thread is
                    # gone and events defer to replay — re-enable with
                    # ?sink= to recover the stream
                    self._reply(
                        {
                            "data": {
                                "enabled": cdc is not None,
                                "sink": getattr(cdc, "sink_uri", None),
                                "checkpoint": (
                                    cdc.checkpoint if cdc else 0
                                ),
                                "dead": bool(
                                    cdc is not None and cdc.dead
                                ),
                            }
                        }
                    )
            elif path == "/admin/task":
                tid = int(qs.get("id", ["0"])[0], 16)
                from dgraph_tpu_torch.admin import tasks

                st = tasks._queue_of(self.engine).status(tid)
                if st is None:
                    return self._error(f"no task {tid:#x}", 404)
                self._reply({"data": st})
            elif path == "/admin/draining":
                enable = qs.get("enable", ["true"])[0] == "true"
                self.engine.draining = enable
                self._reply(
                    {"data": {"code": "Success",
                              "message": f"draining mode set to {enable}"}}
                )
            elif path == "/admin/shutdown":
                self._reply({"data": {"code": "Success", "message": "Done"}})
                threading.Thread(
                    target=self.server.shutdown, daemon=True
                ).start()
            else:
                self._error(f"no route {path}", 404)
        except TooManyRequestsError as e:
            # admission shed: retryable — clients back off and resend
            self._reply(
                {
                    "errors": [
                        {
                            "message": str(e),
                            "extensions": {
                                "code": TooManyRequestsError.code,
                                "retryable": True,
                            },
                        }
                    ]
                },
                429,
            )
        except TabletFencedError as e:
            # tablet move fence: the window is bounded (or awaiting
            # recovery) — retryable, never wrong data
            self._reply(
                {
                    "errors": [
                        {
                            "message": str(e),
                            "extensions": {
                                "code": TabletFencedError.code,
                                "retryable": True,
                            },
                        }
                    ]
                },
                503,
            )
        except RetryBudgetExhausted as e:
            # the query's retry/hedge budget ran dry (brownout): shed
            # retryable instead of letting clients amplify the storm
            self._reply(
                {
                    "errors": [
                        {
                            "message": str(e),
                            "extensions": {
                                "code": RetryBudgetExhausted.code,
                                "retryable": True,
                            },
                        }
                    ]
                },
                503,
            )
        except TxnConflictError as e:
            self._error(f"Transaction has been aborted. Please retry. {e}", 409)
        except (AclError, JwtError) as e:
            self._error(e, 401)
        except (json.JSONDecodeError, ValueError, ParseError, QueryError) as e:
            self._error(e, 400)  # malformed client input/query
        except Exception as e:
            traceback.print_exc()
            self._error(e, 500)

    def _handle_mutate(self, qs, token=None):
        body = self._body().decode("utf-8")
        commit_now = qs.get("commitNow", ["false"])[0] == "true"
        start_ts = int(qs.get("startTs", ["0"])[0])
        ctype = self.headers.get("Content-Type", "application/rdf")

        if start_ts and start_ts in self.txns:
            txn = self.txns[start_ts]
        else:
            txn = self.engine.new_txn()

        if "json" in ctype:
            obj = json.loads(body) if body.strip() else {}
            uids = txn.mutate_json(
                set_obj=obj.get("set"),
                del_obj=obj.get("delete"),
                access_jwt=token,
            )
        else:
            # RDF body: {set { ... } delete { ... }} or bare nquads
            set_rdf, del_rdf = _split_rdf_blocks(body)
            uids = txn.mutate_rdf(
                set_rdf=set_rdf, del_rdf=del_rdf, access_jwt=token
            )

        if commit_now:
            self.txns.pop(txn.start_ts, None)  # finished txns don't linger
            commit_ts = txn.commit()
            self._reply(
                {
                    "data": {
                        "code": "Success",
                        "uids": uids,
                        "commitTs": commit_ts,
                    }
                }
            )
        else:
            self.txns[txn.start_ts] = txn
            if self.engine.acl is not None and token:
                try:
                    self.txn_owner[txn.start_ts] = self.engine.acl.claims(
                        token
                    )["userid"]
                except Exception:
                    pass
            self._reply(
                {"data": {"code": "Success", "uids": uids, "startTs": txn.start_ts}}
            )


_START = time.time()


def _scan_block(body: str, keyword: str) -> str:
    """Extract the `keyword { ... }` block with quote-aware brace scanning
    ('}' inside RDF string literals, e.g. GeoJSON values, must not
    terminate the block; ref chunker mutation lexing)."""
    import re

    m = re.search(rf"\b{keyword}\s*\{{", body)
    if not m:
        return ""
    i = m.end()
    in_quote = False
    n = len(body)
    start = i
    while i < n:
        c = body[i]
        if in_quote:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_quote = False
        elif c == '"':
            in_quote = True
        elif c == "}":
            return body[start:i]
        i += 1
    return body[start:]


def _split_rdf_blocks(body: str):
    """Parse `{ set { ... } delete { ... } }` mutation envelopes
    (ref chunker mutation parsing); bare N-Quads treated as set."""
    set_block = _scan_block(body, "set")
    del_block = _scan_block(body, "delete")
    if set_block or del_block:
        return set_block, del_block
    return body, ""


class HTTPServer:
    """Embeddable HTTP server (the Alpha's 8080 surface)."""

    def __init__(self, engine: Server, host: str = "127.0.0.1", port: int = 8080):
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"engine": engine, "txns": {}, "txn_owner": {}, "metrics": {}},
        )
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
