"""GraphQL execution: generated API resolved onto the DQL executor.

Mirrors dgraph/graphql/resolve (query_rewriter.go,
mutation_rewriter.go, resolver.go): for each SDL type T the API exposes
  getT(id/xid), queryT(filter, order, first, offset), aggregateT(filter),
  addT(input, upsert), updateT(input: {filter, set, remove}),
  deleteT(filter), querySimilarTByEmbedding(by, topK, vector)
and resolves them by building internal GraphQuery ASTs (not text) executed
by query.subgraph.Executor, with mutations applied through the
transactional path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from dgraph_tpu_torch.dql.parser import FilterTree, FuncSpec, GraphQuery, Order
from dgraph_tpu_torch.graphql.parser import Operation, Selection, parse_operation
from dgraph_tpu_torch.graphql.sdl import GqlField, GqlType, parse_sdl, to_dql_schema
from dgraph_tpu_torch.posting.lists import LocalCache
from dgraph_tpu_torch.posting.mutation import DirectedEdge, apply_edge
from dgraph_tpu_torch.posting.pl import OP_DEL, OP_SET
from dgraph_tpu_torch.query.outputjson import JsonEncoder
from dgraph_tpu_torch.query.subgraph import Executor
from dgraph_tpu_torch.types.types import TypeID, Val
from dgraph_tpu_torch.x import config, keys

_FILTER_OPS = {
    "eq": "eq",
    "in": "eq",
    "le": "le",
    "lt": "lt",
    "ge": "ge",
    "gt": "gt",
    "between": "between",
    "anyofterms": "anyofterms",
    "allofterms": "allofterms",
    "anyoftext": "anyoftext",
    "alloftext": "alloftext",
    "regexp": "regexp",
    "near": "near",
    "within": "within",
    "contains": "contains",
    "intersects": "intersects",
}


def _gql_polygon_coords(p: dict) -> list:
    """GraphQL PolygonRef {coordinates: [{points: [{latitude,longitude}]}]}
    -> geojson-style [[[lon,lat], ...], ...] ring list."""
    return [
        [[pt["longitude"], pt["latitude"]] for pt in ring["points"]]
        for ring in p.get("coordinates", [])
    ]


def _gql_geo_to_geojson(v: dict) -> dict:
    if "longitude" in v:
        return {
            "type": "Point",
            "coordinates": [v["longitude"], v["latitude"]],
        }
    if "polygons" in v:
        return {
            "type": "MultiPolygon",
            "coordinates": [
                _gql_polygon_coords(p) for p in v["polygons"]
            ],
        }
    if "coordinates" in v:
        return {"type": "Polygon", "coordinates": _gql_polygon_coords(v)}
    return v


def _geojson_to_gql(g):
    """Stored geojson -> the GraphQL Point/Polygon/MultiPolygon shape
    (ref graphql/resolve completeGeoObject)."""
    if not isinstance(g, dict):
        return g
    t = g.get("type")
    c = g.get("coordinates")
    if t == "Point":
        return {"longitude": c[0], "latitude": c[1]}
    if t == "Polygon":
        return {
            "coordinates": [
                {
                    "points": [
                        {"longitude": p[0], "latitude": p[1]} for p in ring
                    ]
                }
                for ring in c
            ]
        }
    if t == "MultiPolygon":
        return {
            "polygons": [
                _geojson_to_gql({"type": "Polygon", "coordinates": pc})
                for pc in c
            ]
        }
    return g


class GraphQLError(Exception):
    pass


class _MutCtx:
    """Per-request mutation state (ref mutation_rewriter.go VarGenerator
    / xidMetadata): upsert flag, uids created, xids claimed by new nodes
    so in-request duplicates are rejected."""

    def __init__(self, upsert: bool = False):
        self.upsert = upsert
        self.upsert_auth = True  # add-rule verdict for upsert pre-checks
        self.now: Optional[str] = None  # one $now per request
        self.created: List[int] = []
        # (pred, xid-value) -> (new uid, the claiming input object)
        self.claimed: Dict[tuple, tuple] = {}


class GraphQLServer:
    def __init__(self, engine, sdl: str, lambda_url: Optional[str] = None):
        import threading

        from dgraph_tpu_torch.graphql.auth import parse_authorization

        self.engine = engine
        self.types: Dict[str, GqlType] = parse_sdl(sdl)
        self.sdl = sdl
        self.auth_config = parse_authorization(sdl)
        self.closed_by_default = bool(
            self.auth_config and self.auth_config.closed_by_default
        )
        # --graphql lambda-url analog (ref x.LambdaUrl): explicit arg >
        # engine attr (set by the alpha CLI superflag) > env
        self.lambda_url = (
            lambda_url
            or getattr(engine, "graphql_lambda_url", None)
            or config.get("LAMBDA_URL")
        )
        self._tls = threading.local()  # per-request JWT claims
        self._validate_remote_customs()  # reject BEFORE mutating schema
        engine.alter(to_dql_schema(self.types))

    def _validate_remote_customs(self):
        """@custom(http: {graphql: ...}) fields introspect their remote
        endpoint at schema-update time and reject selections the remote
        can't serve (ref graphql/schema/remote.go validateRemoteGraphql
        — errors surface when the schema loads, not at first request).
        Set DGRAPH_TPU_SKIP_REMOTE_INTROSPECTION=1 to defer (air-gapped
        loads)."""
        if config.get("SKIP_REMOTE_INTROSPECTION"):
            return
        from dgraph_tpu_torch.graphql.remote import (
            RemoteSchemaError,
            introspect_remote,
            validate_remote_graphql,
        )

        cache: Dict[str, dict] = {}
        for t in self.types.values():
            for f in t.fields.values():
                cfg = (f.custom or {}).get("http") or {}
                gql_op = cfg.get("graphql")
                if not gql_op:
                    continue
                url = cfg.get("url", "")
                try:
                    if url not in cache:
                        cache[url] = introspect_remote(url)
                    validate_remote_graphql(
                        cache[url],
                        gql_op,
                        f.type_name,
                        is_batch=cfg.get("mode") == "BATCH",
                    )
                except RemoteSchemaError as e:
                    raise GraphQLError(
                        f"resolving updateGQLSchema failed because "
                        f"input:{t.name}.{f.name}: {e}"
                    ) from e

    # ------------------------------------------------------------------
    # Entry
    # ------------------------------------------------------------------

    def execute(
        self,
        query: str,
        variables: Optional[Dict[str, Any]] = None,
        jwt_token: Optional[str] = None,
        claims: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        try:
            if claims is None and jwt_token and self.auth_config:
                from dgraph_tpu_torch.graphql.auth import claims_from_jwt

                claims = claims_from_jwt(jwt_token, self.auth_config)
            self._tls.claims = claims or {}
            self._tls.auth_memo = {}  # fresh verdicts per request
            if (
                getattr(self, "closed_by_default", False)
                and claims is None
                and not jwt_token
            ):
                # Dgraph.Authorization ClosedByDefault: every request
                # needs a JWT (ref x/config.go + auth closed-mode tests)
                raise GraphQLError(
                    "a valid JWT is required but was not provided"
                )
            op = parse_operation(query, variables)
            data = {}
            for sel in op.selections:
                if op.kind == "mutation":
                    data[sel.key] = self._resolve_mutation(sel)
                else:
                    data[sel.key] = self._resolve_query(sel)
            return {"data": data}
        except Exception as e:  # noqa: BLE001 — GraphQL error envelope
            return {"data": None, "errors": [{"message": str(e)}]}

    # ------------------------------------------------------------------
    # Query resolution
    # ------------------------------------------------------------------

    def _type_for(self, sel_name: str, prefixes) -> GqlType:
        for pre in prefixes:
            if sel_name.startswith(pre):
                tname = sel_name[len(pre) :]
                t = self.types.get(tname)
                if t:
                    return t
        raise GraphQLError(f"unknown operation {sel_name!r}")

    def _claims(self) -> Dict[str, Any]:
        return getattr(self._tls, "claims", {}) or {}

    def _auth(self, t: GqlType, op: str):
        """True | False | filter-dict for the operation (@auth rules,
        ref graphql/resolve query_rewriter auth injection)."""
        from dgraph_tpu_torch.graphql.auth import evaluate

        if t.auth is None:
            return True
        # per-request memo: the same (type, op) verdict is reused at
        # every nesting site (claims + snapshot are fixed per request)
        memo = getattr(self._tls, "auth_memo", None)
        if memo is None:
            memo = self._tls.auth_memo = {}
        key = (t.name, op)
        if key not in memo:
            memo[key] = evaluate(
                getattr(t.auth, op), self._claims(),
                rule_runner=self._run_auth_rule,
            )
        return memo[key]

    def _run_auth_rule(self, rule_text: str, claims, cache=None) -> List[str]:
        """Execute a deep @auth rule query with @cascade semantics and
        return the allowed root uids (the eager equivalent of the
        reference's uid-var + @cascade auth chains,
        auth_query_rewriting). cache pins the snapshot — mutation auth
        checks run against the uncommitted txn state."""
        op = parse_operation(rule_text, variables=dict(claims))
        sel = op.selections[0]
        t = self._type_for(sel.name, ["query", "get"])
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(name="type", attr=t.stored_name)
        fobj = sel.args.get("filter")
        if fobj:
            gq.filter = self._filter_tree(t, fobj)
        gq.cascade = True  # root @cascade prunes the whole subtree
        prev = getattr(self._tls, "in_auth_rule", False)
        self._tls.in_auth_rule = True
        try:
            gq.children = self._selection_children(t, sel.selections)
        finally:
            self._tls.in_auth_rule = prev
        gq.children.append(GraphQuery(attr="uid", is_uid=True))
        rows = self._run_block(gq, cache=cache)
        return [r["uid"] for r in rows if isinstance(r, dict) and "uid" in r]

    def _auth_allowed_uids(self, t: GqlType, auth_filter, uids, cache=None):
        """Subset of uids passing an auth filter dict, evaluated on the
        given snapshot (txn cache for mutation post-checks)."""
        if not uids:
            return set()
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(name="uid", args=list(uids))
        gq.filter = self._filter_tree(t, auth_filter)
        gq.children = [GraphQuery(attr="uid", is_uid=True)]
        rows = self._run_block(gq, cache=cache)
        return {int(r["uid"], 16) for r in rows}

    def _with_auth_filter(self, t: GqlType, fobj, op: str = "query"):
        """Merge the type's auth rule filter into a filter object. Returns
        (filter_obj, allowed)."""
        auth = self._auth(t, op)
        if auth is True:
            return fobj, True
        if auth is False:
            return fobj, False
        if not fobj:
            return auth, True
        return {"and": [fobj, auth]}, True

    def _resolve_query(self, sel: Selection):
        name = sel.name
        if name == "__schema" or name == "__type":
            from dgraph_tpu_torch.graphql.introspection import resolve_introspection

            return resolve_introspection(self.types, sel)
        qt = self.types.get("Query")
        if qt is not None:
            f = qt.fields.get(name)
            if f is not None and f.custom is not None:
                return self._resolve_custom(f, sel)
            if f is not None and f.is_lambda:
                return self._resolve_lambda_root("Query", f, sel)
        if name == "_entities":
            return self._entities(sel)
        if name == "_service":
            return {
                s.key: self.sdl for s in sel.selections if s.name == "sdl"
            }
        if name.startswith("check") and name.endswith("Password"):
            t = self.types.get(name[len("check") : -len("Password")])
            if t is not None:
                return self._check_password(t, sel)
        if name.startswith("get"):
            t = self._type_for(name, ["get"])
            return self._get(t, sel)
        if name.startswith("querySimilar") and name.endswith("ByEmbedding"):
            tname = name[len("querySimilar") : -len("ByEmbedding")]
            t = self.types.get(tname)
            if not t:
                raise GraphQLError(f"unknown type {tname}")
            return self._similar(t, sel)
        if name.startswith("querySimilar") and name.endswith("ById"):
            tname = name[len("querySimilar") : -len("ById")]
            t = self.types.get(tname)
            if not t:
                raise GraphQLError(f"unknown type {tname}")
            return self._similar(t, sel, by_id=True)
        if name.startswith("query"):
            t = self._type_for(name, ["query"])
            return self._query_list(t, sel)
        if name.startswith("aggregate"):
            t = self._type_for(name, ["aggregate"])
            return self._aggregate(t, sel)
        raise GraphQLError(f"unknown query {name!r}")

    def _concrete(self, row_types, fallback: str) -> str:
        """The concrete (non-interface) type among a row's dgraph.type
        values — what __typename must report for interface/union
        results (ref outputnode_graphql.go)."""
        for n in row_types or []:
            tt = self.types.get(n) or self._by_stored().get(n)
            if tt is not None and tt.kind == "type":
                return tt.name
        return fallback

    def _add_typename(self, results, t: GqlType, sels: List[Selection]):
        """Post-encode shaping: prune inline-fragment fields that don't
        apply to a row's concrete type, inject __typename (concrete via
        the hidden __dgt fetch), drop __dgt."""
        for r in results:
            if isinstance(r, dict):
                self._shape_row(r, t, sels)
        return results

    def _shape_row(self, row: dict, t: GqlType, sels: List[Selection]):
        row.pop("__uid", None)
        row_types = row.pop("__dgt", None)
        if isinstance(row_types, str):
            row_types = [row_types]
        keep: Dict[str, tuple] = {}

        def collect(tt: GqlType, ss: List[Selection]):
            for s in ss:
                if s.name == "...":
                    ft = (
                        tt if not s.frag_on else self.types.get(s.frag_on)
                    )
                    if ft is None:
                        continue
                    # with no __dgt fetched (object-type parent) every
                    # fragment matched statically; otherwise the row's
                    # dgraph.type list (which includes interfaces)
                    # decides
                    frag_t = self.types.get(s.frag_on)
                    if (
                        not s.frag_on
                        or row_types is None
                        or s.frag_on in row_types
                        or (
                            frag_t is not None
                            and frag_t.stored_name in row_types
                        )
                    ):
                        collect(ft, s.selections)
                elif s.name == "__typename":
                    row[s.key] = self._concrete(row_types, tt.name)
                    keep.setdefault(s.key, (tt, s))
                elif (
                    s.name.endswith("Aggregate")
                    and s.name[: -len("Aggregate")] in tt.fields
                ):
                    if s.key in keep:
                        continue  # already computed (fragment overlap)
                    base_f = tt.fields[s.name[: -len("Aggregate")]]
                    ct = self.types.get(base_f.type_name)
                    if (
                        ct is not None
                        and self._auth(ct, "query") is False
                    ):
                        # deny-all child auth: null, not count 0 (the
                        # hidden fetch was never emitted)
                        row[s.key] = None
                        keep.setdefault(s.key, (tt, s))
                        continue
                    items = row.pop(f"__agg_{s.key}", None) or []
                    if not isinstance(items, list):
                        items = [items]
                    row[s.key] = _compute_child_agg(
                        s, items, base_f.type_name
                    )
                    keep.setdefault(s.key, (tt, s))
                else:
                    keep.setdefault(s.key, (tt, s))

        collect(t, sels)
        for k in list(row.keys()):
            if k not in keep and not k.startswith("__lp_"):
                row.pop(k)
        for k, (tt, s) in keep.items():
            v = row.get(k)
            f = tt.fields.get(s.name)
            if v is None or f is None:
                continue
            if f.type_name in ("Point", "Polygon", "MultiPolygon"):
                row[k] = (
                    [_geojson_to_gql(x) for x in v]
                    if isinstance(v, list)
                    else _geojson_to_gql(v)
                )
                continue
            if f.is_scalar:
                continue
            ct = self.types.get(f.type_name)
            if ct is None:
                continue
            if isinstance(v, list):
                for item in v:
                    if isinstance(item, dict):
                        self._shape_row(item, ct, s.selections)
            elif isinstance(v, dict):
                self._shape_row(v, ct, s.selections)

    def _resolve_custom(self, f: GqlField, sel: Selection):
        """@custom(http: {...}) resolver (ref graphql/schema/remote.go +
        resolve/http.go): substitute $args into the URL/body template,
        call the endpoint, project the selection over the JSON reply."""
        import json as _json
        import urllib.parse
        import urllib.request

        from dgraph_tpu_torch.graphql.introspection import _project

        cfg = (f.custom or {}).get("http")
        if not cfg:
            raise GraphQLError(f"@custom field {f.name} has no http config")
        if cfg.get("graphql"):
            # remote-graphql mode (ref resolve/http.go graphql path):
            # POST {query, variables} and unwrap data.<opName>
            from dgraph_tpu_torch.graphql.remote import _OP_RE

            import re as _re

            op_text = cfg["graphql"]
            for k, v in sel.args.items():
                lit = _gql_literal(v).replace("\\", "\\\\")
                op_text = _re.sub(rf"\$({k})\b", lit, op_text)
            # unsupplied optional args: drop `name: $var` pairs rather
            # than sending literal $var tokens to the remote
            op_text = _re.sub(r"\w+\s*:\s*\$\w+\s*,?", "", op_text)
            op_text = _re.sub(r"\(\s*\)", "", op_text)
            req = urllib.request.Request(
                cfg.get("url", ""),
                data=_json.dumps({"query": op_text}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    payload = _json.loads(r.read() or b"null")
            except Exception as e:
                raise GraphQLError(
                    f"@custom graphql call failed: {e}"
                ) from e
            if payload.get("errors"):
                raise GraphQLError(str(payload["errors"]))
            m = _OP_RE.search(cfg["graphql"])
            data = (payload.get("data") or {}).get(
                m.group(2) if m else f.name
            )
            if sel.selections and isinstance(data, (dict, list)):
                return _project(data, sel.selections)
            return data
        url = cfg.get("url", "")
        for k, v in sel.args.items():
            url = url.replace(f"${k}", urllib.parse.quote(str(v)))
        method = str(cfg.get("method", "GET")).upper()
        body = None
        if cfg.get("body"):
            from dgraph_tpu_torch.graphql.auth import _parse_gql_object, _substitute

            tmpl = _parse_gql_object(cfg["body"]) if isinstance(
                cfg["body"], str
            ) else cfg["body"]
            body = _json.dumps(_substitute(tmpl, sel.args)).encode()
        req = urllib.request.Request(url, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                payload = _json.loads(r.read() or b"null")
        except Exception as e:
            raise GraphQLError(f"@custom http call failed: {e}") from e
        if sel.selections and isinstance(payload, (dict, list)):
            return _project(payload, sel.selections)
        return payload

    # ------------------------------------------------------------------
    # @lambda (ref wrappers.go buildCustomDirectiveForLambda,
    # custom_http.go GetBodyForLambda)
    # ------------------------------------------------------------------

    def _lambda_post(self, body: dict):
        import json as _json
        import urllib.request

        if not self.lambda_url:
            raise GraphQLError(
                "@lambda field used but no lambda-url configured "
                "(--graphql lambda-url / DGRAPH_TPU_LAMBDA_URL)"
            )
        req = urllib.request.Request(
            self.lambda_url,
            data=_json.dumps(body).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            return _json.loads(r.read() or b"null")

    def _resolve_lambda_root(self, parent: str, f: GqlField, sel: Selection):
        """Query./Mutation.-level @lambda: POST {resolver, args} and return
        the lambda server's value, projected over the selection."""
        from dgraph_tpu_torch.graphql.introspection import _project

        try:
            payload = self._lambda_post(
                {
                    "resolver": f"{parent}.{f.name}",
                    "args": sel.args,
                    "parents": None,
                    "authHeader": self._lambda_auth_header(),
                }
            )
        except GraphQLError:
            raise
        except Exception as e:
            raise GraphQLError(f"@lambda call failed: {e}") from e
        if sel.selections and isinstance(payload, (dict, list)):
            return _project(payload, sel.selections)
        return payload

    def _lambda_auth_header(self):
        cfg = self.auth_config
        if not cfg:
            return None
        return {"key": getattr(cfg, "header", None), "value": None}

    def _enrich_lambda_fields(
        self, t: GqlType, sels: List[Selection], rows: List[dict]
    ) -> None:
        """BATCH-mode @lambda on type fields: one POST per (type, field)
        with every row's scalar fields as `parents`; the response array
        aligns with parents (ref wrappers.go BATCH mode). Recurses into
        object-valued children; hidden __lp_ scalars are stripped."""
        if not rows:
            return
        # inline-fragment selections contribute their fields too: the
        # over-approximation (a fragment on a sibling type) is harmless
        # because _shape_row prunes non-applicable keys per row after
        sels = list(sels)
        for s in list(sels):
            if s.name == "...":
                ft = t if not s.frag_on else self.types.get(s.frag_on)
                if ft is not None:
                    sels.extend(s.selections)
        lam = [
            s
            for s in sels
            if t.fields.get(s.name) is not None and t.fields[s.name].is_lambda
        ]
        for s in sels:  # recurse into nested objects first
            f = t.fields.get(s.name)
            if f is None or f.is_scalar or f.is_lambda:
                continue
            ct = self.types.get(f.type_name)
            if ct is None:
                continue
            for row in rows:
                v = row.get(s.key)
                if isinstance(v, list):
                    self._enrich_lambda_fields(ct, s.selections, v)
                elif isinstance(v, dict):
                    self._enrich_lambda_fields(ct, s.selections, [v])
        if lam:
            parents = []
            for row in rows:
                p = {}
                for fn, fdef in t.fields.items():
                    if not fdef.is_scalar or fdef.is_lambda or fdef.custom:
                        continue
                    if fn in row:
                        p[fn] = row[fn]
                    elif f"__lp_{fn}" in row:
                        p[fn] = row[f"__lp_{fn}"]
                parents.append(p)
            for s in lam:
                try:
                    got = self._lambda_post(
                        {
                            "resolver": f"{t.name}.{s.name}",
                            "parents": parents,
                            "authHeader": self._lambda_auth_header(),
                        }
                    )
                except GraphQLError:
                    raise
                except Exception as e:
                    raise GraphQLError(f"@lambda call failed: {e}") from e
                if isinstance(got, list):
                    if len(got) != len(rows):
                        raise GraphQLError(
                            f"@lambda {t.name}.{s.name}: BATCH response has "
                            f"{len(got)} values for {len(rows)} parents"
                        )
                    vals = got
                else:
                    vals = [got] * len(rows)
                for row, v in zip(rows, vals):
                    row[s.key] = v
        for row in rows:
            for k in [k for k in row if k.startswith("__lp_")]:
                del row[k]

    def _run_block(self, gq: GraphQuery, cache=None) -> List[dict]:
        if cache is None:
            cache = LocalCache(
                self.engine.kv,
                self.engine.zero.read_ts(),
                mem=getattr(self.engine, "mem", None),
            )
        ex = Executor(
            cache, self.engine.schema, vector_indexes=self.engine.vector_indexes
        )
        nodes = ex.process([gq])
        enc = JsonEncoder(val_vars=ex.val_vars, schema=self.engine.schema)
        return enc.encode_blocks(nodes).get(gq.attr, [])

    def _merge_child_auth(self, ct: GqlType, child: GraphQuery):
        """Nested selections honor the CHILD type's query @auth rules
        (ref auth_query_rewriting: every traversal level gets its own
        uid-var auth filter — `Contact.adminTasks @filter(uid(...))`)."""
        if ct.kind == "union":
            return
        if getattr(self._tls, "in_auth_rule", False):
            return  # auth rule queries are not themselves auth-filtered
        auth = self._auth(ct, "query")
        if auth is True:
            return
        if auth is False:
            # matches nothing: uid-in-empty-set filter
            extra = FilterTree(func=FuncSpec(name="uid", args=[]))
        else:
            extra = self._filter_tree(ct, auth)
        child.filter = (
            extra
            if child.filter is None
            else FilterTree(op="and", children=[child.filter, extra])
        )

    def _selection_children(
        self, t: GqlType, sels: List[Selection]
    ) -> List[GraphQuery]:
        out = []
        has_lambda = False
        selected = set()
        need_dgt = t.kind in ("interface", "union") and any(
            s.name in ("...", "__typename") for s in sels
        )
        if need_dgt:
            # concrete-type dispatch for fragments/__typename: fetch
            # dgraph.type hidden; _shape_rows prunes with it
            out.append(GraphQuery(attr="dgraph.type", alias="__dgt"))
        for s in sels:
            if s.name == "...":
                # no type condition ('... { x }') means the enclosing type
                ft = t if not s.frag_on else self.types.get(s.frag_on)
                if ft is None or ft.kind not in ("type", "interface"):
                    raise GraphQLError(
                        f"fragment on unknown type {s.frag_on!r}"
                    )
                for c in self._selection_children(ft, s.selections):
                    if not any(
                        o.alias == c.alias and o.attr == c.attr
                        for o in out
                    ):
                        out.append(c)
                continue
            if (
                s.name.endswith("Aggregate")
                and s.name[: -len("Aggregate")] in t.fields
            ):
                # child-level aggregate field (ref gqlschema.go: every
                # object field f gets fAggregate(filter): visible as a
                # nested {count, <g>Min, ...} object). Fetch the child
                # edge hidden; _shape_row computes the aggregate.
                base = s.name[: -len("Aggregate")]
                bf = t.fields[base]
                ct = self.types.get(bf.type_name)
                hidden = GraphQuery(
                    attr=t.pred(base), alias=f"__agg_{s.key}"
                )
                if s.args.get("filter") and ct is not None:
                    hidden.filter = self._filter_tree(ct, s.args["filter"])
                if ct is not None:
                    if (
                        not getattr(self._tls, "in_auth_rule", False)
                        and self._auth(ct, "query") is False
                    ):
                        # deny-all child auth: the aggregate resolves
                        # null, NOT count 0 (ref auth_query_rewriting
                        # aggregate cases)
                        continue
                    self._merge_child_auth(ct, hidden)
                need = set()
                for a in s.selections:
                    for suffix in ("Min", "Max", "Sum", "Avg"):
                        if a.name.endswith(suffix):
                            need.add(a.name[: -len(suffix)])
                            break
                for fn in sorted(need):
                    if ct is not None and fn in ct.fields:
                        hidden.children.append(
                            GraphQuery(attr=ct.pred(fn), alias=fn)
                        )
                if not hidden.children:
                    hidden.children.append(
                        GraphQuery(attr="uid", is_uid=True, alias="uid")
                    )
                out.append(hidden)
                continue
            f = t.fields.get(s.name)
            if s.name == "__typename":
                continue  # injected post-encode (_shape_rows)
            if f is not None and f.is_lambda:
                has_lambda = True  # resolved post-query via the lambda URL
                continue
            if s.name == "id" or (f and f.type_name == "ID"):
                out.append(GraphQuery(attr="uid", is_uid=True, alias=s.key))
                continue
            if f is None:
                raise GraphQLError(f"no field {s.name!r} on type {t.name}")
            selected.add(s.name)
            child = GraphQuery(attr=t.pred(f.name), alias=s.key)
            if not f.is_scalar:
                ct = self.types.get(f.type_name)
                if ct is None:
                    raise GraphQLError(f"unknown type {f.type_name}")
                child.children = self._selection_children(ct, s.selections)
                # every object level carries uid (ref query_rewriter.go
                # injects dgraph.uid), so an entity whose requested
                # scalars are all absent still materializes as a row —
                # GraphQL returns it with null fields, DQL would omit it
                if not any(
                    c.alias == "__uid" for c in child.children
                ):
                    child.children.append(
                        GraphQuery(attr="uid", is_uid=True, alias="__uid")
                    )
                # per-field args (ref query_rewriter.go addArgumentsToField):
                # filter/order/first/offset apply to the edge expansion
                if s.args.get("filter"):
                    if ct.kind == "union":
                        child.filter = self._union_filter(
                            ct, s.args["filter"]
                        )
                    else:
                        child.filter = self._filter_tree(
                            ct, s.args["filter"]
                        )
                order = s.args.get("order") or {}
                self._apply_order(ct, child, order)
                if s.args.get("first") is not None:
                    child.first = s.args["first"]
                if s.args.get("offset") is not None:
                    child.offset = s.args["offset"]
                self._apply_cascade_dir(ct, s, child)
                self._merge_child_auth(ct, child)
            out.append(child)
        if has_lambda:
            # lambda parents carry ALL scalar fields of the type
            # (wrappers.go body template); fetch unselected ones hidden
            for fn, fdef in t.fields.items():
                if (
                    fdef.is_scalar
                    and not fdef.is_lambda
                    and not fdef.custom
                    and fdef.type_name != "ID"
                    and fn not in selected
                ):
                    out.append(
                        GraphQuery(
                            attr=t.pred(fn), alias=f"__lp_{fn}"
                        )
                    )
        # one fetch per (alias, attr): a field selected both plainly and
        # inside a matching fragment must not be fetched twice
        seen = set()
        dedup = []
        for c in out:
            key = (c.alias, c.attr)
            if key in seen:
                continue
            seen.add(key)
            dedup.append(c)
        return dedup

    def _union_filter(self, ut: GqlType, fobj: dict) -> Optional[FilterTree]:
        """Union member filter (ref query_rewriter.go buildUnionFilter):
        {memberTypes: [Dog, Parrot], dogFilter: {...}} -> OR over the
        named member types, each AND'd with its member filter when one
        is given. No memberTypes = all members."""
        members = _as_list(fobj.get("memberTypes") or ut.members)
        parts = []
        for mname in members:
            if mname not in ut.members:
                raise GraphQLError(
                    f"{mname} is not a member of union {ut.name}"
                )
            mt = self.types.get(mname)
            tf = FilterTree(func=FuncSpec(
                        name="type",
                        attr=mt.stored_name if mt else mname,
                    ))
            sub = fobj.get(mname[0].lower() + mname[1:] + "Filter")
            if sub and mt is not None:
                inner = self._filter_tree(mt, sub)
                if inner is not None:
                    tf = FilterTree(op="and", children=[tf, inner])
            parts.append(tf)
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        return FilterTree(op="or", children=parts)

    def _filter_tree(self, t: GqlType, fobj: dict) -> Optional[FilterTree]:
        """ref resolve/query_rewriter.go compileFilter: within one
        filter object the field comparisons and `and`/`not` clauses
        conjoin; an `or` clause disjoins with THAT conjunction —
        {f: X, or: {g: Y}} means (f=X) OR (g=Y), not AND."""
        parts: List[FilterTree] = []
        ors: List[FilterTree] = []
        for k, v in (fobj or {}).items():
            if k == "and":
                subs = [self._filter_tree(t, x) for x in _as_list(v)]
                parts.append(FilterTree(op="and", children=[s for s in subs if s]))
            elif k == "or":
                subs = [self._filter_tree(t, x) for x in _as_list(v)]
                ors.extend(s for s in subs if s)
            elif k == "not":
                sub = self._filter_tree(t, v)
                if sub:
                    parts.append(FilterTree(op="not", children=[sub]))
            elif k == "id":
                # ref query_rewriter.go convertIDs: unparseable or
                # out-of-range ids are silently dropped from the list
                uids = [
                    u for u in (_parse_uid(x) for x in _as_list(v))
                    if u is not None
                ]
                parts.append(
                    FilterTree(func=FuncSpec(name="uid", args=uids))
                )
            elif k == "has":
                for fname in _as_list(v):
                    f = t.fields.get(fname)
                    if f is None:
                        raise GraphQLError(f"no field {fname!r}")
                    parts.append(
                        FilterTree(
                            func=FuncSpec(name="has", attr=t.pred(fname))
                        )
                    )
            else:
                f = t.fields.get(k)
                if f is None:
                    raise GraphQLError(f"no field {k!r} on {t.name}")
                if f.type_name == "ID":
                    # an ID-named field (postID etc.) filters by uid,
                    # same as the generic "id" key
                    uids = [
                        u
                        for u in (_parse_uid(x) for x in _as_list(v))
                        if u is not None
                    ]
                    parts.append(
                        FilterTree(func=FuncSpec(name="uid", args=uids))
                    )
                    continue
                attr = t.pred(k)
                if not isinstance(v, dict):
                    v = {"eq": v}
                for opname, arg in v.items():
                    if arg is None:
                        # ref query_rewriter.go: {eq: null} matches
                        # nodes WITHOUT the predicate (NOT has); any
                        # other null-valued comparison is dropped
                        if opname == "eq":
                            parts.append(
                                FilterTree(
                                    op="not",
                                    children=[
                                        FilterTree(
                                            func=FuncSpec(
                                                name="has", attr=attr
                                            )
                                        )
                                    ],
                                )
                            )
                        continue
                    fn = _FILTER_OPS.get(opname)
                    if fn is None:
                        raise GraphQLError(f"bad filter op {opname!r}")
                    if opname == "in":
                        args = _as_list(arg)
                    elif opname == "between":
                        args = [arg.get("min"), arg.get("max")]
                    elif opname == "near":
                        c = arg.get("coordinate", {})
                        args = [
                            [c.get("longitude"), c.get("latitude")],
                            arg.get("distance"),
                        ]
                    elif opname in ("within", "intersects"):
                        if "multiPolygon" in arg:
                            args = [
                                [
                                    _gql_polygon_coords(p)
                                    for p in arg["multiPolygon"].get(
                                        "polygons", []
                                    )
                                ]
                            ]
                        else:
                            args = [
                                _gql_polygon_coords(arg.get("polygon", {}))
                            ]
                    elif opname == "contains":
                        if "point" in arg:
                            pt = arg["point"]
                            args = [
                                [pt.get("longitude"), pt.get("latitude")]
                            ]
                        else:
                            args = [
                                _gql_polygon_coords(arg.get("polygon", {}))
                            ]
                    elif opname == "regexp":
                        pat = str(arg)
                        if pat.startswith("/"):
                            end = pat.rindex("/")
                            args = [("regex", pat[1:end], pat[end + 1 :])]
                        else:
                            args = [("regex", pat, "")]
                    else:
                        args = [arg]
                    parts.append(
                        FilterTree(func=FuncSpec(name=fn, attr=attr, args=args))
                    )
        base: Optional[FilterTree]
        if not parts:
            base = None
        elif len(parts) == 1:
            base = parts[0]
        else:
            base = FilterTree(op="and", children=parts)
        for o in ors:
            base = (
                o
                if base is None
                else FilterTree(op="or", children=[base, o])
            )
        return base

    def _apply_cascade_dir(self, t: GqlType, sel: Selection, gq):
        """@cascade / @cascade(fields: [...]) on a field (ref
        query_rewriter.go addCascadeDirective)."""
        for dname, dargs in sel.directives:
            if dname != "cascade":
                continue
            gq.cascade = True
            for fn in _as_list(dargs.get("fields") or []):
                if fn == "id":
                    continue  # uid always present
                f = t.fields.get(fn)
                gq.cascade_fields.append(
                    t.pred(fn) if f is not None else fn
                )

    def _apply_order(self, t: GqlType, gq, order: dict):
        """order: {asc|desc: field, then: {...}} — nested `then` chains
        secondary sort keys (ref gqlschema.go order input synthesis)."""
        while order:
            if "asc" in order:
                gq.order.append(Order(attr=t.pred(order["asc"])))
            if "desc" in order:
                gq.order.append(Order(attr=t.pred(order["desc"]), desc=True))
            order = order.get("then") or {}

    def _query_list(self, t: GqlType, sel: Selection) -> List[dict]:
        fobj, allowed = self._with_auth_filter(t, sel.args.get("filter"))
        if not allowed:
            return []
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(name="type", attr=t.stored_name)
        gq.filter = self._filter_tree(t, fobj)
        if t.kind == "interface" and not getattr(
            self._tls, "in_auth_rule", False
        ):
            pre = self._match_filter_uids(t, fobj, "query")
            if pre is not None:
                # implementer auth applies BEFORE pagination (the
                # reference injects it into the query itself)
                gq.func = FuncSpec(name="uid", args=pre)
                gq.filter = None
        self._apply_cascade_dir(t, sel, gq)
        self._apply_order(t, gq, sel.args.get("order") or {})
        gq.first = sel.args.get("first")
        gq.offset = sel.args.get("offset")
        gq.children = self._selection_children(t, sel.selections)
        # rows materialize on uid even when every selected scalar is
        # absent (ref query_rewriter.go injects dgraph.uid at the root)
        if not any(c.alias == "__uid" for c in gq.children):
            gq.children.append(
                GraphQuery(attr="uid", is_uid=True, alias="__uid")
            )
        rows = self._run_block(gq)
        self._enrich_lambda_fields(t, sel.selections, rows)
        return self._add_typename(rows, t, sel.selections)

    def _entities(self, sel: Selection) -> List[dict]:
        """Apollo federation _entities(representations: [...]) (ref
        graphql/resolve entitiesQuery rewrite): group representations by
        __typename, fetch each batch by its @key field ordered asc."""
        reps = _as_list(sel.args.get("representations") or [])
        by_type: Dict[str, List[Any]] = {}
        for r in reps:
            tn = r.get("__typename")
            t = self.types.get(tn)
            if t is None or not t.key_field:
                raise GraphQLError(
                    f"unknown or keyless type in representation: {tn!r}"
                )
            by_type.setdefault(tn, []).append(r.get(t.key_field))
        # resolve each type batch (fetched orderasc by key, matching the
        # reference dgquery), then reorder to match the representations
        # argument positionally — Apollo merges results by index (ref
        # resolve/resolver.go:322 entitiesQueryCompletion). Duplicate keys
        # duplicate rows; but if ANY unique key resolved to no row the
        # reference returns the fetched rows as-is, unordered and
        # un-padded (resolver.go:394 — "This will end into an error at
        # the Gateway, so no need to order the result here").
        rows_by_key: Dict[tuple, dict] = {}
        fetched: List[dict] = []
        n_unique = 0
        for tn, keyvals in by_type.items():
            t = self.types[tn]
            n_unique += len(set(keyvals))
            gq = GraphQuery(attr="q")
            gq.func = FuncSpec(
                name="eq", attr=t.pred(t.key_field), args=keyvals
            )
            gq.order.append(Order(attr=t.pred(t.key_field)))
            gq.filter = FilterTree(
                func=FuncSpec(name="type", attr=t.stored_name)
            )
            frags = [
                s
                for s in sel.selections
                if s.name == "..." and s.frag_on in (tn, "")
            ]
            sels = [x for s in frags for x in s.selections]
            gq.children = self._selection_children(t, sels)
            gq.children.append(
                GraphQuery(attr=t.pred(t.key_field), alias="__key")
            )
            rows = self._run_block(gq)
            keys_ = [r.pop("__key", None) for r in rows]
            self._add_typename(rows, t, sels)
            fetched.extend(rows)
            for k, r in zip(keys_, rows):
                rows_by_key[(tn, k)] = r
        if len(fetched) < n_unique:
            return fetched
        out: List[Optional[dict]] = []
        for r in reps:
            tn = r.get("__typename")
            k = r.get(self.types[tn].key_field)
            out.append(rows_by_key.get((tn, k)))
        return out

    def _check_password(self, t: GqlType, sel: Selection) -> Optional[dict]:
        """checkTPassword(xid/id, <secretField>) -> T | null (ref
        query_rewriter.go passwordQuery: eq-root + checkPwd filter)."""
        sf = next(
            (f for f in t.fields.values() if f.is_secret), None
        )
        if sf is None:
            raise GraphQLError(f"{t.name} has no @secret field")
        pwd = sel.args.get(sf.name)
        gq = GraphQuery(attr="q")
        xf = t.xid_field()
        if xf is not None and xf.name in sel.args:
            gq.func = FuncSpec(
                name="eq", attr=t.pred(xf.name), args=[sel.args[xf.name]]
            )
        else:
            u = _parse_uid(sel.args.get("id"))
            if u is None:
                return None
            gq.func = FuncSpec(name="uid", args=[u])
        gq.filter = FilterTree(
            op="and",
            children=[
                FilterTree(func=FuncSpec(name="type", attr=t.stored_name)),
                FilterTree(
                    func=FuncSpec(
                        name="checkpwd",
                        attr=t.pred(sf.name),
                        args=[pwd],
                    )
                ),
            ],
        )
        gq.children = self._selection_children(t, sel.selections)
        res = self._run_block(gq)
        self._add_typename(res, t, sel.selections)
        return res[0] if res else None

    def _get(self, t: GqlType, sel: Selection) -> Optional[dict]:
        gq = GraphQuery(attr="q")
        idf = t.id_field()
        id_key = idf.name if idf is not None else "id"
        id_arg = sel.args.get(id_key, sel.args.get("id"))
        if id_arg is not None:
            u = _parse_uid(id_arg)
            if u is None:
                return None
            gq.func = FuncSpec(name="uid", args=[u])
            gq.filter = FilterTree(func=FuncSpec(name="type", attr=t.stored_name))
        else:
            xf = t.xid_field()
            if xf is None or xf.name not in sel.args:
                # ref rewrites an argless get to uid(0x0) — null result
                return None
            gq.func = FuncSpec(
                name="eq",
                attr=t.pred(xf.name),
                args=[sel.args[xf.name]],
            )
        auth = self._auth(t, "query")
        if auth is False:
            return None
        if isinstance(auth, dict):
            extra = self._filter_tree(t, auth)
            gq.filter = (
                extra
                if gq.filter is None
                else FilterTree(op="and", children=[gq.filter, extra])
            )
        self._apply_cascade_dir(t, sel, gq)
        gq.children = self._selection_children(t, sel.selections)
        if not any(c.alias == "__uid" for c in gq.children):
            gq.children.append(
                GraphQuery(attr="uid", is_uid=True, alias="__uid")
            )
        res = self._run_block(gq)
        if (
            res
            and t.kind == "interface"
            and not getattr(self._tls, "in_auth_rule", False)
        ):
            # getX through an interface honors implementer auth too
            u = int(res[0].get("__uid", "0x0"), 16)
            if not self._apply_interface_auth(t, [u], "query"):
                return None
        self._enrich_lambda_fields(t, sel.selections, res)
        self._add_typename(res, t, sel.selections)
        return res[0] if res else None

    def _aggregate(self, t: GqlType, sel: Selection) -> dict:
        """aggregateT(filter) { count fieldMin fieldMax fieldSum fieldAvg }
        (ref gqlschema.go aggregate type synthesis)."""
        fobj, allowed = self._with_auth_filter(t, sel.args.get("filter"))
        if not allowed:
            # denied aggregate resolves to null (ref `aggregateX()`)
            return None
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(name="type", attr=t.stored_name)
        gq.filter = self._filter_tree(t, fobj)
        if t.kind == "interface" and not getattr(
            self._tls, "in_auth_rule", False
        ):
            pre = self._match_filter_uids(t, fobj, "query")
            gq.func = FuncSpec(name="uid", args=pre)
            gq.filter = None
        count_keys = [s.key for s in sel.selections if s.name == "count"]
        count_key = count_keys[0] if count_keys else "count"
        gq.children = [GraphQuery(attr="uid", is_count=True, alias=count_key)]

        # map selections like ageMin/ageMax/ageSum/ageAvg to aggregators
        aggs = []  # (sel_key, field, op)
        for s in sel.selections:
            if s.name == "count":
                continue
            for suffix, op in (
                ("Min", "min"), ("Max", "max"), ("Sum", "sum"), ("Avg", "avg"),
            ):
                if s.name.endswith(suffix):
                    fname = s.name[: -len(suffix)]
                    f = t.fields.get(fname)
                    if f is not None and f.is_scalar:
                        aggs.append((s.key, fname, op))
                    break
        var_of = {}
        for i, (_, fname, _) in enumerate(aggs):
            if fname not in var_of:
                var_of[fname] = f"v{i}"
                gq.children.append(
                    GraphQuery(
                        attr=t.pred(fname), var_name=var_of[fname]
                    )
                )
        for key, fname, op in aggs:
            gq.children.append(
                GraphQuery(aggregator=op, val_var=var_of[fname], alias=key)
            )
        res = self._run_block(gq)
        out = {count_key: 0}
        for obj in res:
            out.update(obj)
        for k in count_keys[1:]:  # repeated count under other aliases
            out[k] = out.get(count_key, 0)
        wanted = {s.key for s in sel.selections}
        out = {k: v for k, v in out.items() if k in wanted}
        for s in sel.selections:
            if s.name == "__typename":
                # ref gqlschema.go names the result type TAggregateResult
                out[s.key] = f"{t.name}AggregateResult"
            else:  # absent aggregates -> null
                out.setdefault(s.key, None)
        return out

    def _similar(
        self, t: GqlType, sel: Selection, by_id: bool = False
    ) -> List[dict]:
        by = sel.args.get("by")
        topk = int(sel.args.get("topK", 10))
        import json as _json

        if by_id:
            # querySimilarTById: the query vector is the given node's
            # own embedding (ref query_rewriter.go rewriteVectorSearch
            # uid->vec var chain); results include the node itself
            u = _parse_uid(sel.args.get("id"))
            if u is None:
                return []
            probe = GraphQuery(attr="q")
            probe.func = FuncSpec(name="uid", args=[u])
            probe.children = [
                GraphQuery(attr=t.pred(by), alias="__v")
            ]
            got = self._run_block(probe)
            if not got or got[0].get("__v") is None:
                return []
            vec = got[0]["__v"]
        else:
            vec = sel.args.get("vector")
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(
            name="similar_to",
            attr=t.pred(by),
            args=[topk, _json.dumps(_as_list(vec))],
        )
        dist_sels = [
            s for s in sel.selections if s.name == "vector_distance"
        ]
        plain = [s for s in sel.selections if s.name != "vector_distance"]
        gq.children = self._selection_children(t, plain)
        if dist_sels:
            # fetch each hit's embedding hidden; distance computed here
            # (ref query_rewriter.go appends val(distance) the same way)
            gq.children.append(
                GraphQuery(attr=t.pred(by), alias="__simv")
            )
        rows = self._run_block(gq)
        dists = []
        if dist_sels:
            # the embedding's search metric picks the distance formula
            # (ref query_rewriter.go:669 distanceFormula)
            metric = "euclidean"
            bf = t.fields.get(by)
            for tok in bf.search if bf is not None else []:
                if tok in ("cosine", "dotproduct"):
                    metric = tok
            qv = np.asarray(_as_list(vec), np.float64)
            for r in rows:
                v = np.asarray(_as_list(r.pop("__simv", []) or []), np.float64)
                if v.size != qv.size or not v.size:
                    dists.append(None)
                elif metric == "cosine":
                    denom = float(
                        np.linalg.norm(v) * np.linalg.norm(qv)
                    )
                    dists.append(
                        1.0 - float(np.dot(v, qv)) / denom
                        if denom
                        else None
                    )
                elif metric == "dotproduct":
                    dists.append(1.0 - float(np.dot(v, qv)))
                else:
                    dists.append(float(np.sqrt(((v - qv) ** 2).sum())))
        self._enrich_lambda_fields(t, plain, rows)
        self._add_typename(rows, t, plain)
        for i, r in enumerate(rows):  # after shaping, it must survive
            for s in dist_sels:
                r[s.key] = dists[i]
        return rows

    # ------------------------------------------------------------------
    # Mutations (ref resolve/mutation_rewriter.go)
    # ------------------------------------------------------------------

    def _fire_webhook(self, t: GqlType, op: str, uids: List[int], sel: Selection):
        """@lambdaOnMutate fire-and-forget webhook (ref resolve/webhook.go
        sendWebhookEvent; payload shape webhookPayload/eventPayload)."""
        if not t.lambda_on_mutate.get(op) or not self.lambda_url:
            return
        event: Dict[str, Any] = {
            "__typename": t.name,
            "operation": op,
            "commitTs": 0,
        }
        root_uids = [f"0x{u:x}" for u in uids]
        if op == "add":
            event["add"] = {
                "rootUIDs": root_uids,
                "input": _as_list(sel.args.get("input", [])),
            }
        elif op == "update":
            inp = sel.args.get("input", {}) or {}
            event["update"] = {
                "rootUIDs": root_uids,
                "setPatch": inp.get("set"),
                "removePatch": inp.get("remove"),
            }
        else:
            event["delete"] = {"rootUIDs": root_uids}
        body = {"resolver": "$webhook", "event": event}

        import threading

        def post():
            try:
                self._lambda_post(body)
            except Exception:
                pass  # at-most-once, errors only logged by the reference too

        threading.Thread(target=post, daemon=True).start()

    def _resolve_mutation(self, sel: Selection):
        if getattr(self.engine, "draining", False):
            raise GraphQLError("the server is in draining mode")
        name = sel.name
        mt = self.types.get("Mutation")
        if mt is not None:
            f = mt.fields.get(name)
            if f is not None and f.custom is not None:
                return self._resolve_custom(f, sel)
            if f is not None and f.is_lambda:
                return self._resolve_lambda_root("Mutation", f, sel)
        if name.startswith("add"):
            return self._add(self._type_for(name, ["add"]), sel)
        if name.startswith("update"):
            return self._update(self._type_for(name, ["update"]), sel)
        if name.startswith("delete"):
            return self._delete(self._type_for(name, ["delete"]), sel)
        raise GraphQLError(f"unknown mutation {name!r}")

    def _payload(self, t: GqlType, sel: Selection, uids: List[int], num: int):
        out: Dict[str, Any] = {}
        for s in sel.selections:
            if s.name == "numUids":
                out[s.key] = num
            elif s.name == "msg":
                out[s.key] = "Deleted" if sel.name.startswith("delete") else "Ok"
            elif s.name.lower() == t.name.lower():
                gq = GraphQuery(attr="q")
                gq.func = FuncSpec(name="uid", args=uids)
                gq.children = self._selection_children(t, s.selections)
                rows = self._run_block(gq)
                self._enrich_lambda_fields(t, s.selections, rows)
                self._add_typename(rows, t, s.selections)
                out[s.key] = rows
        return out

    # -- mutation write path (ref graphql/resolve/mutation_rewriter.go) --

    def _edge_targets(self, txn, uid: int, attr: str) -> List[int]:
        from dgraph_tpu_torch.x import keys as _keys

        return [
            int(u)
            for u in txn.cache.uids(_keys.DataKey(attr, uid))
        ]

    def _by_stored(self) -> dict:
        """stored dgraph.type name -> GqlType (for @dgraph(type:) maps)."""
        m = getattr(self, "_stored_map", None)
        if m is None:
            m = self._stored_map = {
                t.stored_name: t for t in self.types.values()
            }
        return m

    def _node_types(self, txn, uid: int) -> set:
        from dgraph_tpu_torch.x import keys as _keys

        tkey = _keys.DataKey("dgraph.type", uid)
        return {str(p.val().value) for p in txn.cache.values(tkey)}

    def _node_is(self, txn, uid: int, t: GqlType) -> bool:
        tys = self._node_types(txn, uid)
        if t.stored_name in tys:
            return True
        return t.kind == "interface" and any(
            self.types[m].stored_name in tys
            for m in t.implementers
            if m in self.types
        )

    def _xid_lookup(self, txn, pred: str, value) -> List[int]:
        ex = Executor(txn.cache, self.engine.schema)
        found = ex._runner().run_root(
            FuncSpec(name="eq", attr=pred, args=[value])
        )
        return [int(u) for u in found]

    def _write_ref_edge(
        self, txn, t: GqlType, uid: int, f: GqlField, target: int, op=OP_SET
    ):
        """Write uid -[t.f]-> target keeping @hasInverse pairs coherent:
        the inverse edge is written too, and when either side is
        single-valued the stale partner edges are removed — exactly the
        delete set the reference rewriter emits (mutation_rewriter.go
        addInverseLink + the NOT-uid var cleanup blocks)."""
        attr = t.pred(f.name)
        st = self.engine.schema
        ct = self.types.get(f.type_name)
        g = (
            ct.fields.get(f.has_inverse)
            if (ct is not None and f.has_inverse)
            else None
        )
        if g is not None and op == OP_SET:
            inv_attr = ct.pred(g.name)
            if not f.is_list:
                for old in self._edge_targets(txn, uid, attr):
                    if old != target:
                        self._check_additional_delete_auth(txn, ct, old)
                        apply_edge(
                            txn, st,
                            DirectedEdge(old, inv_attr, value_id=uid, op=OP_DEL),
                        )
            if not g.is_list:
                for old_src in self._edge_targets(txn, target, inv_attr):
                    if old_src != uid:
                        self._check_additional_delete_auth(txn, t, old_src)
                        apply_edge(
                            txn, st,
                            DirectedEdge(
                                old_src, attr, value_id=target, op=OP_DEL
                            ),
                        )
            apply_edge(
                txn, st, DirectedEdge(target, inv_attr, value_id=uid, op=op)
            )
        elif g is not None and op == OP_DEL:
            apply_edge(
                txn, st,
                DirectedEdge(target, ct.pred(g.name), value_id=uid, op=OP_DEL),
            )
        apply_edge(txn, st, DirectedEdge(uid, attr, value_id=target, op=op))

    def _check_additional_delete_auth(self, txn, ct: GqlType, uid: int):
        """Re-pointing a reference strips the stale edge from a THIRD
        node — that node must pass its type's update rule (ref
        update_rewriter additional-deletes authorization:
        \"couldn't rewrite query for mutation ... because
        authorization failed\")."""
        if ct.auth is None or ct.auth.update is None:
            return
        from dgraph_tpu_torch.graphql.auth import evaluate

        # deep rules run on the txn snapshot, like every mutation auth
        # check (the edge being re-pointed may already be in this txn)
        auth = evaluate(
            ct.auth.update,
            self._claims(),
            rule_runner=lambda r, c: self._run_auth_rule(
                r, c, cache=txn.cache
            ),
        )
        if auth is True:
            return
        ok = (
            set()
            if auth is False
            else self._auth_allowed_uids(ct, auth, [uid], cache=txn.cache)
        )
        if uid not in ok:
            raise GraphQLError(
                "couldn't rewrite query for mutation because "
                "authorization failed"
            )

    def _set_field(
        self, txn, t: GqlType, uid: int, f: GqlField, value,
        op=OP_SET, ctx=None,
    ):
        attr = t.pred(f.name)
        if f.is_embedding:
            edge = DirectedEdge(
                uid, attr, value=Val(TypeID.VFLOAT, np.asarray(value, np.float32)),
                op=op,
            )
            apply_edge(txn, self.engine.schema, edge)
            return
        if not f.is_scalar:
            ct = self.types[f.type_name]
            for i, obj in enumerate(_as_list(value)):
                if ct.kind == "union":
                    # union ref input: {dogRef: {...}} names the member
                    # (ref gqlschema.go union ref input synthesis)
                    if len(obj) != 1:
                        where = (
                            f"index `{i}`" if isinstance(value, list) else ""
                        )
                        raise GraphQLError(
                            f"value for field `{f.name}` in type "
                            f"`{t.name}` {where} must have exactly one "
                            f"child, found {len(obj)} children"
                        )
                    refk, obj = next(iter(obj.items()))
                    if not refk.endswith("Ref") or len(refk) <= 3:
                        raise GraphQLError(
                            f"bad union ref {refk!r} for {ct.name}"
                        )
                    mname = refk[:-3]
                    mname = mname[0].upper() + mname[1:]
                    if mname not in ct.members:
                        raise GraphQLError(
                            f"bad union ref {refk!r} for {ct.name}"
                        )
                    mt = self.types[mname]
                    child_uid = self._resolve_object(
                        txn, mt, obj, ctx=ctx, for_delete=(op == OP_DEL)
                    )
                    if child_uid is None:
                        continue
                    apply_edge(
                        txn,
                        self.engine.schema,
                        DirectedEdge(uid, attr, value_id=child_uid, op=op),
                    )
                    continue
                if op == OP_DEL and not isinstance(obj, dict):
                    continue
                child_uid = self._resolve_object(
                    txn, ct, obj, ctx=ctx, for_delete=(op == OP_DEL),
                    src_field=f,
                )
                if child_uid is None:
                    continue
                self._write_ref_edge(txn, t, uid, f, child_uid, op=op)
            return
        # @dgraph(pred: "Person.name@hi") fields write the base predicate
        # with a language tag (ref gqlschema.go language tag fields)
        lang = ""
        if "@" in attr:
            attr, lang = attr.split("@", 1)
        vals = value if (f.is_list and isinstance(value, list)) else [value]
        for v in vals:
            if v is None:
                continue
            apply_edge(
                txn,
                self.engine.schema,
                DirectedEdge(
                    uid, attr, value=_to_val(v, f), lang=lang, op=op
                ),
            )

    def _resolve_object(
        self, txn, t: GqlType, obj: dict, ctx=None,
        is_root=False, for_delete=False, src_field=None,
    ) -> Optional[int]:
        """Resolve one input object to a uid with the reference's
        existence semantics (mutation_rewriter.go RewriteQueries +
        Rewrite): uid refs must exist with the right type; xid refs
        link when found (extra fields ignored), error on root add
        (unless upsert, which updates), create otherwise. src_field is
        the edge we descended through — its inverse field inside obj is
        ignored (the parent link wins, ref rewriter inverse handling)."""
        ctx = ctx if ctx is not None else _MutCtx()
        # a SINGLE-VALUED inverse of the field we came through is
        # auto-satisfied by the parent link; user values for it are
        # dropped (ref add/082 goldens — list inverses still process)
        inv_name = None
        if src_field is not None and src_field.has_inverse:
            invf = t.fields.get(src_field.has_inverse)
            if invf is not None and not invf.is_list:
                inv_name = src_field.has_inverse
        xf0 = t.xid_field()
        idf = t.id_field()
        idname = idf.name if idf is not None else None
        if (
            idname
            and obj.get(idname) is not None
            and (xf0 is None or xf0.name != idname)
        ):
            # uid reference (extras, if any, are ignored — the reference
            # rewrites {postID: "0x123", ...} to a bare uid link)
            u = _parse_uid(obj[idname])
            if u is None:
                raise GraphQLError(
                    f"ID argument ({obj[idname]}) was not able to be parsed"
                )
            if not self._node_is(txn, u, t):
                if for_delete:
                    return None
                raise GraphQLError(
                    f'ID "{obj[idname]}" isn\'t a {t.name}'
                )
            return u
        # xid identity
        xids = [
            (f, obj[f.name])
            for f in t.fields.values()
            if f.is_id and f.name in obj and obj[f.name] is not None
            and f.name != inv_name
        ]
        for f, v in xids:
            if v == "":
                raise GraphQLError(
                    f"encountered an empty value for @id field "
                    f"`{t.pred(f.name)}`"
                )
        # in-request claimed xids: a repeat either links to the new node
        # or errors (ref xidMetadata.isDuplicateXid)
        for f, v in xids:
            key = (t.pred(f.name), str(v))
            if key not in ctx.claimed:
                continue
            prev_uid, prev_obj = ctx.claimed[key]
            if is_root:
                raise GraphQLError(f"duplicate XID found: {v}")
            if src_field is not None and src_field.has_inverse:
                ct = self.types.get(src_field.type_name)
                g = ct.fields.get(src_field.has_inverse) if ct else None
                if g is not None and not g.is_list:
                    raise GraphQLError(f"duplicate XID found: {v}")
            stripped = {k: x for k, x in obj.items() if k != inv_name}
            if (
                len(stripped) > 1
                and len(prev_obj) > 1
                and stripped != prev_obj
            ):
                raise GraphQLError(f"duplicate XID found: {v}")
            return prev_uid
        found = None
        for f, v in xids:
            hits = self._xid_lookup(txn, t.pred(f.name), v)
            if not hits:
                continue
            same = [
                h
                for h in hits
                if t.stored_name in self._node_types(txn, h)
            ]
            if len(same) > 1:
                raise GraphQLError(
                    "multiple nodes found for given xid values, "
                    "updation not possible"
                )
            if not same:
                # the value lives only on other types' nodes (shared
                # interface predicate): a conflict iff @id(interface:true)
                if f.id_interface:
                    owner = f.owner or t.name
                    raise GraphQLError(
                        f"id {v} already exists for field {f.name} in "
                        f"some other implementing type of interface "
                        f"{owner}"
                    )
                continue
            hit = same[0]
            if found is not None and hit != found:
                raise GraphQLError(
                    "multiple nodes found for given xid values, "
                    "updation not possible"
                )
            found, found_f, found_v = hit, f, v
        if for_delete:
            if not xids:
                # a remove reference must carry its identity (ref
                # rewriter: "field name cannot be empty")
                if xf0 is not None:
                    raise GraphQLError(
                        f"field {xf0.name} cannot be empty"
                    )
                raise GraphQLError(
                    f"id is not provided to remove a {t.name} reference"
                )
            return found
        if found is not None:
            if is_root and not ctx.upsert:
                raise GraphQLError(
                    f"id {found_v} already exists for field "
                    f"{found_f.name} inside type {t.name}"
                )
            if is_root and ctx.upsert:
                ua = ctx.upsert_auth
                if ua is False:
                    return found  # denied upsert: silent no-op
                if isinstance(ua, dict):
                    ok = self._auth_allowed_uids(t, ua, [found], cache=txn.cache)
                    if found not in ok:
                        return found
                self._apply_update_defaults(txn, t, found, obj, ctx)
                # every field is (re)written, xids included — the
                # reference's upsert setjson carries them all
                for k, v in obj.items():
                    if k == idname or v is None:
                        continue
                    fld = t.fields.get(k)
                    if fld is None:
                        raise GraphQLError(f"no field {k!r} on {t.name}")
                    self._set_field(txn, t, found, fld, v, ctx=ctx)
                return found
            # nested reference: link only, extra fields ignored
            return found
        if not xids and not is_root and src_field is not None:
            has_data = any(
                k for k in obj if k != inv_name
            )
            if xf0 is not None and not has_data:
                # a reference-shaped object with no identity at all
                raise GraphQLError(
                    f"field {xf0.name} cannot be empty"
                )
        # brand-new node: required (non-null) scalar fields must be
        # present (or defaulted) on creation
        for f in t.fields.values():
            if (
                f.non_null
                and f.is_scalar
                and not f.is_list
                and f.type_name != "ID"
                and not f.is_secret
                and obj.get(f.name) is None  # absent OR explicit null
                and f.default_add is None
                and f.name != inv_name
            ):
                raise GraphQLError(
                    f"type {t.name} requires a value for field "
                    f"{f.name}, but no value present"
                )
        uid = self.engine.zero.assign_uids(1)
        ctx.created.append(uid)
        for f, v in xids:
            ctx.claimed[(t.pred(f.name), str(v))] = (
                uid,
                {k: x for k, x in obj.items() if k != inv_name},
            )
        # a node is a member of its type AND every interface it
        # implements (ref mutation_rewriter.go — dgraph.type gets both,
        # so queryCharacter(func: type(Character)) finds Humans)
        for tyname in [
            t.stored_name,
            *(
                self.types[i].stored_name
                for i in t.interfaces
                if i in self.types
            ),
        ]:
            apply_edge(
                txn,
                self.engine.schema,
                DirectedEdge(
                    uid, "dgraph.type", value=Val(TypeID.STRING, tyname)
                ),
            )
        for k, v in obj.items():
            if k == idname and (xf0 is None or xf0.name != idname):
                continue  # virtual uid, no predicate — but a stored
                # @id key named 'id' (extended federation types) writes
            if k == inv_name:
                continue  # parent link wins over explicit inverse value
            f = t.fields.get(k)
            if f is None:
                raise GraphQLError(f"no field {k!r} on {t.name}")
            if v is None:
                continue
            self._set_field(txn, t, uid, f, v, ctx=ctx)
        # @default(add:) fills fields the input omitted
        for f in t.fields.values():
            if f.default_add is not None and obj.get(f.name) is None:
                self._set_field(
                    txn, t, uid, f,
                    self._default_value(f.default_add, ctx), ctx=ctx,
                )
        return uid

    def _default_value(self, spec: str, ctx=None):
        if spec == "$now":
            # ONE timestamp per mutation request (the reference stamps
            # the request time, not per-field wall clocks)
            if ctx is not None and ctx.now is not None:
                return ctx.now
            import datetime as _dt

            now = config.get("FAKE_NOW") or (
                _dt.datetime.now(_dt.timezone.utc)
                .strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3]
                + "Z"
            )
            if ctx is not None:
                ctx.now = now
            return now
        return spec

    def _apply_update_defaults(self, txn, t: GqlType, uid: int, obj, ctx):
        """@default(update:) values auto-set on every update of a node
        (ref mutation_rewriter.go — update patches gain the defaults
        for fields the patch doesn't name)."""
        for f in t.fields.values():
            if f.default_update is not None and f.name not in obj:
                self._set_field(
                    txn, t, uid, f,
                    self._default_value(f.default_update, ctx), ctx=ctx,
                )

    def _add(self, t: GqlType, sel: Selection):
        inputs = _as_list(sel.args.get("input", []))
        txn = self.engine.new_txn()
        try:
            return self._add_in_txn(t, sel, inputs, txn)
        except Exception:
            if not txn.finished:
                txn.discard()  # release the start_ts (zero conflict GC)
            raise

    def _add_in_txn(self, t: GqlType, sel: Selection, inputs, txn):
        from dgraph_tpu_torch.graphql.auth import evaluate

        ctx = _MutCtx(upsert=bool(sel.args.get("upsert")))
        # upserts pre-check the ADD rule against the existing node
        # (ref: the rewriter's upsert query carries the auth filter —
        # a denied upsert is a silent no-op, auth_add_test "Upsert Add
        # Mutation with RBAC false")
        ctx.upsert_auth = self._auth(t, "add") if ctx.upsert else True
        created = ctx.created
        uids = [
            self._resolve_object(txn.txn, t, obj, ctx=ctx, is_root=True)
            for obj in inputs
        ]
        # post-insert check: every CREATED node must satisfy its own
        # type's add rule, evaluated on the txn snapshot (ref
        # mutation resolver authorizeNewNodes — deep creates validate
        # against their types' rules too)
        by_type: Dict[str, List[int]] = {}
        for u in created:
            for tn in self._node_types(txn.txn, u):
                ct = self.types.get(tn) or self._by_stored().get(tn)
                if ct is not None and ct.kind == "type":
                    by_type.setdefault(ct.name, []).append(u)
        for tn, us in by_type.items():
            ct = self.types[tn]
            if ct.auth is None or ct.auth.add is None:
                continue
            auth = evaluate(
                ct.auth.add,
                self._claims(),
                rule_runner=lambda r, c: self._run_auth_rule(
                    r, c, cache=txn.txn.cache
                ),
            )
            if auth is True:
                continue
            ok = (
                set()
                if auth is False
                else self._auth_allowed_uids(
                    ct, auth, us, cache=txn.txn.cache
                )
            )
            if not all(u in ok for u in us):
                txn.discard()
                raise GraphQLError(
                    "mutation failed because authorization failed"
                )
        txn.commit()
        self._fire_webhook(t, "add", uids, sel)
        return self._payload(t, sel, uids, len(created))

    def _match_filter_uids(
        self, t: GqlType, fobj, op: str = "query"
    ) -> List[int]:
        gq = GraphQuery(attr="q")
        gq.func = FuncSpec(name="type", attr=t.stored_name)
        gq.filter = self._filter_tree(t, fobj)
        gq.children = [GraphQuery(attr="uid", is_uid=True)]
        uids = [int(o["uid"], 16) for o in self._run_block(gq)]
        return self._apply_interface_auth(t, uids, op)

    def _apply_interface_auth(
        self, t: GqlType, uids: List[int], op: str
    ) -> List[int]:
        """Operating on an INTERFACE applies the implementing types'
        own auth rules with OR semantics (ref auth rewriting:
        `uid(A_chain) OR uid(B_chain)` — a node passing ANY of its
        implementers' chains stays). For mutations, nodes belonging to
        no implementing type drop out entirely when implementer auth is
        in play (`ARoot ... @filter(uid(B_2))`)."""
        if t.kind != "interface" or not uids:
            return uids
        auth_impls = [
            impl
            for n in t.implementers
            if (impl := self.types.get(n)) is not None
            and impl.auth is not None
            and getattr(impl.auth, op, None) is not None
        ]
        if not auth_impls:
            return uids
        plain_impls = [
            impl
            for n in t.implementers
            if (impl := self.types.get(n)) is not None
            and impl not in auth_impls
        ]

        def impl_members(impl) -> set:
            gq = GraphQuery(attr="q")
            gq.func = FuncSpec(name="uid", args=list(uids))
            gq.filter = FilterTree(
                func=FuncSpec(name="type", attr=impl.stored_name)
            )
            gq.children = [GraphQuery(attr="uid", is_uid=True)]
            return {int(o["uid"], 16) for o in self._run_block(gq)}

        member: set = set()
        allowed: set = set()
        for impl in auth_impls:
            impl_uids = impl_members(impl)
            member |= impl_uids
            verdict = self._auth(impl, op)
            if verdict is True:
                allowed |= impl_uids
            elif verdict is not False:
                allowed |= self._auth_allowed_uids(
                    impl, verdict, sorted(impl_uids)
                )
        for impl in plain_impls:
            # implementers without rules keep their nodes (OR branch
            # with no auth filter)
            allowed |= impl_members(impl)
        if op in ("update", "delete"):
            # mutation targets come only from the implementer chains
            drop = set(uids) - allowed
        else:
            # queries keep interface-only nodes (they match no chain
            # but also no deny)
            drop = member - allowed
        if not drop:
            return uids
        return [u for u in uids if u not in drop]

    def _update(self, t: GqlType, sel: Selection):
        inp = sel.args.get("input", {})
        fobj, allowed = self._with_auth_filter(t, inp.get("filter"), "update")
        # a denied update matches nothing: empty payload, NOT an error
        # (ref auth_update_test "top level RBAC false": `x as updateLog()`)
        denied = not allowed
        # patch-shape validation happens before matching (the reference
        # rewriter rejects malformed patches even when the filter is
        # empty — e.g. a remove reference without its identity)
        self._validate_remove_patch(t, inp.get("remove"))
        uids = (
            []
            if denied
            else self._match_filter_uids(t, fobj, "update")
        )
        txn = self.engine.new_txn()
        try:
            return self._update_in_txn(t, sel, inp, uids, txn)
        except Exception:
            if not txn.finished:
                txn.discard()
            raise

    def _update_in_txn(self, t: GqlType, sel, inp, uids, txn):
        ctx = _MutCtx()
        from dgraph_tpu_torch.posting.mutation import delete_entity_attr

        # the reference validates the patch at rewrite time, before it
        # knows what the filter matches — when nothing matches we still
        # run one discarded "probe" application so malformed patches
        # (duplicate xids, taken @id values) error identically
        probe = not uids
        for uid in uids or [0]:
            if inp.get("set") or inp.get("remove"):
                self._apply_update_defaults(
                    txn.txn, t, uid, inp.get("set") or {}, ctx
                )
            for k, v in (inp.get("set") or {}).items():
                f = t.fields.get(k)
                if f is None:
                    raise GraphQLError(f"no field {k!r}")
                if v is None:
                    continue
                if f.is_id and not isinstance(v, (dict, list)):
                    # writing an @id value that lives on ANOTHER node is
                    # rejected (ref update rewriter existence checks)
                    hits = self._xid_lookup(txn.txn, t.pred(k), v)
                    if any(h != uid for h in hits):
                        raise GraphQLError(
                            f"id {v} already exists for field {k} "
                            f"inside type {t.name}"
                        )
                self._set_field(txn.txn, t, uid, f, v, ctx=ctx)
            for k, v in (inp.get("remove") or {}).items():
                f = t.fields.get(k)
                if f is None:
                    raise GraphQLError(f"no field {k!r}")
                if v is None:
                    # remove {field: null}: drop the predicate outright
                    # (ref update rewriter — deletejson value null);
                    # language-tagged preds store under the base name
                    attr = t.pred(f.name).split("@", 1)[0]
                    for tgt in (
                        self._edge_targets(txn.txn, uid, attr)
                        if not f.is_scalar
                        else []
                    ):
                        self._write_ref_edge(
                            txn.txn, t, uid, f, tgt, op=OP_DEL
                        )
                    delete_entity_attr(
                        txn.txn, self.engine.schema, uid, attr
                    )
                    continue
                self._set_field(txn.txn, t, uid, f, v, op=OP_DEL, ctx=ctx)
        if probe:
            txn.discard()
            return self._payload(t, sel, [], 0)
        txn.commit()
        if uids:
            self._fire_webhook(t, "update", uids, sel)
        return self._payload(t, sel, uids, len(uids))

    def _validate_remove_patch(self, t: GqlType, patch):
        """A remove reference must carry id or @id identity (ref update
        rewriter: 'field name cannot be empty')."""
        for k, v in (patch or {}).items():
            f = t.fields.get(k)
            if f is None:
                raise GraphQLError(f"no field {k!r}")
            if f.is_scalar or v is None:
                continue
            ct = self.types.get(f.type_name)
            if ct is None or ct.kind == "union":
                continue
            idf = ct.id_field()
            for obj in _as_list(v):
                if not isinstance(obj, dict):
                    continue
                has_id = idf is not None and idf.name in obj
                has_xid = any(
                    g.is_id and obj.get(g.name) is not None
                    for g in ct.fields.values()
                )
                if not has_id and not has_xid:
                    xf0 = ct.xid_field()
                    if xf0 is not None:
                        raise GraphQLError(
                            f"field {xf0.name} cannot be empty"
                        )
                    raise GraphQLError(
                        f"id is not provided to remove a {ct.name} "
                        f"reference"
                    )

    def _delete(self, t: GqlType, sel: Selection):
        from dgraph_tpu_torch.posting.mutation import delete_entity_attr

        fobj, allowed = self._with_auth_filter(
            t, sel.args.get("filter"), "delete"
        )
        # denied delete matches nothing (`x as deleteLog()`): no error
        uids = (
            []
            if not allowed
            else self._match_filter_uids(t, fobj, "delete")
        )
        txn = self.engine.new_txn()
        try:
            return self._delete_in_txn(t, sel, uids, txn)
        except Exception:
            if not txn.finished:
                txn.discard()
            raise

    def _delete_in_txn(self, t: GqlType, sel, uids, txn):
        from dgraph_tpu_torch.posting.mutation import delete_entity_attr

        for uid in uids:
            for f in t.fields.values():
                if f.type_name == "ID":
                    continue
                attr = t.pred(f.name)
                if not f.is_scalar and f.has_inverse:
                    # unlink the other side of @hasInverse pairs (ref
                    # delete rewriter: `Post_2 as Author.posts` +
                    # deletejson {"uid":"uid(Post_2)","Post.author":…})
                    ct = self.types.get(f.type_name)
                    g = ct.fields.get(f.has_inverse) if ct else None
                    if g is not None:
                        for tgt in self._edge_targets(txn.txn, uid, attr):
                            apply_edge(
                                txn.txn,
                                self.engine.schema,
                                DirectedEdge(
                                    tgt, ct.pred(g.name),
                                    value_id=uid, op=OP_DEL,
                                ),
                            )
                delete_entity_attr(txn.txn, self.engine.schema, uid, attr)
            delete_entity_attr(txn.txn, self.engine.schema, uid, "dgraph.type")
        txn.commit()
        if uids:
            # no phantom events for denied/no-match deletes
            self._fire_webhook(t, "delete", uids, sel)
        return self._payload(t, sel, uids, len(uids))


def _compute_child_agg(
    sel: Selection, items: list, type_name: str = ""
) -> dict:
    """{count, <f>Min/Max/Sum/Avg} over a fetched child edge (the
    child-level aggregate fields of ref gqlschema.go)."""
    out = {}
    for a in sel.selections:
        if a.name == "count":
            out[a.key] = len(items)
            continue
        if a.name == "__typename":
            out[a.key] = f"{type_name}AggregateResult"
            continue
        for suffix, op in (
            ("Min", "min"),
            ("Max", "max"),
            ("Sum", "sum"),
            ("Avg", "avg"),
        ):
            if a.name.endswith(suffix):
                fname = a.name[: -len(suffix)]
                vals = [
                    it[fname]
                    for it in items
                    if isinstance(it, dict) and it.get(fname) is not None
                ]
                if not vals:
                    out[a.key] = None
                elif op == "min":
                    out[a.key] = min(vals)
                elif op == "max":
                    out[a.key] = max(vals)
                elif op == "sum":
                    out[a.key] = sum(vals)
                else:
                    out[a.key] = sum(vals) / len(vals)
                break
    return out


def _parse_uid(x):
    """uid within u64 range, else None (dropped). Base-0 semantics like
    the reference (query_rewriter.go convertIDs → strconv.ParseUint
    base 0): "17" is decimal, "0x11" is hex."""
    try:
        u = int(str(x), 0)
    except (ValueError, TypeError):
        return None
    # 0 is accepted like ParseUint (uid 0 simply matches no node)
    return u if 0 <= u < (1 << 64) else None


def _as_list(x):
    if x is None:
        return []
    return x if isinstance(x, list) else [x]


def _to_val(v, f: GqlField) -> Val:
    dtype = f.dql_type
    if dtype == "int":
        return Val(TypeID.INT, int(v))
    if dtype == "float":
        return Val(TypeID.FLOAT, float(v))
    if dtype == "bool":
        if isinstance(v, str):
            return Val(TypeID.BOOL, v.lower() == "true")
        return Val(TypeID.BOOL, bool(v))
    if dtype == "datetime":
        from dgraph_tpu_torch.types.types import parse_datetime

        return Val(TypeID.DATETIME, parse_datetime(str(v)))
    if dtype == "geo":
        if isinstance(v, dict):
            v = _gql_geo_to_geojson(v)
        return Val(TypeID.GEO, v)
    if dtype == "password":
        from dgraph_tpu_torch.types.types import convert

        return convert(Val(TypeID.STRING, str(v)), TypeID.PASSWORD)
    return Val(TypeID.STRING, str(v))


def _gql_literal(v) -> str:
    """Render a Python value as a GraphQL literal (NOT JSON: object keys
    are bare — a remote rejects {"name": ...}). Enum args can't be told
    apart from strings without the remote arg types, so enum-typed
    remote args must be passed as GraphQL variables by the schema
    author (documented limitation, like @custom DQL substitution)."""
    import json as _json

    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return _json.dumps(v)
    if isinstance(v, str):
        return _json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_gql_literal(x) for x in v) + "]"
    if isinstance(v, dict):
        return (
            "{"
            + ", ".join(
                f"{k}: {_gql_literal(x)}" for k, x in v.items()
            )
            + "}"
        )
    return _json.dumps(str(v))
