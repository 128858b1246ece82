"""Python client for a dgraph-tpu alpha: the dgo/pydgraph equivalent.

Mirrors the client surface of github.com/dgraph-io/pydgraph over the HTTP
API: login (JWT pair with automatic refresh-and-retry), alter, transactions
(query / mutate / commit / discard), and GraphQL execution. Stdlib-only.

    client = DgraphClient("http://localhost:8080")
    client.login("groot", "password")
    client.alter(schema='name: string @index(exact) .')
    txn = client.txn()
    txn.mutate(set_rdf='_:a <name> "Alice" .')
    txn.commit()
    print(client.query('{ q(func: eq(name, "Alice")) { name } }'))
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional


class DgraphClientError(Exception):
    def __init__(self, message: str, status: int = 0, body: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.body = body or {}


class RetriableError(DgraphClientError):
    """Aborted transaction — retry it (ref y.ErrAborted handling in dgo)."""


class DgraphClient:
    def __init__(self, url: str, timeout: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._access: Optional[str] = None
        self._refresh: Optional[str] = None
        self._creds: Optional[tuple] = None

    # -- transport -----------------------------------------------------------

    def _do(
        self,
        path: str,
        body: Any = None,
        ctype: str = "application/rdf",
        method: str = "POST",
        _retried: bool = False,
    ) -> dict:
        data = None
        if body is not None:
            data = body if isinstance(body, bytes) else str(body).encode()
        headers = {"Content-Type": ctype}
        if self._access:
            headers["X-Dgraph-AccessToken"] = self._access
        req = urllib.request.Request(
            self.url + path, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = {}
            msg = (payload.get("errors") or [{}])[0].get("message", str(e))
            if e.code == 401 and self._refresh and not _retried:
                # expired access token: refresh once and retry (dgo behavior)
                self._do_refresh()
                return self._do(path, body, ctype, method, _retried=True)
            if e.code == 409:
                raise RetriableError(msg, e.code, payload) from None
            raise DgraphClientError(msg, e.code, payload) from None
        except urllib.error.URLError as e:
            raise DgraphClientError(f"connection failed: {e.reason}") from None

    # -- auth ------------------------------------------------------------------

    def login(self, userid: str, password: str, namespace: int = 0) -> None:
        out = self._do(
            "/login",
            json.dumps(
                {"userid": userid, "password": password, "namespace": namespace}
            ),
            ctype="application/json",
        )
        self._access = out["data"]["accessJwt"]
        self._refresh = out["data"]["refreshJwt"]
        self._creds = (userid, password, namespace)

    def _do_refresh(self):
        try:
            out = self._do(
                "/login",
                json.dumps({"refreshToken": self._refresh}),
                ctype="application/json",
                _retried=True,
            )
            self._access = out["data"]["accessJwt"]
        except DgraphClientError:
            if self._creds is None:
                raise
            # refresh token expired too: fall back to a fresh login with
            # the stored credentials (dgo behavior)
            self.login(*self._creds)

    # -- admin -----------------------------------------------------------------

    def alter(
        self,
        schema: str = "",
        drop_attr: str = "",
        drop_all: bool = False,
    ) -> dict:
        if drop_all:
            body = json.dumps({"drop_all": True})
        elif drop_attr:
            body = json.dumps({"drop_attr": drop_attr})
        else:
            body = schema
        return self._do("/alter", body)

    def health(self) -> list:
        return self._do("/health", method="GET")

    def state(self) -> dict:
        return self._do("/state", method="GET")

    # -- queries ----------------------------------------------------------------

    def query(self, q: str, variables: Optional[Dict[str, str]] = None) -> dict:
        if variables:
            return self._do(
                "/query",
                json.dumps({"query": q, "variables": variables}),
                ctype="application/json",
            )
        return self._do("/query", q)

    def graphql(
        self, query: str, variables: Optional[Dict[str, Any]] = None
    ) -> dict:
        return self._do(
            "/graphql",
            json.dumps({"query": query, "variables": variables or {}}),
            ctype="application/json",
        )

    def set_graphql_schema(self, sdl: str) -> dict:
        return self._do("/admin/schema/graphql", sdl, ctype="text/plain")

    # -- transactions ------------------------------------------------------------

    def txn(self) -> "ClientTxn":
        return ClientTxn(self)


class ClientTxn:
    """Client-side transaction handle (pydgraph Txn equivalent)."""

    def __init__(self, client: DgraphClient):
        self.client = client
        self.start_ts: Optional[int] = None
        self.finished = False

    def query(self, q: str) -> dict:
        """Query. Note: the HTTP API evaluates reads at a fresh ts — a
        txn's own uncommitted writes are NOT visible over HTTP (use the
        embedded TxnHandle for read-your-writes); provided for pydgraph
        API compatibility."""
        return self.client.query(q)

    def mutate(
        self,
        set_rdf: str = "",
        del_rdf: str = "",
        set_obj=None,
        del_obj=None,
        commit_now: bool = False,
    ) -> dict:
        if self.finished:
            raise DgraphClientError("transaction already finished")
        qs = f"?commitNow={'true' if commit_now else 'false'}"
        if self.start_ts is not None:
            qs += f"&startTs={self.start_ts}"
        if set_obj is not None or del_obj is not None:
            body = json.dumps({"set": set_obj, "delete": del_obj})
            out = self.client._do("/mutate" + qs, body, "application/json")
        else:
            parts = []
            if set_rdf:
                parts.append("set { %s }" % set_rdf)
            if del_rdf:
                parts.append("delete { %s }" % del_rdf)
            out = self.client._do("/mutate" + qs, "{ %s }" % " ".join(parts))
        if commit_now:
            self.finished = True
        elif self.start_ts is None:
            self.start_ts = out["data"]["startTs"]
        return out["data"]

    def commit(self) -> dict:
        if self.finished:
            raise DgraphClientError("transaction already finished")
        if self.start_ts is None:
            self.finished = True
            return {"code": "Success", "message": "nothing to commit"}
        try:
            out = self.client._do(f"/commit?startTs={self.start_ts}", "")
        finally:
            # win or lose, the server has consumed this txn: a follow-up
            # discard() must be a no-op (dgo retry-pattern compatibility)
            self.finished = True
        return out["data"]

    def discard(self) -> None:
        if self.finished or self.start_ts is None:
            self.finished = True
            return
        self.client._do(f"/commit?startTs={self.start_ts}&abort=true", "")
        self.finished = True
