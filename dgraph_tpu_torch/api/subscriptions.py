"""Query subscriptions: re-run a query when its predicates change.

Mirrors dgraph/graphql/subscription/ + worker/worker.go:75
Subscribe (badger-prefix subscription -> poller re-running the query):
a subscription registers the predicates its query touches; every commit
that writes one of them re-evaluates the query, and the callback fires
when the result actually changed.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

from dgraph_tpu_torch.x import keys


class Subscriptions:
    def __init__(self, server):
        self.server = server
        self._subs: Dict[int, dict] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        server._subscriptions = self

    def subscribe(
        self,
        query: str,
        callback: Callable[[dict], None],
        access_jwt: Optional[str] = None,
    ) -> int:
        """Register; fires callback immediately with the current result and
        then on every change. With ACL enabled the subscriber's token is
        captured and used for every re-evaluation. Returns a sub id."""
        from dgraph_tpu_torch import dql
        from dgraph_tpu_torch.api.server import _query_preds

        blocks = dql.parse(query)
        preds = set(_query_preds(blocks))
        result = self.server.query(query, access_jwt=access_jwt)
        with self._lock:
            self._next_id += 1
            sid = self._next_id
            self._subs[sid] = {
                "query": query,
                "preds": preds,
                "callback": callback,
                "jwt": access_jwt,
                "last": json.dumps(result, sort_keys=True, default=str),
            }
        callback(result)
        return sid

    def subscribe_graphql(
        self,
        query: str,
        callback: Callable[[dict], None],
        variables: Optional[dict] = None,
    ) -> int:
        """GraphQL subscription: `subscription { queryT ... }` runs through
        the engine's GraphQL layer and re-fires on commits touching the
        selected types' predicates (ref graphql/subscription/poller.go,
        commit-driven instead of timed polling)."""
        import re as _re

        gql = getattr(self.server, "graphql", None)
        if gql is None:
            raise ValueError("no GraphQL schema configured")
        # a subscription op is evaluated like a query op
        body = _re.sub(r"^\s*subscription\b", "query", query, count=1)

        # predicates: every field predicate of every type the selection
        # tree touches (nested object selections included — a commit on a
        # child type must re-fire too)
        from dgraph_tpu_torch.graphql.parser import parse_operation

        preds = set()

        def walk(t, sels):
            # owner-qualified: inherited fields live under the
            # interface's predicate (Character.name, not Human.name)
            preds.update(t.pred(f) for f in t.fields)
            preds.add("dgraph.type")
            for s in sels:
                if s.name == "...":
                    ft = (
                        t if not s.frag_on else gql.types.get(s.frag_on)
                    )
                    if ft is not None:
                        walk(ft, s.selections)
                    continue
                f = t.fields.get(s.name)
                if f is not None and not f.is_scalar:
                    ct = gql.types.get(f.type_name)
                    if ct is not None:
                        walk(ct, s.selections)

        op = parse_operation(body, variables)
        for sel in op.selections:
            m = _re.match(r"(?:get|query|aggregate)(\w+)", sel.name)
            t = gql.types.get(m.group(1)) if m else None
            if t is not None:
                walk(t, sel.selections)

        def evaluate():
            return gql.execute(body, variables)

        result = evaluate()
        with self._lock:
            self._next_id += 1
            sid = self._next_id
            self._subs[sid] = {
                "preds": preds,
                "callback": callback,
                "jwt": None,
                "evaluate": evaluate,
                "last": json.dumps(result, sort_keys=True, default=str),
            }
        callback(result)
        return sid

    def unsubscribe(self, sid: int):
        with self._lock:
            self._subs.pop(sid, None)

    def on_commit(self, deltas):
        """Called by the engine post-commit with the touched keys."""
        touched = set()
        for key in deltas:
            try:
                touched.add(keys.parse_key(key).attr)
            except Exception:
                continue
        with self._lock:
            subs = list(self._subs.items())
        for sid, sub in subs:
            if not (sub["preds"] & touched):
                continue
            # never let a subscriber error fail the commit that triggered it
            try:
                ev = sub.get("evaluate")
                result = (
                    ev()
                    if ev is not None
                    else self.server.query(sub["query"], access_jwt=sub["jwt"])
                )
                blob = json.dumps(result, sort_keys=True, default=str)
                if blob != sub["last"]:
                    sub["last"] = blob
                    sub["callback"](result)
            except Exception:
                import logging

                logging.getLogger("dgraph_tpu_torch.subs").exception(
                    "subscription %d re-evaluation failed", sid
                )
