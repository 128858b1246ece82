"""Remote-schema introspection + validation for @custom graphql fields.

Mirrors dgraph/graphql/schema/remote.go: at schema-update time
every `@custom(http: {graphql: "..."})` field introspects the remote
endpoint (introspectRemoteSchema:40) and validates the operation
against what the remote actually serves (validateRemoteGraphql:227):
the query/mutation must exist, its return type must match the field's
(list-wrapped for batch mode), required remote arguments must be
supplied, and argument/return type names must resolve in the remote
schema. Invalid selections are rejected at schema-update time, not at
first request.
"""

from __future__ import annotations

import json
import re
import urllib.request
from typing import Dict, Optional

# the standard GraphQL introspection query, trimmed to what validation
# reads (remote.go introspectionQuery:86)
_TYPE_REF = "kind name ofType { kind name ofType { kind name ofType { kind name } } }"
INTROSPECTION_QUERY = f"""
query {{
  __schema {{
    queryType {{ name }}
    mutationType {{ name }}
    types {{
      kind
      name
      fields {{
        name
        args {{ name type {{ {_TYPE_REF} }} }}
        type {{ {_TYPE_REF} }}
      }}
      inputFields {{ name type {{ {_TYPE_REF} }} }}
    }}
  }}
}}
"""


class RemoteSchemaError(ValueError):
    pass


def introspect_remote(
    url: str, headers: Optional[Dict[str, str]] = None, timeout: float = 10.0
) -> dict:
    """POST the introspection query; returns the __schema dict
    (introspectRemoteSchema — POST urls must carry no query params)."""
    if "?" in url:
        raise RemoteSchemaError(
            f"POST method cannot have query parameters in url: {url}"
        )
    body = json.dumps({"query": INTROSPECTION_QUERY}).encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            payload = json.loads(r.read())
    except Exception as e:
        raise RemoteSchemaError(
            f"unable to introspect remote schema at {url}: {e}"
        ) from e
    schema = (payload.get("data") or {}).get("__schema")
    if not schema:
        raise RemoteSchemaError(
            f"remote introspection at {url} returned no __schema"
        )
    return schema


def _type_str(t: Optional[dict]) -> str:
    """Render an introspected type ref as a GraphQL type string."""
    if not t:
        return ""
    kind = t.get("kind")
    if kind == "NON_NULL":
        return _type_str(t.get("ofType")) + "!"
    if kind == "LIST":
        return "[" + _type_str(t.get("ofType")) + "]"
    return t.get("name") or ""


def _named_type(t: Optional[dict]) -> str:
    while t and not t.get("name"):
        t = t.get("ofType")
    return (t or {}).get("name") or ""


_OP_RE = re.compile(r"\b(query|mutation)\b[^{]*\{\s*(\w+)\s*(\(([^)]*)\))?")


def validate_remote_graphql(
    remote_schema: dict,
    graphql_text: str,
    field_type: str,
    is_batch: bool = False,
) -> None:
    """validateRemoteGraphql:227 — the given operation must exist on the
    remote with a matching return type, all required remote args
    supplied, and referenced type names present in the remote schema."""
    m = _OP_RE.search(graphql_text)
    if not m:
        raise RemoteSchemaError(
            f"could not parse @custom graphql operation: {graphql_text!r}"
        )
    op_kind, op_name, _, arg_src = m.group(1), m.group(2), m.group(3), m.group(4)

    root = (remote_schema.get(f"{op_kind}Type") or {}).get("name")
    if not root:
        raise RemoteSchemaError(
            f"remote schema doesn't have any {op_kind}s."
        )
    types = {t["name"]: t for t in remote_schema.get("types") or []}
    root_t = types.get(root)
    if root_t is None:
        raise RemoteSchemaError(f"remote schema has no type {root}")

    remote_field = next(
        (f for f in root_t.get("fields") or [] if f["name"] == op_name),
        None,
    )
    if remote_field is None:
        raise RemoteSchemaError(
            f"{op_kind} `{op_name}` is not present in remote schema."
        )

    expected = f"[{field_type}]" if is_batch else field_type
    got = _type_str(remote_field.get("type"))
    if _strip_nn(got) != _strip_nn(expected):
        raise RemoteSchemaError(
            f"found return type mismatch for {op_kind} `{op_name}`, "
            f"expected `{expected}`, got `{got}`."
        )

    # every referenced named type must exist remotely
    ret_name = _named_type(remote_field.get("type"))
    if ret_name and ret_name not in types:
        raise RemoteSchemaError(
            f"remote schema doesn't have any type named {ret_name}."
        )

    given_args = set()
    for part in (arg_src or "").split(","):
        part = part.strip()
        if part and ":" in part:
            given_args.add(part.split(":", 1)[0].strip())
    for arg in remote_field.get("args") or []:
        required = (arg.get("type") or {}).get("kind") == "NON_NULL"
        if required and arg["name"] not in given_args:
            raise RemoteSchemaError(
                f"argument `{arg['name']}` in {op_kind} `{op_name}` is "
                f"missing, it is required by remote {op_kind}."
            )
        aname = _named_type(arg.get("type"))
        if aname and aname not in types:
            raise RemoteSchemaError(
                f"remote schema doesn't have any type named {aname}."
            )


def _strip_nn(s: str) -> str:
    return s.replace("!", "")
