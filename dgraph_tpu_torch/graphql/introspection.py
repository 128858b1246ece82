"""GraphQL introspection (__schema / __type / __typename).

Mirrors the reference's introspection support (graphql/schema/
introspection.go serving the standard meta-schema over the generated
API): tools like GraphiQL and code generators issue __schema queries to
discover the synthesized Query/Mutation fields and object types. The
subset implemented covers the standard introspection query's shape:
kinds, fields, args, ofType chains, enum values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from dgraph_tpu_torch.graphql.sdl import _SCALARS, GqlField, GqlType

_SCALAR_NAMES = ["String", "Int", "Float", "Boolean", "ID", "DateTime", "Int64"]


def _named(name: str, kind: str) -> dict:
    return {"kind": kind, "name": name, "ofType": None}


def _non_null(inner: dict) -> dict:
    return {"kind": "NON_NULL", "name": None, "ofType": inner}


def _list_of(inner: dict) -> dict:
    return {"kind": "LIST", "name": None, "ofType": inner}


def _field_type(f: GqlField) -> dict:
    base_kind = "SCALAR" if f.type_name in _SCALARS else "OBJECT"
    t = _named(f.type_name, base_kind)
    if f.is_list:
        t = _list_of(_non_null(t) if f.non_null else t)
    elif f.non_null:
        t = _non_null(t)
    return t


def build_registry(types: Dict[str, GqlType]) -> Dict[str, dict]:
    """name -> full __Type description."""
    reg: Dict[str, dict] = {}
    for n in _SCALAR_NAMES:
        reg[n] = {
            "kind": "SCALAR",
            "name": n,
            "description": None,
            "fields": None,
            "enumValues": None,
            "inputFields": None,
            "interfaces": None,
            "possibleTypes": None,
        }
    for t in types.values():
        reg[t.name] = {
            "kind": "OBJECT",
            "name": t.name,
            "description": None,
            "fields": [
                {
                    "name": f.name,
                    "description": None,
                    "args": [],
                    "type": _field_type(f),
                    "isDeprecated": False,
                    "deprecationReason": None,
                }
                for f in t.fields.values()
            ],
            "enumValues": None,
            "inputFields": None,
            "interfaces": [],
            "possibleTypes": None,
        }
    # synthesized root types
    qfields = []
    mfields = []
    for t in types.values():
        obj = _named(t.name, "OBJECT")
        qfields.append({"name": f"get{t.name}", "args": [], "type": obj,
                        "description": None, "isDeprecated": False,
                        "deprecationReason": None})
        qfields.append({"name": f"query{t.name}", "args": [],
                        "type": _list_of(obj), "description": None,
                        "isDeprecated": False, "deprecationReason": None})
        qfields.append({"name": f"aggregate{t.name}", "args": [],
                        "type": _named(f"{t.name}AggregateResult", "OBJECT"),
                        "description": None, "isDeprecated": False,
                        "deprecationReason": None})
        mfields.append({"name": f"add{t.name}", "args": [],
                        "type": _named(f"Add{t.name}Payload", "OBJECT"),
                        "description": None, "isDeprecated": False,
                        "deprecationReason": None})
        mfields.append({"name": f"update{t.name}", "args": [],
                        "type": _named(f"Update{t.name}Payload", "OBJECT"),
                        "description": None, "isDeprecated": False,
                        "deprecationReason": None})
        mfields.append({"name": f"delete{t.name}", "args": [],
                        "type": _named(f"Delete{t.name}Payload", "OBJECT"),
                        "description": None, "isDeprecated": False,
                        "deprecationReason": None})
    reg["Query"] = {
        "kind": "OBJECT", "name": "Query", "description": None,
        "fields": qfields, "enumValues": None, "inputFields": None,
        "interfaces": [], "possibleTypes": None,
    }
    reg["Mutation"] = {
        "kind": "OBJECT", "name": "Mutation", "description": None,
        "fields": mfields, "enumValues": None, "inputFields": None,
        "interfaces": [], "possibleTypes": None,
    }
    return reg


def _project(value: Any, selections) -> Any:
    """Apply a GraphQL selection set to a plain dict-tree description."""
    if value is None or not selections:
        return value
    if isinstance(value, list):
        return [_project(v, selections) for v in value]
    out = {}
    for s in selections:
        if s.name == "__typename":
            out[s.key] = "__Type"
            continue
        v = value.get(s.name) if isinstance(value, dict) else None
        out[s.key] = _project(v, s.selections) if s.selections else v
    return out


def resolve_introspection(types: Dict[str, GqlType], sel) -> Any:
    reg = build_registry(types)
    if sel.name == "__type":
        t = reg.get(sel.args.get("name", ""))
        return _project(t, sel.selections) if t else None
    # __schema
    schema = {
        "queryType": {"name": "Query"},
        "mutationType": {"name": "Mutation"},
        "subscriptionType": None,
        "types": list(reg.values()),
        "directives": [],
    }
    return _project(schema, sel.selections)
