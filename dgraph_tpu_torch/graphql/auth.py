"""GraphQL @auth: JWT-gated, rule-filtered access to the generated API.

Mirrors dgraph/graphql/schema/auth.go (directive parsing, the
`# Dgraph.Authorization` header config) + graphql/resolve/auth queries
(query_rewriter.go injecting auth filters): each type may carry

  @auth(
    query:  { rule: "{$ROLE: {eq: \"ADMIN\"}}" },          # RBAC rule
    add:    { rule: "query($U: String!) { queryT(filter: {owner: {eq: $U}}) { __typename } }" },
    update: { and: [ {rule: ...}, {rule: ...} ] },
    delete: { not: {rule: ...} },
  )

Rules come in two forms, like the reference:
  - RBAC: a JSON-ish object testing JWT claims directly — resolves to a
    hard True/False before touching the graph;
  - graph rules: a GraphQL query whose filter (with $VAR substituted from
    JWT claims) is ANDed into the operation's filter, so only nodes the
    rule reaches are visible/mutable.

The JWT config comes from the SDL's magic comment:
  # Dgraph.Authorization {"VerificationKey":"secret","Header":"X-App-Auth",
  #                       "Namespace":"https://app/claims","Algo":"HS256"}
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dgraph_tpu_torch.acl import jwt as jwtlib


class AuthError(Exception):
    pass


# ---------------------------------------------------------------------------
# Dgraph.Authorization config
# ---------------------------------------------------------------------------


@dataclass
class AuthConfig:
    verification_key: str
    header: str = "X-Dgraph-AuthToken"
    namespace: str = ""
    algo: str = "HS256"
    closed_by_default: bool = False  # every request needs a JWT


_AUTH_LINE = re.compile(r"#\s*Dgraph\.Authorization\s+(\{.*\})")


def parse_authorization(sdl: str) -> Optional[AuthConfig]:
    m = _AUTH_LINE.search(sdl)
    if not m:
        return None
    try:
        obj = json.loads(m.group(1))
    except json.JSONDecodeError as e:
        raise AuthError(f"bad Dgraph.Authorization JSON: {e}") from e
    if obj.get("Algo", "HS256") != "HS256":
        raise AuthError("only HS256 is supported")
    return AuthConfig(
        verification_key=obj["VerificationKey"],
        header=obj.get("Header", "X-Dgraph-AuthToken"),
        namespace=obj.get("Namespace", ""),
        algo=obj.get("Algo", "HS256"),
        closed_by_default=bool(obj.get("ClosedByDefault", False)),
    )


def claims_from_jwt(token: str, cfg: AuthConfig) -> Dict[str, Any]:
    """Verify + extract custom claims (namespace-nested per the spec).
    exp is honored when present; auth tokens without exp don't expire."""
    import time as _time

    claims = jwtlib.decode(token, cfg.verification_key.encode(), verify_exp=False)
    if "exp" in claims and claims["exp"] < _time.time():
        raise AuthError("token expired")
    if cfg.namespace and isinstance(claims.get(cfg.namespace), dict):
        merged = dict(claims)
        merged.update(claims[cfg.namespace])
        return merged
    return claims


# ---------------------------------------------------------------------------
# @auth rule trees
# ---------------------------------------------------------------------------


@dataclass
class AuthNode:
    kind: str  # rbac | filter | and | or | not
    # rbac
    claim: str = ""
    op: str = ""  # eq | in
    value: Any = None
    # filter: template filter object with "$VAR" placeholders
    filt: Optional[dict] = None
    children: List["AuthNode"] = field(default_factory=list)


@dataclass
class TypeAuth:
    query: Optional[AuthNode] = None
    add: Optional[AuthNode] = None
    update: Optional[AuthNode] = None
    delete: Optional[AuthNode] = None


_TRIPLE = re.compile(r'"""([\s\S]*?)"""')


def _untriple(s: str) -> str:
    return _TRIPLE.sub(lambda m: json.dumps(m.group(1)), s)


def _strip_comments(s: str) -> str:
    """Drop `# …` line comments outside string literals."""
    out = []
    in_str = False
    i = 0
    while i < len(s):
        ch = s[i]
        if in_str:
            if ch == '"':
                # closing quote unless preceded by an ODD number of
                # backslashes ("...\\" ends the string)
                bs = 0
                j = i - 1
                while j >= 0 and s[j] == "\\":
                    bs += 1
                    j -= 1
                if bs % 2 == 0:
                    in_str = False
            out.append(ch)
        elif ch == '"':
            in_str = True
            out.append(ch)
        elif ch == "#":
            while i < len(s) and s[i] != "\n":
                i += 1
            continue
        else:
            out.append(ch)
        i += 1
    return "".join(out)


def parse_auth_blob(blob: str) -> TypeAuth:
    """blob: the argument text inside @auth( ... )."""
    obj = _parse_gql_object("{" + _strip_comments(_untriple(blob)) + "}")
    ta = TypeAuth()
    for op in ("query", "add", "update", "delete"):
        if op in obj:
            setattr(ta, op, _rule_node(obj[op]))
    return ta


def _rule_node(obj: dict) -> AuthNode:
    if "and" in obj:
        return AuthNode(
            kind="and", children=[_rule_node(x) for x in obj["and"]]
        )
    if "or" in obj:
        return AuthNode(kind="or", children=[_rule_node(x) for x in obj["or"]])
    if "not" in obj:
        return AuthNode(kind="not", children=[_rule_node(obj["not"])])
    rule = obj.get("rule")
    if rule is None:
        raise AuthError(f"auth rule object needs rule/and/or/not: {obj!r}")
    rule = rule.strip()
    if rule.startswith("{"):
        rb = _parse_gql_object(rule)
        if len(rb) != 1:
            raise AuthError(f"RBAC rule must test one claim: {rule!r}")
        claim, cond = next(iter(rb.items()))
        if not claim.startswith("$"):
            raise AuthError(f"RBAC rule claim must be a $var: {rule!r}")
        if not isinstance(cond, dict) or len(cond) != 1:
            raise AuthError(f"RBAC rule needs one op: {rule!r}")
        op, val = next(iter(cond.items()))
        if op not in ("eq", "in", "regexp"):
            raise AuthError(f"RBAC op must be eq/in/regexp: {rule!r}")
        return AuthNode(kind="rbac", claim=claim[1:], op=op, value=val)
    # graph rule: query (...) { queryT(filter: {...}) { ... } }.
    # A root-only filter with a trivial body lifts straight into the
    # operation filter; anything deeper (nested filters / cascade-
    # significant selections) is kept as an executable rule query the
    # resolver runs with @cascade semantics (ref auth_query_rewriting's
    # uid-var + @cascade chains).
    if _is_root_only_rule(rule):
        m = re.search(r"filter\s*:", rule)
        if not m:
            return AuthNode(kind="filter", filt={})
        filt_src = _balanced_object(rule, rule.index("{", m.end()))
        return AuthNode(kind="filter", filt=_parse_gql_object(filt_src))
    return AuthNode(kind="gqlrule", value=rule)


def _is_root_only_rule(rule: str) -> bool:
    """True when the rule query's only structure is a root filter with a
    trivial (__typename/uid-only) body — the common fast path."""
    try:
        from dgraph_tpu_torch.graphql.parser import parse_operation

        # probe-parse with every $var bound to a placeholder
        names = set(re.findall(r"\$(\w+)", rule))
        op = parse_operation(rule, variables={n: "0" for n in names})
    except Exception:
        return False
    if len(op.selections) != 1:
        return False
    root = op.selections[0]
    for s in root.selections:
        if s.selections or s.args or s.name not in ("__typename", "id", "uid"):
            return False
    return True


def evaluate(node: Optional[AuthNode], claims: Dict[str, Any], rule_runner=None):
    """Returns True (allow all), False (deny all), or a filter object to
    AND into the operation (the reference's auth-query injection).
    rule_runner(rule_text, claims) executes a deep rule query and
    returns the allowed uids (hex strings)."""
    if node is None:
        return True
    if node.kind == "rbac":
        got = claims.get(node.claim)
        if node.op == "eq":
            return got == node.value
        if node.op == "regexp":
            pat = str(node.value).strip("/")
            return bool(got is not None and re.search(pat, str(got)))
        vals = node.value if isinstance(node.value, list) else [node.value]
        return got in vals
    if node.kind == "filter":
        if not node.filt:
            return True
        try:
            return _substitute(node.filt, claims)
        except AuthError:
            # a rule whose JWT variable is missing simply fails —
            # deny THIS rule, not the request (ref auth_query_test
            # "Query with missing jwt variables")
            return False
    if node.kind == "gqlrule":
        if rule_runner is None:
            return False
        try:
            uids = rule_runner(node.value, claims)
        except Exception:  # noqa: BLE001 — missing claim/var => rule fails
            return False
        return {"id": list(uids)}
    parts = [evaluate(c, claims, rule_runner) for c in node.children]
    if node.kind == "and":
        if any(p is False for p in parts):
            return False
        filts = [p for p in parts if isinstance(p, dict)]
        if not filts:
            return True
        return filts[0] if len(filts) == 1 else {"and": filts}
    if node.kind == "or":
        if any(p is True for p in parts):
            return True
        filts = [p for p in parts if isinstance(p, dict)]
        if not filts:
            return False
        return filts[0] if len(filts) == 1 else {"or": filts}
    if node.kind == "not":
        p = parts[0]
        if isinstance(p, bool):
            return not p
        return {"not": p}
    raise AuthError(f"bad auth node {node.kind}")


def _substitute(obj, claims):
    if isinstance(obj, dict):
        return {k: _substitute(v, claims) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(x, claims) for x in obj]
    if isinstance(obj, str) and obj.startswith("$"):
        name = obj[1:]
        if name not in claims:
            raise AuthError(f"JWT claim {name!r} required by auth rule")
        return claims[name]
    return obj


# ---------------------------------------------------------------------------
# Tiny GraphQL-literal object parser (keys may be $names; values are
# strings/numbers/bools/lists/objects)
# ---------------------------------------------------------------------------


def _balanced_object(s: str, start: int) -> str:
    depth = 0
    i = start
    in_str = False
    while i < len(s):
        ch = s[i]
        if in_str:
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return s[start : i + 1]
        i += 1
    raise AuthError(f"unbalanced object at {start} in {s!r}")


_OBJ_TOKEN = re.compile(
    r"""[\s,]+
      | (?P<string>"(?:\\.|[^"\\])*")
      | (?P<num>-?\d+\.\d+|-?\d+)
      | (?P<name>\$?[_A-Za-z][\w.]*)
      | (?P<punct>\{|\}|\[|\]|:)
    """,
    re.VERBOSE,
)


def _parse_gql_object(src: str):
    toks: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _OBJ_TOKEN.match(src, pos)
        if not m:
            raise AuthError(f"bad char {src[pos]!r} in auth object")
        if m.lastgroup:
            toks.append((m.lastgroup, m.group()))
        pos = m.end()

    i = 0

    def parse_value():
        nonlocal i
        kind, text = toks[i]
        if kind == "punct" and text == "{":
            return parse_obj()
        if kind == "punct" and text == "[":
            i += 1
            out = []
            while toks[i] != ("punct", "]"):
                out.append(parse_value())
            i += 1
            return out
        i += 1
        if kind == "string":
            return json.loads(text)
        if kind == "num":
            return float(text) if "." in text else int(text)
        if kind == "name":
            if text == "true":
                return True
            if text == "false":
                return False
            if text == "null":
                return None
            return text  # enum or $var
        raise AuthError(f"unexpected token {text!r}")

    def parse_obj():
        nonlocal i
        assert toks[i] == ("punct", "{")
        i += 1
        out = {}
        while toks[i] != ("punct", "}"):
            kind, key = toks[i]
            if kind not in ("name", "string"):
                raise AuthError(f"bad object key {key!r}")
            if kind == "string":
                key = json.loads(key)
            i += 1
            if toks[i] != ("punct", ":"):
                raise AuthError(f"expected : after {key!r}")
            i += 1
            out[key] = parse_value()
        i += 1
        return out

    out = parse_obj()
    if i != len(toks):
        raise AuthError("trailing tokens in auth object")
    return out
