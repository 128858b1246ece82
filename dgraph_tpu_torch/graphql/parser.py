"""Minimal GraphQL operation parser (queries + mutations with variables).

Stand-in for the reference's vendored gqlparser
(dgraph/graphql/schema uses github.com/dgraph-io/gqlparser):
parses operations, selection sets, arguments (int/float/string/bool/enum/
list/object/variable), aliases, and variable definitions.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class GqlParseError(Exception):
    pass


_TOKEN = re.compile(
    r"""
    (?P<ws>[\s,]+|\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<num>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+)
  | (?P<name>[_A-Za-z]\w*)
  | (?P<punct>\$|\(|\)|\{|\}|\[|\]|:|=|!|@|\.\.\.)
""",
    re.VERBOSE,
)


def _tokenize(s: str):
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            raise GqlParseError(f"unexpected char {s[pos]!r} at {pos}")
        if m.lastgroup != "ws":
            out.append((m.lastgroup, m.group(), pos))
        pos = m.end()
    out.append(("eof", "", len(s)))
    return out


@dataclass
class Selection:
    name: str
    alias: str = ""
    args: Dict[str, Any] = field(default_factory=dict)
    selections: List["Selection"] = field(default_factory=list)
    # inline fragment: name == "..." and frag_on holds the type
    # condition; its selections apply only to nodes of that type
    frag_on: str = ""
    # field directives other than @skip/@include (those are evaluated
    # at parse time since variables are already substituted): e.g.
    # ("cascade", {"fields": [...]})
    directives: List = field(default_factory=list)

    @property
    def key(self) -> str:
        return self.alias or self.name


@dataclass
class Operation:
    kind: str  # query | mutation
    name: str = ""
    var_defs: Dict[str, Any] = field(default_factory=dict)  # name -> default
    selections: List[Selection] = field(default_factory=list)


class _P:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        if self.i >= len(self.toks):
            raise GqlParseError("unexpected end of query")
        return self.toks[self.i]

    def next(self):
        if self.i >= len(self.toks):
            raise GqlParseError("unexpected end of query")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text):
        t = self.next()
        if t[1] != text:
            raise GqlParseError(f"expected {text!r}, got {t[1]!r} at {t[2]}")
        return t

    def accept(self, text):
        if self.peek()[1] == text:
            self.i += 1
            return True
        return False


def _unquote(s: str) -> str:
    return re.sub(
        r"\\(.)",
        lambda m: {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
            m.group(1), m.group(1)
        ),
        s[1:-1],
    )


def _parse_value(p: _P, variables: Dict[str, Any]):
    kind, text, pos = p.next()
    if text == "$":
        vname = p.next()[1]
        if vname not in variables:
            raise GqlParseError(f"undefined variable ${vname}")
        return variables[vname]
    if kind == "string":
        return _unquote(text)
    if kind == "num":
        return float(text) if ("." in text or "e" in text.lower()) else int(text)
    if text == "[":
        out = []
        while p.peek()[1] != "]":
            out.append(_parse_value(p, variables))
        p.expect("]")
        return out
    if text == "{":
        obj = {}
        while p.peek()[1] != "}":
            k = p.next()[1]
            p.expect(":")
            obj[k] = _parse_value(p, variables)
        p.expect("}")
        return obj
    if text == "true":
        return True
    if text == "false":
        return False
    if text == "null":
        return None
    if kind == "name":
        return text  # enum
    raise GqlParseError(f"bad value {text!r} at {pos}")


def _parse_args(p: _P, variables):
    args = {}
    if p.accept("("):
        while p.peek()[1] != ")":
            name = p.next()[1]
            p.expect(":")
            args[name] = _parse_value(p, variables)
        p.expect(")")
    return args


def _parse_directives(p: _P, variables):
    """Returns (keep, directives): @skip/@include evaluate immediately
    (variables are already substituted); the rest are returned."""
    keep = True
    out = []
    while p.accept("@"):
        dname = p.next()[1]
        dargs = _parse_args(p, variables)
        if dname == "skip":
            keep = keep and not dargs.get("if", False)
        elif dname == "include":
            keep = keep and bool(dargs.get("if", True))
        else:
            out.append((dname, dargs))
    return keep, out


def _parse_selection_set(p: _P, variables) -> List[Selection]:
    p.expect("{")
    out = []
    while not p.accept("}"):
        if p.accept("..."):
            nxt = p.peek()[1]
            if nxt == "on" or nxt == "{" or nxt == "@":
                # inline fragment; a missing type condition ('... { x }'
                # / '... @include(...) { x }') means "same type"
                cond = ""
                if nxt == "on":
                    p.next()
                    cond = p.next()[1]
                keep, dirs = _parse_directives(p, variables)
                sels = _parse_selection_set(p, variables)
                if keep:
                    sel = Selection(name="...", frag_on=cond)
                    sel.selections = sels
                    sel.directives = dirs
                    out.append(sel)
            else:  # named fragment spread — expanded after definitions
                fname = p.next()[1]
                keep, dirs = _parse_directives(p, variables)
                if keep:
                    sel = Selection(name="...", frag_on="")
                    sel.alias = f"__spread_{fname}"
                    sel.directives = dirs
                    out.append(sel)
            continue
        name = p.next()[1]
        sel = Selection(name=name)
        if p.accept(":"):
            sel.alias = name
            sel.name = p.next()[1]
        sel.args = _parse_args(p, variables)
        keep, sel.directives = _parse_directives(p, variables)
        if p.peek()[1] == "{":
            sel.selections = _parse_selection_set(p, variables)
        if keep:
            out.append(sel)
    return out


def _expand_spreads(
    sels: List[Selection], fragments, _stack=()
) -> List[Selection]:
    out = []
    for s in sels:
        if s.name == "..." and s.alias.startswith("__spread_"):
            fname = s.alias[len("__spread_") :]
            if fname in _stack:
                # the GraphQL spec rejects fragment cycles outright
                raise GqlParseError(f"fragment cycle through {fname!r}")
            frag = fragments.get(fname)
            if frag is None:
                raise GqlParseError(f"undefined fragment {fname!r}")
            cond, fsels = frag
            inline = Selection(name="...", frag_on=cond)
            inline.directives = s.directives
            inline.selections = _expand_spreads(
                fsels, fragments, _stack + (fname,)
            )
            out.append(inline)
        else:
            s.selections = _expand_spreads(s.selections, fragments, _stack)
            out.append(s)
    return out


def _skip_frag_directives(p) -> None:
    """Skip '@name(args)' directive tokens between a fragment's type
    condition and its '{' (legal GraphQL: 'fragment F on T @dir { … }')."""
    while p.peek()[1] == "@":
        p.next()
        p.next()  # directive name
        if p.peek()[1] == "(":
            depth = 0
            while True:
                tkn = p.next()[1]
                if tkn == "(":
                    depth += 1
                elif tkn == ")":
                    depth -= 1
                    if depth == 0:
                        break


def parse_operation(
    text: str, variables: Optional[Dict[str, Any]] = None
) -> Operation:
    variables = dict(variables or {})
    toks = _tokenize(text)
    p = _P(toks)
    kind = "query"
    name = ""
    fragments: Dict[str, tuple] = {}
    # Fragment definitions may precede the operation, but their bodies
    # can reference operation variables (incl. defaults declared in the
    # operation prologue) — so skip their token spans now and parse
    # them AFTER the variable definitions are known.
    leading: list = []  # (header_index,) spans to revisit
    while p.peek()[1] == "fragment":
        start = p.i
        p.next()
        p.next()  # name
        p.expect("on")
        p.next()  # type condition
        _skip_frag_directives(p)
        p.expect("{")
        depth = 1
        while depth:
            tkn = p.next()[1]
            if tkn == "{":
                depth += 1
            elif tkn == "}":
                depth -= 1
        leading.append(start)
    t = p.peek()
    if t[1] in ("query", "mutation"):
        kind = p.next()[1]
        if p.peek()[0] == "name":
            name = p.next()[1]
        if p.accept("("):
            # variable definitions: ($x: Type! = default)
            while p.peek()[1] != ")":
                p.expect("$")
                vname = p.next()[1]
                p.expect(":")
                # type: [ ]* Name with ! anywhere ([String!]! etc.)
                while p.peek()[1] in ("[",):
                    p.next()
                p.next()  # type name
                while p.peek()[1] in ("!", "]"):
                    p.next()
                if p.accept("="):
                    default = _parse_value(p, variables)
                    variables.setdefault(vname, default)
                if vname not in variables:
                    variables[vname] = None
            p.expect(")")
    # now parse the leading fragments with full variable knowledge
    for start in leading:
        fp = _P(toks)
        fp.i = start
        fp.next()
        fname = fp.next()[1]
        fp.expect("on")
        cond = fp.next()[1]
        _skip_frag_directives(fp)
        fragments[fname] = (
            cond,
            _parse_selection_set(fp, variables),
        )
    op = Operation(kind=kind, name=name)
    op.selections = _parse_selection_set(p, variables)
    # fragment definitions may follow the operation
    while p.peek()[1] == "fragment":
        p.next()
        fname = p.next()[1]
        p.expect("on")
        cond = p.next()[1]
        _skip_frag_directives(p)
        fragments[fname] = (cond, _parse_selection_set(p, variables))
    if p.peek()[0] != "eof":
        raise GqlParseError(f"trailing input at {p.peek()[2]}")
    op.selections = _expand_spreads(op.selections, fragments)
    return op
