"""DQL parser: query text -> GraphQuery AST.

Hand-rolled tokenizer + recursive descent mirroring the grammar of
dgraph/dql/parser.go (states in dql/state.go, lexer lex/lexer.go).
Covers the core read grammar:

  { name: blockName(func: f(...), first: N, offset: N, after: uid,
                    orderasc: pred | orderdesc: pred)
      @filter(tree of f(...) AND/OR/NOT, parens)
      @recurse(depth: N, loop: false)
      @cascade
    { alias: pred @filter(...) (first/offset/orderasc...) { ... }
      uid | expand(_all_) | count(pred) | count(uid)
      v as pred         # value/uid variables
      val(v) | min(val(v)) | max(val(v)) | sum(val(v)) | avg(val(v))
      shortest(from:, to:, numpaths:) blocks
    } }

Root funcs (ref dql/parser.go:1884 similar_to incl. options;
worker/task.go:230 parseFuncType): eq, le, lt, ge, gt, between, has, uid,
uid_in, type, anyofterms, allofterms, anyoftext, alloftext, regexp, match,
similar_to, near, within, alloftermsfacets... (geo near/within take
coordinates).

Variables: `uid` vars (`x as friend`) and value vars (`a as age`), consumed
by uid(x)/val(a) — dependency ordering handled by the executor
(ref query/query.go:2899 canExecute).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dgraph_tpu_torch.types.types import TypeID, Val


class ParseError(Exception):
    pass


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*|//[^\n]*)
  # a string is runs of plain characters between its escapes, one
  # greedy class a run: a long literal (a vector of 768 floats) lexes
  # without a backtracking frame a character
  | (?P<string>"[^"\\]*(?:\\.[^"\\]*)*")
  | (?P<regex>/(?:\\.|[^/\\])+/[i]?)
  | (?P<num>0x[0-9a-fA-F]+|\d+\.\d+|\d+)
  | (?P<name>~?[a-zA-Z_][\w.~]*|<[^>]+>|\$[a-zA-Z_]\w*)
  | (?P<punct>@|\(|\)|\{|\}|\[|\]|:|,|==|!=|=|\*|\+|-|/|%|<=|>=|<|>|\.|!)
""",
    re.VERBOSE,
)


@dataclass
class Tok:
    kind: str
    text: str
    pos: int


def tokenize(s: str) -> List[Tok]:
    out: List[Tok] = []
    pos = 0
    n = len(s)
    while pos < n:
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ParseError(f"unexpected character {s[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind == "regex":
            # '/' is also the division operator; a regex literal is only
            # legal in value position (after '(' or ','), e.g. regexp(x, /../)
            prev = out[-1].text if out else ""
            if prev not in ("(", ","):
                out.append(Tok("punct", "/", pos))
                pos += 1
                continue
        if kind != "ws":
            out.append(Tok(kind, m.group(), pos))
        pos = m.end()
    out.append(Tok("eof", "", n))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class FuncSpec:
    """A function application: name, attr, args (ref dql Function)."""

    name: str
    attr: str = ""
    lang: str = ""
    args: List[Any] = field(default_factory=list)
    # named options for similar_to etc (ref parser.go:1884-1990)
    options: Dict[str, Any] = field(default_factory=dict)
    uid_var: str = ""  # for uid(x)
    val_var: str = ""  # for eq(val(x), ...)
    is_count: bool = False  # for eq(count(pred), N)
    is_len: bool = False  # for eq(len(x), N) (ref query.go IsLenVar)


@dataclass
class FilterTree:
    """AND/OR/NOT tree over FuncSpecs (ref dql FilterTree)."""

    op: str = ""  # "and" | "or" | "not" | "" (leaf)
    children: List["FilterTree"] = field(default_factory=list)
    func: Optional[FuncSpec] = None


@dataclass
class Order:
    attr: str
    desc: bool = False
    lang: str = ""
    val_var: str = ""


@dataclass
class GraphQuery:
    """One query block or child attribute (ref dql.GraphQuery)."""

    attr: str = ""  # predicate (children) or block name (roots)
    alias: str = ""
    func: Optional[FuncSpec] = None
    filter: Optional[FilterTree] = None
    children: List["GraphQuery"] = field(default_factory=list)
    # pagination / order
    first: Optional[int] = None
    offset: Optional[int] = None
    after: Optional[int] = None
    order: List[Order] = field(default_factory=list)
    # variables
    var_name: str = ""  # `x as pred`
    is_var_block: bool = False  # root declared with `var(func:...)`
    # aggregation/count/val
    is_count: bool = False
    is_uid: bool = False  # `uid` leaf
    aggregator: str = ""  # min/max/sum/avg
    val_var: str = ""  # val(x) read
    expand: str = ""  # expand(_all_) / expand(TypeName)
    # directives
    cascade: bool = False
    # @cascade(pred1, pred2): only these preds are required; empty =
    # all queried fields (ref dql/parser.go parseCascade)
    cascade_fields: list = field(default_factory=list)
    recurse: bool = False
    recurse_depth: int = 0
    recurse_loop: bool = False
    normalize: bool = False
    ignore_reflex: bool = False
    # math & groupby
    math_expr: Optional["MathNode"] = None
    groupby_attrs: List[str] = field(default_factory=list)
    groupby_aliases: Dict[str, str] = field(default_factory=dict)  # attr->alias
    # facets
    facets: bool = False
    facet_names: List[str] = field(default_factory=list)
    facet_aliases: Dict[str, str] = field(default_factory=dict)  # facet->alias
    facet_vars: Dict[str, str] = field(default_factory=dict)  # var -> facet
    facet_filter: Optional["FuncSpec"] = None
    facet_order: str = ""
    facet_order_desc: bool = False
    # multi-key facet ordering, listing order: [(facet, desc), ...]
    facet_orders: List[Any] = field(default_factory=list)
    # lang tag on predicate: name@en
    lang: str = ""
    # checkpwd(pred, "pw") selection field
    checkpwd_val: Optional[str] = None
    # shortest-path args
    shortest_from: Optional[Any] = None
    shortest_to: Optional[Any] = None
    num_paths: int = 1
    min_weight: Optional[float] = None
    max_weight: Optional[float] = None


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _P:
    def __init__(self, toks: List[Tok], text: str, variables=None):
        self.toks = toks
        self.i = 0
        self.text = text
        self.vars: Dict[str, Any] = variables or {}

    def peek(self) -> Tok:
        if self.i >= len(self.toks):
            return self.toks[-1]  # eof sentinel
        return self.toks[self.i]

    def next(self) -> Tok:
        t = self.peek()
        if t.kind == "eof":
            # consuming past end = malformed input; raising (rather than
            # returning eof without advancing) keeps `while` loops from
            # spinning forever on truncated queries
            raise ParseError(f"unexpected end of input at {t.pos}")
        self.i += 1
        return t

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise ParseError(f"expected {text!r}, got {t.text!r} at {t.pos}")
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.i += 1
            return True
        return False


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(
        r"\\(.)",
        lambda m: {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
            m.group(1), m.group(1)
        ),
        body,
    )


def _strip_angle(s: str) -> str:
    return s[1:-1] if s.startswith("<") else s


def _parse_scalar(p: "_P"):
    """Value with optional unary minus (num regex is unsigned so that
    `a - 3` in math context tokenizes as three tokens)."""
    if p.peek().text == "-":
        p.next()
        v = _parse_value(p.next(), p)
        if not isinstance(v, (int, float)):
            raise ParseError("unary minus on non-number")
        return -v
    return _parse_value(p.next(), p)


def _parse_value(t: Tok, p: Optional["_P"] = None):
    if t.kind == "name" and t.text.startswith("$"):
        if p is None or t.text not in p.vars:
            raise ParseError(f"undefined query variable {t.text} at {t.pos}")
        return p.vars[t.text]
    if t.kind == "regex":
        # /pattern/flags -> ("regex", pattern, flags)
        end = t.text.rindex("/")
        return ("regex", t.text[1:end], t.text[end + 1 :])
    if t.kind == "string":
        return _unquote(t.text)
    if t.kind == "num":
        if t.text.startswith("0x"):
            return int(t.text, 16)
        if "." in t.text:
            return float(t.text)
        return int(t.text)
    if t.text in ("true", "false"):
        return t.text == "true"
    if t.kind == "name":
        return t.text
    if t.text == "*":
        return "*"
    raise ParseError(f"unexpected value token {t.text!r} at {t.pos}")


def _parse_lang_chain(p: _P) -> str:
    """en | en:fr:de | . — language preference list (ref dql lang lists)."""
    parts = [p.next().text]
    while p.peek().text == ":" and (
        p.toks[p.i + 1].kind == "name" or p.toks[p.i + 1].text == "."
    ):
        p.next()
        parts.append(p.next().text)
    return ":".join(parts)


def _uid_value(v, t: Tok) -> int:
    """Coerce a query-variable value into a uid."""
    try:
        if isinstance(v, str):
            return int(v, 16) if v.startswith("0x") else int(v)
        return int(v)
    except (TypeError, ValueError):
        raise ParseError(
            f"variable {t.text} is not a valid uid: {v!r}"
        ) from None


def _parse_name_with_lang(p: _P) -> tuple[str, str]:
    name = _strip_angle(p.next().text)
    lang = ""
    if p.peek().text == "@" and (
        p.toks[p.i + 1].kind == "name" or p.toks[p.i + 1].text in (".", "*")
    ):
        # name@en / name@en:fr:. (no whitespace enforced; lexer-level in ref)
        p.next()
        lang = _parse_lang_chain(p)
    return name, lang


def parse_func(p: _P) -> FuncSpec:
    name = p.next().text.lower()
    p.expect("(")
    fn = FuncSpec(name=name)
    if name == "uid":
        # uid(0x1, 0x2) or uid(var1, var2) or uid($queryvar)
        args = []
        uvars = []
        while p.peek().text != ")":
            t = p.next()
            if t.kind == "num":
                args.append(int(t.text, 16) if t.text.startswith("0x") else int(t.text))
            elif t.kind == "name" and t.text.startswith("$"):
                args.append(_uid_value(_parse_value(t, p), t))
            elif t.kind == "name":
                uvars.append(t.text)
            p.accept(",")
        p.expect(")")
        fn.uid_var = ",".join(uvars)  # uid(L, B) unions several vars
        fn.args = args
        return fn
    if name == "uid_in":
        attr, lang = _parse_name_with_lang(p)
        fn.attr, fn.lang = attr, lang
        p.expect(",")
        while p.peek().text != ")":
            t = p.next()
            if t.kind == "num":
                fn.args.append(
                    int(t.text, 16) if t.text.startswith("0x") else int(t.text)
                )
            elif t.kind == "name" and t.text.startswith("$"):
                fn.args.append(_uid_value(_parse_value(t, p), t))
            elif t.text == "uid":
                p.expect("(")
                fn.uid_var = p.next().text
                p.expect(")")
            p.accept(",")
        p.expect(")")
        return fn

    # first arg: attr, val(x), len(x), count(pred), or type name
    if p.peek().text == "val" and p.toks[p.i + 1].text == "(":
        p.next()
        p.expect("(")
        fn.val_var = p.next().text
        p.expect(")")
    elif p.peek().text == "len" and p.toks[p.i + 1].text == "(":
        p.next()
        p.expect("(")
        fn.val_var = p.next().text
        fn.is_len = True
        p.expect(")")
    elif p.peek().text == "count" and p.toks[p.i + 1].text == "(":
        p.next()
        p.expect("(")
        fn.attr = _strip_angle(p.next().text)
        fn.is_count = True
        p.expect(")")
    elif p.peek().kind == "string":
        # quoted first arg: type("Person") (ref parser tolerance)
        fn.attr = _unquote(p.next().text)
    else:
        fn.attr, fn.lang = _parse_name_with_lang(p)

    while p.accept(","):
        # named option? name: value (similar_to opts, between second arg...)
        t = p.peek()
        if (
            t.kind == "name"
            and self_is_option(p)
        ):
            key = p.next().text
            p.expect(":")
            fn.options[key] = _parse_scalar(p)
            continue
        if t.text == "[":
            fn.args.append(_parse_list(p))
            continue
        if t.text == "val" and p.toks[p.i + 1].text == "(":
            # eq(name, val(a)): compare against the var's value set
            p.next()
            p.expect("(")
            fn.args.append(("valarg", p.next().text))
            p.expect(")")
            continue
        fn.args.append(_parse_scalar(p))
    p.expect(")")
    return fn


def self_is_option(p: _P) -> bool:
    # lookahead: name ':' value  (but not 'val(' etc.)
    return (
        p.toks[p.i + 1].text == ":"
        if p.i + 1 < len(p.toks)
        else False
    )


def _parse_list(p: _P) -> list:
    p.expect("[")
    out = []
    while p.peek().text != "]":
        if p.peek().text == "[":
            out.append(_parse_list(p))  # nested (geo polygons)
        else:
            out.append(_parse_scalar(p))
        p.accept(",")
    p.expect("]")
    return out


# ---------------------------------------------------------------------------
# Math expressions (ref dql/math.go): math(a + b*2 - min(c, 3))
# ---------------------------------------------------------------------------

_MATH_FUNCS = (
    "min", "max", "sqrt", "ln", "exp", "floor", "ceil", "pow", "logbase",
    "since", "cond",
)


@dataclass
class MathNode:
    op: str = ""  # "+", "-", "*", "/", "%", func name, "const", "var"
    children: List["MathNode"] = field(default_factory=list)
    const: Any = None
    var: str = ""


def parse_math(p: _P) -> MathNode:
    p.expect("(")
    node = _math_expr(p)
    p.expect(")")
    return node


def _math_expr(p: _P) -> MathNode:
    # comparisons are the loosest-binding math level (ref query/math.go
    # ops: cond(a > 10, ..) / a == 38 / a != 38)
    left = _math_addsub(p)
    while p.peek().text in ("==", "!=", "<", ">", "<=", ">="):
        op = p.next().text
        right = _math_addsub(p)
        left = MathNode(op=op, children=[left, right])
    return left


def _math_addsub(p: _P) -> MathNode:
    left = _math_term(p)
    while p.peek().text in ("+", "-"):
        op = p.next().text
        right = _math_term(p)
        left = MathNode(op=op, children=[left, right])
    return left


def _math_term(p: _P) -> MathNode:
    left = _math_unary(p)
    while p.peek().text in ("*", "/", "%", "dot"):
        op = p.next().text
        right = _math_unary(p)
        left = MathNode(op=op, children=[left, right])
    return left


def _math_unary(p: _P) -> MathNode:
    if p.accept("-"):
        return MathNode(op="neg", children=[_math_unary(p)])
    return _math_atom(p)


def _math_atom(p: _P) -> MathNode:
    t = p.peek()
    if t.text == "(":
        p.next()
        node = _math_expr(p)
        p.expect(")")
        return node
    if t.kind == "num":
        p.next()
        v = int(t.text, 16) if t.text.startswith("0x") else (
            float(t.text) if "." in t.text else int(t.text)
        )
        return MathNode(op="const", const=v)
    if t.kind == "name" and t.text.startswith("$"):
        p.next()
        if t.text not in p.vars:
            raise ParseError(f"undefined variable {t.text} in math")
        v = p.vars[t.text]
        if isinstance(v, str) and v.lstrip().startswith("["):
            import json as _json

            v = _json.loads(v)
        return MathNode(op="const", const=v)
    if t.kind == "name":
        p.next()
        if t.text in _MATH_FUNCS and p.peek().text == "(":
            p.next()
            args = [_math_expr(p)]
            while p.accept(","):
                args.append(_math_expr(p))
            p.expect(")")
            return MathNode(op=t.text, children=args)
        if t.text == "val" and p.peek().text == "(":
            p.next()
            var = p.next().text
            p.expect(")")
            return MathNode(op="var", var=var)
        return MathNode(op="var", var=t.text)
    raise ParseError(f"bad math token {t.text!r} at {t.pos}")


def parse_filter(p: _P) -> FilterTree:
    """@filter( tree )  with AND/OR/NOT and parens."""
    p.expect("(")
    tree = _parse_or(p)
    p.expect(")")
    return tree


def _parse_or(p: _P) -> FilterTree:
    left = _parse_and(p)
    while p.peek().text.upper() == "OR":
        p.next()
        right = _parse_and(p)
        if left.op == "or":
            left.children.append(right)
        else:
            left = FilterTree(op="or", children=[left, right])
    return left


def _parse_and(p: _P) -> FilterTree:
    left = _parse_unary(p)
    while p.peek().text.upper() == "AND":
        p.next()
        right = _parse_unary(p)
        if left.op == "and":
            left.children.append(right)
        else:
            left = FilterTree(op="and", children=[left, right])
    return left


def _parse_unary(p: _P) -> FilterTree:
    if p.peek().text.upper() == "NOT":
        p.next()
        return FilterTree(op="not", children=[_parse_unary(p)])
    if p.accept("("):
        t = _parse_or(p)
        p.expect(")")
        return t
    fn = parse_func(p)
    return FilterTree(func=fn)


_PAGINATION_ARGS = ("first", "offset", "after", "orderasc", "orderdesc", "depth", "loop")


def _parse_args_into(p: _P, gq: GraphQuery, stop: str = ")"):
    """Parse `first: N, offset: N, orderasc: pred, ...` until `stop`."""
    while p.peek().text != stop:
        key = p.next().text
        p.expect(":")
        if key in ("first", "offset"):
            setattr(gq, key, int(_parse_scalar(p)))
        elif key == "after":
            gq.after = int(_parse_scalar(p))
        elif key in ("orderasc", "orderdesc"):
            if p.peek().text == "val":
                p.next()
                p.expect("(")
                var = p.next().text
                p.expect(")")
                gq.order.append(
                    Order(attr="", desc=key == "orderdesc", val_var=var)
                )
            else:
                attr, lang = _parse_name_with_lang(p)
                gq.order.append(
                    Order(attr=attr, desc=key == "orderdesc", lang=lang)
                )
        elif key == "func":
            gq.func = parse_func(p)
        elif key == "from":
            gq.shortest_from = _parse_uid_or_var(p)
        elif key == "to":
            gq.shortest_to = _parse_uid_or_var(p)
        elif key == "numpaths":
            gq.num_paths = int(_parse_scalar(p))
        elif key == "minweight":
            gq.min_weight = float(_parse_scalar(p))
        elif key == "maxweight":
            gq.max_weight = float(_parse_scalar(p))
        elif key == "depth":
            gq.recurse_depth = int(_parse_scalar(p))
        elif key == "loop":
            v = _parse_scalar(p)
            gq.recurse_loop = v if isinstance(v, bool) else str(v) == "true"
        else:
            raise ParseError(f"unknown query arg {key!r}")
        p.accept(",")
    p.expect(stop)


def _parse_uid_or_var(p: _P):
    t = p.next()
    if t.kind == "num":
        return int(t.text, 16) if t.text.startswith("0x") else int(t.text)
    if t.text == "uid":
        p.expect("(")
        v = p.next().text
        p.expect(")")
        return ("var", v)
    return ("var", t.text)


def _parse_directives(p: _P, gq: GraphQuery):
    while p.peek().text == "@":
        p.next()
        d = p.next().text.lower()  # @IGNOREREFLEX etc. are case-insensitive
        if d == "filter":
            gq.filter = parse_filter(p)
        elif d == "cascade":
            gq.cascade = True
            if p.accept("("):
                while p.peek().text != ")":
                    tok = p.next().text
                    if tok != ",":
                        gq.cascade_fields.append(tok)
                p.expect(")")
        elif d == "normalize":
            gq.normalize = True
        elif d == "ignorereflex":
            gq.ignore_reflex = True
        elif d == "recurse":
            gq.recurse = True
            if p.accept("("):
                _parse_args_into(p, gq, stop=")")
        elif d == "groupby":
            p.expect("(")
            while p.peek().text != ")":
                name = _strip_angle(p.next().text)
                if p.accept(":"):  # @groupby(ALIAS: attr, ...)
                    gq.groupby_aliases[_strip_angle(p.peek().text)] = name
                    name = _strip_angle(p.next().text)
                gq.groupby_attrs.append(name)
                p.accept(",")
            p.expect(")")
        elif d == "facets":
            if p.accept("("):
                if p.accept(")"):
                    # @facets() with empty parens fetches NOTHING
                    # (ref TestFetchingNoFacets), unlike bare @facets
                    return _parse_directives(p, gq)
                is_filter = p.peek().text.upper() == "NOT" or (
                    p.peek().kind == "name"
                    and p.toks[p.i + 1].text == "("
                    and p.peek().text.lower()
                    in ("eq", "le", "lt", "ge", "gt", "allofterms", "anyofterms")
                )
                if is_filter:
                    # @facets(eq(close, true) OR eq(family, true)) — a full
                    # boolean edge-filter tree (ref facets filtering)
                    gq.facet_filter = _parse_or(p)
                    p.expect(")")
                    return _parse_directives(p, gq)
                gq.facets = True
                while p.peek().text != ")":
                    t = p.next()
                    if t.text in ("orderasc", "orderdesc"):
                        # ordering facets also project (ref TestOrderFacets:
                        # orderasc:since emits friend|since)
                        p.expect(":")
                        fname = p.next().text
                        gq.facet_orders.append((fname, t.text == "orderdesc"))
                        if not gq.facet_order:
                            gq.facet_order = fname
                            gq.facet_order_desc = t.text == "orderdesc"
                        if fname not in gq.facet_names:
                            gq.facet_names.append(fname)
                    elif p.peek().text == "as":
                        # `w as weight`: bind the facet into a value var
                        # (ref query facet var bindings)
                        p.next()  # as
                        fname = p.next().text
                        gq.facet_vars[t.text] = fname
                        gq.facet_names.append(fname)
                    elif p.peek().text == ":":
                        # `o: origin` — facet alias; output key is the bare
                        # alias (ref TestFacetsAlias golden)
                        p.next()  # :
                        fname = p.next().text
                        gq.facet_names.append(fname)
                        gq.facet_aliases[fname] = t.text
                    else:
                        gq.facet_names.append(t.text)
                    p.accept(",")
                p.expect(")")
            else:
                gq.facets = True
        else:
            raise ParseError(f"unknown directive @{d}")


def parse_selection_set(p: _P, gq: GraphQuery):
    p.expect("{")
    while not p.accept("}"):
        gq.children.append(parse_child(p))


def parse_child(p: _P) -> GraphQuery:
    gq = GraphQuery()
    t = p.next()
    name = _strip_angle(t.text)

    # `x as pred` variable definition
    if p.peek().text.lower() == "as":
        p.next()
        gq.var_name = name
        t2 = p.next()
        name = _strip_angle(t2.text)

    # alias: `alias: pred`
    if p.peek().text == ":" and name not in ("count",):
        p.next()
        gq.alias = name
        name = _strip_angle(p.next().text)
        # `alias: x as math(...)` — alias AND var on one field
        if p.peek().text.lower() == "as":
            p.next()
            gq.var_name = name
            name = _strip_angle(p.next().text)

    if name == "count":
        p.expect("(")
        inner = _strip_angle(p.next().text)
        gq.is_count = True
        if inner == "uid":
            gq.attr = "uid"
        else:
            gq.attr = inner
            # count(pred@lang ...) / count(pred @filter(...) (first:N))
            if p.peek().text == "@" and p.toks[p.i + 1].kind == "name" and \
                    p.toks[p.i + 1].text not in ("filter", "facets"):
                p.next()
                gq.lang = _parse_lang_chain(p)
            while True:
                if p.peek().text == "(":
                    p.next()
                    _parse_args_into(p, gq, stop=")")
                elif p.peek().text == "@":
                    p.next()
                    d = p.next().text.lower()
                    if d == "filter":
                        gq.filter = parse_filter(p)
                    else:
                        raise ParseError(
                            f"@{d} inside count() not supported"
                        )
                else:
                    break
        p.expect(")")
        # trailing directives: count(boss) @facets(eq(company, "x"))
        # restricts the counted edges by facet (ref facets count tests)
        while p.peek().text == "@":
            p.next()
            d = p.next().text.lower()
            if d == "facets":
                p.expect("(")
                gq.facet_filter = _parse_or(p)
                p.expect(")")
            elif d == "filter":
                gq.filter = parse_filter(p)
            else:
                raise ParseError(f"@{d} after count() not supported")
        return gq

    if name in ("min", "max", "sum", "avg"):
        p.expect("(")
        if p.peek().text == "val":
            p.next()
            p.expect("(")
            gq.val_var = p.next().text
            p.expect(")")
        else:
            # min(age): aggregate a predicate directly (@groupby children,
            # ref query/groupby.go aggregates)
            gq.attr = _strip_angle(p.next().text)
        p.expect(")")
        gq.aggregator = name
        return gq

    if name == "val":
        p.expect("(")
        gq.val_var = p.next().text
        p.expect(")")
        gq.attr = "val"
        return gq

    if name == "math":
        gq.math_expr = parse_math(p)
        gq.attr = "math"
        return gq

    if name == "uid":
        gq.is_uid = True
        gq.attr = "uid"
        return gq

    if name == "checkpwd" and p.peek().text == "(":
        # checkpwd(password, "123456") as a selection field
        # (ref query.go checkpwd emission {"checkpwd(password)": bool})
        p.next()
        gq.attr = _strip_angle(p.next().text)
        p.expect(",")
        gq.checkpwd_val = str(_parse_scalar(p))
        p.expect(")")
        return gq

    if name == "expand":
        p.expect("(")
        if p.peek().text == "val" and p.toks[p.i + 1].text == "(":
            # expand(val(x)): predicates named by the var's values
            p.next()
            p.expect("(")
            gq.expand = "val:" + p.next().text
            p.expect(")")
        else:
            parts = [p.next().text]
            while p.accept(","):  # expand(Type1, Type2)
                parts.append(p.next().text)
            gq.expand = ",".join(parts)
        p.expect(")")
        gq.attr = "expand"
        _parse_directives(p, gq)  # expand(_all_) @filter(type(X))
        if p.peek().text == "{":
            parse_selection_set(p, gq)
        return gq

    gq.attr = name
    # lang tag / preference chain (name@en, name@fr:pt:.)
    if (
        p.peek().text == "@"
        and (
            p.toks[p.i + 1].kind == "name"
            or p.toks[p.i + 1].text in (".", "*")
        )
        and p.toks[p.i + 1].text
        not in ("filter", "facets", "cascade", "normalize", "recurse", "groupby")
    ):
        p.next()
        gq.lang = _parse_lang_chain(p)

    # argument lists and directives may interleave in any order:
    # pred (first: N) @filter(...)  |  pred @filter(...) (orderasc: x)
    while True:
        if p.accept("("):
            _parse_args_into(p, gq, stop=")")
        elif p.peek().text == "@":
            _parse_directives(p, gq)
        else:
            break

    if p.peek().text == "{":
        parse_selection_set(p, gq)
    return gq


def parse_query_block(p: _P) -> GraphQuery:
    gq = GraphQuery()
    t = p.next()
    name = t.text

    # `x as var(func: ...)` or `name as shortest(...)`?
    if p.peek().text.lower() == "as":
        p.next()
        gq.var_name = name
        name = p.next().text

    gq.attr = name
    if name == "var":
        gq.is_var_block = True
    if p.peek().text == ":" :
        # block alias `q: something(...)` — treat name as alias
        p.next()
        gq.alias = name
        gq.attr = p.next().text

    if gq.attr == "shortest":
        p.expect("(")
        _parse_args_into(p, gq, stop=")")
        parse_selection_set(p, gq)
        return gq

    p.expect("(")
    _parse_args_into(p, gq, stop=")")
    _parse_directives(p, gq)
    # any root block may omit its selection set (var blocks commonly, and
    # bare blocks like `me2(func: eq(...))` return uid-only results)
    if p.peek().text == "{":
        parse_selection_set(p, gq)
    return gq


_VAR_TYPES = ("string", "int", "float", "bool", "uid", "default", "float32vector")


def _coerce_var(value, type_name: str):
    if type_name not in _VAR_TYPES:
        raise ParseError(
            f"unknown query variable type {type_name!r} "
            f"(expected one of {_VAR_TYPES})"
        )
    try:
        if type_name in ("int",):
            return int(value)
        if type_name in ("float",):
            return float(value)
        if type_name in ("bool",):
            if isinstance(value, bool):
                return value
            sv = str(value).lower()
            if sv in ("true", "1"):
                return True
            if sv in ("false", "0"):
                return False
            raise ValueError(value)
    except (TypeError, ValueError):
        raise ParseError(
            f"query variable value {value!r} does not match type {type_name}"
        ) from None
    return value


def parse(text: str, variables=None) -> List[GraphQuery]:
    """Parse a DQL read query -> list of root blocks.

    Supports the `query name($a: string = "dflt") { ... }` prologue
    (ref dql/parser.go parseQueryWithVars); `variables` maps "$a" -> value.
    """
    p = _P(tokenize(text), text, variables=dict(variables or {}))
    if p.peek().text == "schema":
        # schema {} | schema(pred: name) {...} | schema(pred: [a, b]) {}
        # | schema(type: T) {} (ref dql/parser.go parseSchema)
        p.next()
        gq = GraphQuery(attr="__schema__")
        if p.accept("("):
            while p.peek().text != ")":
                key = p.next().text
                p.expect(":")
                if key == "pred":
                    if p.accept("["):
                        while p.peek().text != "]":
                            gq.groupby_attrs.append(
                                _strip_angle(p.next().text)
                            )
                            p.accept(",")
                        p.expect("]")
                    else:
                        gq.groupby_attrs.append(_strip_angle(p.next().text))
                elif key == "type":
                    if p.accept("["):
                        names = []
                        while p.peek().text != "]":
                            names.append(p.next().text)
                            p.accept(",")
                        p.expect("]")
                        gq.expand = ",".join(names)
                    else:
                        gq.expand = p.next().text
                else:
                    raise ParseError(f"unknown schema arg {key!r}")
                p.accept(",")
            p.expect(")")
        if p.accept("{"):
            while not p.accept("}"):
                gq.facet_names.append(p.next().text)
        return [gq]
    if p.peek().text == "query":
        p.next()
        if p.peek().kind == "name" and not p.peek().text.startswith("$"):
            p.next()  # operation name
        if p.accept("("):
            while p.peek().text != ")":
                vname = p.next().text
                if not vname.startswith("$"):
                    raise ParseError(f"expected $var, got {vname!r}")
                p.expect(":")
                tname = p.next().text.lower()
                if p.accept("="):
                    default = _parse_scalar(p)
                    p.vars.setdefault(vname, default)
                if vname not in p.vars:
                    raise ParseError(f"missing value for variable {vname}")
                p.vars[vname] = _coerce_var(p.vars[vname], tname)
                p.accept(",")
            p.expect(")")
    p.expect("{")
    blocks: List[GraphQuery] = []
    while not p.accept("}"):
        blocks.append(parse_query_block(p))
    if p.peek().kind != "eof":
        raise ParseError(f"trailing input at {p.peek().pos}")
    return blocks
