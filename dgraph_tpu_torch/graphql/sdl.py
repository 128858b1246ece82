"""GraphQL SDL schema: parse type definitions, generate the DQL mapping.

Mirrors dgraph/graphql/schema/gqlschema.go (API synthesis from
SDL) + schemagen.go (SDL -> dgraph schema): each GraphQL type T with field
f becomes predicate `T.f`; @search(by:[...]) maps to @index tokenizers;
@id fields get @index(hash) @upsert; @hasInverse becomes @reverse pairs;
vector fields (`[Float!] @embedding @search(by:["hnsw"])`) map to
float32vector hnsw indexes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_SCALARS = {
    "String": "string",
    "Int": "int",
    "Int64": "int",
    "Float": "float",
    "Boolean": "bool",
    "DateTime": "datetime",
    "ID": "uid",
    "Point": "geo",
    "Polygon": "geo",
    "MultiPolygon": "geo",
}

_SEARCH_DEFAULT = {
    "string": ["term"],
    "int": ["int"],
    "float": ["float"],
    "bool": ["bool"],
    "datetime": ["year"],
    "geo": ["geo"],
}


@dataclass
class GqlField:
    name: str
    type_name: str  # GraphQL type, e.g. String, Person
    is_list: bool = False
    non_null: bool = False
    is_id: bool = False  # @id (external id) or ID type
    search: List[str] = field(default_factory=list)
    has_inverse: str = ""  # field name on target type
    is_embedding: bool = False
    is_scalar: bool = True
    custom: Optional[dict] = None  # @custom(http: {...}) config
    is_lambda: bool = False  # @lambda: resolved by the lambda server
    # declaring type: a field inherited from an interface keeps the
    # interface's predicate (ref gqlschema.go — Human implements
    # Character stores Character.name, not Human.name)
    owner: str = ""
    is_enum: bool = False  # enum-typed: stored as string
    is_union: bool = False  # union-typed: uid edge, fragment-dispatched
    is_secret: bool = False  # @secret password field (never returned)
    # @dgraph(pred: "...") explicit predicate mapping; "~x" maps the
    # field onto x's reverse edge (ref gqlschema.go dgraph directive)
    dql_pred: str = ""
    # @default(add:/update: {value}) literals; "$now" = request time
    default_add: Optional[str] = None
    default_update: Optional[str] = None
    # @id(interface: true): unique interface-wide, not just per type
    id_interface: bool = False

    @property
    def dql_type(self) -> str:
        if self.is_embedding:
            return "float32vector"
        if self.is_secret:
            return "password"
        if self.is_enum:
            return "string"
        return _SCALARS.get(self.type_name, "uid")


@dataclass
class GqlType:
    name: str
    fields: Dict[str, GqlField] = field(default_factory=dict)
    auth: object = None  # graphql.auth.TypeAuth when @auth present
    # @lambdaOnMutate(add/update/delete) webhook switches
    # (ref gqlschema.go:292, resolve/webhook.go)
    lambda_on_mutate: Dict[str, bool] = field(default_factory=dict)
    kind: str = "type"  # type | interface | input | enum | union
    interfaces: List[str] = field(default_factory=list)  # implemented
    implementers: List[str] = field(default_factory=list)  # for interfaces
    enum_values: List[str] = field(default_factory=list)  # for enums
    members: List[str] = field(default_factory=list)  # for unions
    # Apollo federation: @key(fields: "x") + @extends (ref
    # graphql/schema apollo support; _entities resolver)
    key_field: str = ""
    is_extended: bool = False
    # @dgraph(type: "...") storage type-name override
    dgraph_name: str = ""

    @property
    def stored_name(self) -> str:
        return self.dgraph_name or self.name

    def pred(self, fname: str) -> str:
        """DQL predicate for a field: owner-qualified so interface
        fields share one predicate across implementing types;
        @dgraph(pred:) overrides entirely."""
        f = self.fields.get(fname)
        if f is not None and f.dql_pred:
            return f.dql_pred
        owner = (f.owner or self.name) if f else self.name
        return f"{owner}.{fname}"

    def id_field(self) -> Optional[GqlField]:
        for f in self.fields.values():
            if f.type_name == "ID":
                return f
        return None

    def xid_field(self) -> Optional[GqlField]:
        for f in self.fields.values():
            if f.is_id:
                return f
        return None


_TYPE_RE = re.compile(
    r"type\s+(?P<name>\w+)\s*(?:implements\s+[\w&\s]+)?\{(?P<body>[^}]*)\}",
    re.DOTALL,
)
_FIELD_RE = re.compile(
    r"""(?P<name>\w+)\s*(?P<args>\((?:[^()]|\([^()]*\))*\))?\s*:\s*
    (?P<list>\[)?\s*(?P<type>\w+)\s*(?P<inner_nn>!)?\s*\]?\s*(?P<nn>!)?\s*
    (?P<directives>(?:@\w+(?:[ \t]*\((?:[^()]|\([^()]*\))*\))?\s*)*)""",
    re.VERBOSE,
)
_DIR_RE = re.compile(r"@(\w+)(?:[ \t]*\(((?:[^()]|\([^()]*\))*)\))?")


class SDLError(Exception):
    pass


def _extract_type_auth(sdl: str):
    """Pull type-header directives (between `type X` and its body `{`) out
    of the SDL so @auth blobs — which contain braces inside rule strings —
    don't break the type regex. Returns (cleaned_sdl, {type: auth_blob})."""
    blobs: Dict[str, str] = {}
    out = []
    pos = 0
    for m in re.finditer(r"\b(?:type|interface)\s+(\w+)", sdl):
        name = m.group(1)
        i = m.end()
        in_str = None  # None | '"' | '"""'
        pdepth = 0  # directive args may contain braces; only the body `{`
        # at paren depth 0 ends the header
        while i < len(sdl):
            ch = sdl[i]
            if in_str:
                if in_str == '"""' and sdl.startswith('"""', i):
                    in_str = None
                    i += 3
                    continue
                if in_str == '"' and ch == '"' and sdl[i - 1] != "\\":
                    in_str = None
            elif sdl.startswith('"""', i):
                in_str = '"""'
                i += 3
                continue
            elif ch == '"':
                in_str = '"'
            elif ch == "(":
                pdepth += 1
            elif ch == ")":
                pdepth -= 1
            elif ch == "{" and pdepth == 0:
                break
            i += 1
        header = sdl[m.end() : i]
        am = re.search(r"@auth\s*\(", header)
        if am:
            # balanced-paren scan, quote-aware
            j = am.end()
            depth = 1
            in_str = None
            while j < len(header) and depth:
                ch = header[j]
                if in_str:
                    if in_str == '"""' and header.startswith('"""', j):
                        in_str = None
                        j += 3
                        continue
                    if in_str == '"' and ch == '"' and header[j - 1] != "\\":
                        in_str = None
                elif header.startswith('"""', j):
                    in_str = '"""'
                    j += 3
                    continue
                elif ch == '"':
                    in_str = '"'
                elif ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                j += 1
            blobs[name] = header[am.end() : j - 1]
            header = header[: am.start()] + header[j:]
        out.append(sdl[pos : m.end()])
        out.append(re.sub(r"@auth", "", header))
        pos = i
    out.append(sdl[pos:])
    return "".join(out), blobs


def _scan_bodies(sdl: str):
    """Extract (kind, type_name, header, body_text) with quote- and
    brace-aware scanning — directive args may contain braces (@custom
    http configs, @auth rules), which a `[^}]*` regex body would
    truncate."""
    out = []
    for m in re.finditer(
        r"\b(type|interface|input)\s+(\w+)([^{]*)\{", sdl
    ):
        kind, name, header = m.group(1), m.group(2), m.group(3)
        i = m.end()
        depth = 1
        in_str = None
        start = i
        while i < len(sdl) and depth:
            ch = sdl[i]
            if in_str:
                if in_str == '"""' and sdl.startswith('"""', i):
                    in_str = None
                    i += 3
                    continue
                if in_str == '"' and ch == '"' and sdl[i - 1] != "\\":
                    in_str = None
            elif sdl.startswith('"""', i):
                in_str = '"""'
                i += 3
                continue
            elif ch == '"':
                in_str = '"'
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
            i += 1
        out.append((kind, name, header, sdl[start : i - 1]))
    return out


def parse_sdl(sdl: str) -> Dict[str, GqlType]:
    sdl, auth_blobs = _extract_type_auth(sdl)
    sdl = re.sub(r'"""[\s\S]*?"""', "", sdl)  # strip descriptions
    sdl = re.sub(r"#[^\n]*", "", sdl)
    # type-header @lambdaOnMutate switches (ref gqlschema.go:292)
    lom: Dict[str, Dict[str, bool]] = {}
    for m in re.finditer(r"\btype\s+(\w+)([^{]*)\{", sdl):
        dm = re.search(r"@lambdaOnMutate\s*\(([^)]*)\)", m.group(2))
        if dm:
            lom[m.group(1)] = {
                k: v.strip().lower() == "true"
                for k, v in re.findall(r"(\w+)\s*:\s*(\w+)", dm.group(1))
            }
    sdl = re.sub(r"@lambdaOnMutate\s*\([^)]*\)", "", sdl)
    types: Dict[str, GqlType] = {}
    # enum E { A B C } — values become string storage with hash search
    for m in re.finditer(r"\benum\s+(\w+)\s*\{([^}]*)\}", sdl):
        types[m.group(1)] = GqlType(
            name=m.group(1),
            kind="enum",
            enum_values=re.findall(r"\w+", m.group(2)),
        )
    # union U = A | B | C — a uid edge dispatched by inline fragments
    # members may span lines in leading-pipe style: after the first
    # member, every further member needs its '|', so the scan can't
    # swallow the next definition
    for m in re.finditer(
        r"\bunion\s+(\w+)\s*=\s*\|?\s*(\w+(?:\s*\|\s*\w+)*)", sdl
    ):
        types[m.group(1)] = GqlType(
            name=m.group(1),
            kind="union",
            members=re.findall(r"\w+", m.group(2)),
        )
    for kind, tname, header, body in _scan_bodies(sdl):
        t = GqlType(name=tname, kind=kind)
        im = re.search(r"\bimplements\s+([\w&\s]+)", header)
        if im:
            t.interfaces = re.findall(r"\w+", im.group(1))
        t.lambda_on_mutate = lom.get(tname, {})
        km = re.search(r'@key\s*\(\s*fields:\s*"(\w+)"', header)
        if km:
            t.key_field = km.group(1)
        if re.search(r"@extends\b", header):
            t.is_extended = True
        dm = re.search(r'@dgraph\s*\(\s*type:\s*"([^"]+)"', header)
        if dm:
            # type T @dgraph(type: "stored.name"): the node type name
            # in storage differs from the GraphQL name (ref
            # gqlschema.go dgraph directive on types)
            t.dgraph_name = dm.group(1)
        sm = re.search(r'@secret\s*\(\s*field:\s*"(\w+)"', header)
        if sm:
            # type T @secret(field: "pwd") stores a hashed password
            # predicate and generates checkTPassword (ref
            # gqlschema.go:280 secret directive)
            f = GqlField(
                name=sm.group(1), type_name="String", is_secret=True
            )
            t.fields[f.name] = f
        if tname in auth_blobs:
            from dgraph_tpu_torch.graphql.auth import parse_auth_blob

            t.auth = parse_auth_blob(auth_blobs[tname])
        matches = list(_FIELD_RE.finditer(body))
        if not matches and body.strip():
            raise SDLError(f"cannot parse fields of type {t.name}: {body!r}")
        # ensure nothing between fields went unparsed (newline- or
        # whitespace-separated declarations both allowed in SDL)
        leftover = body
        for fm in matches:
            leftover = leftover.replace(fm.group(0), "", 1)
        if leftover.strip():
            raise SDLError(
                f"cannot parse field(s) {leftover.strip()!r} in type {t.name}"
            )
        for fm in matches:
            f = GqlField(
                name=fm.group("name"),
                type_name=fm.group("type"),
                is_list=bool(fm.group("list")),
                non_null=bool(fm.group("nn") or fm.group("inner_nn")),
            )
            f.is_scalar = fm.group("type") in _SCALARS
            for dm in _DIR_RE.finditer(fm.group("directives") or ""):
                dname, dargs = dm.group(1), dm.group(2) or ""
                if dname == "id":
                    f.is_id = True
                    # @id(interface: true): unique across ALL types
                    # implementing the declaring interface (ref
                    # gqlschema.go idDirective interface arg)
                    if re.search(r"interface\s*:\s*true", dargs):
                        f.id_interface = True
                elif dname == "search":
                    by = re.findall(r"\w+", dargs.split(":", 1)[1]) if ":" in dargs else []
                    f.search = [b.lower() for b in by] or ["__default__"]
                elif dname == "hasInverse":
                    iv = re.search(r"field\s*:\s*\"?(\w+)\"?", dargs)
                    if iv:
                        f.has_inverse = iv.group(1)
                elif dname == "embedding":
                    f.is_embedding = True
                    f.is_scalar = True
                elif dname == "default":
                    # @default(add: {value: "x"}, update: {value: "y"})
                    # (ref gqlschema.go defaultDirective — values are
                    # strings, converted by field type; "$now" = now)
                    am = re.search(
                        r'add\s*:\s*\{\s*value\s*:\s*"([^"]*)"', dargs
                    )
                    um = re.search(
                        r'update\s*:\s*\{\s*value\s*:\s*"([^"]*)"', dargs
                    )
                    if am:
                        f.default_add = am.group(1)
                    if um:
                        f.default_update = um.group(1)
                elif dname == "custom":
                    from dgraph_tpu_torch.graphql.auth import _parse_gql_object

                    f.custom = _parse_gql_object("{" + dargs + "}")
                elif dname == "lambda":
                    # internally @lambda is @custom against the configured
                    # lambda server (ref wrappers.go:699 comment); we keep
                    # the flag and build the POST in resolve.py
                    f.is_lambda = True
                elif dname == "dgraph":
                    pm = re.search(r'pred\s*:\s*"([^"]+)"', dargs)
                    if pm:
                        f.dql_pred = pm.group(1).strip("<>").replace(
                            "~<", "~"
                        )
            t.fields[f.name] = f
        types[t.name] = t
    # an extended type's @external ID key comes from another federation
    # service: it is STORED as an indexed string predicate, not a uid
    # (ref schemagen apollo handling — eq(Astronaut.id, ...) queries)
    for t in types.values():
        if t.is_extended and t.key_field:
            f = t.fields.get(t.key_field)
            if f is not None and f.type_name == "ID":
                f.type_name = "String"
                f.is_scalar = True
                f.is_id = True
    # second pass: enum/union field marking, interface inheritance
    for t in types.values():
        for f in t.fields.values():
            ft = types.get(f.type_name)
            if ft is not None and ft.kind == "enum":
                f.is_enum = True
                f.is_scalar = True
            elif ft is not None and ft.kind == "union":
                f.is_union = True
                f.is_scalar = False
    # @hasInverse pairs are two-way: writing through EITHER side keeps
    # both edges (ref mutation_rewriter.go addInverseLink). Propagate
    # BEFORE interface-field inheritance so implementers inherit the
    # back-pointer, and again after for pairs declared on implementers.
    def _propagate_inverse():
        for t in types.values():
            for f in t.fields.values():
                if not f.has_inverse or f.is_scalar:
                    continue
                ft = types.get(f.type_name)
                if ft is None:
                    continue
                g = ft.fields.get(f.has_inverse)
                if g is not None and not g.has_inverse:
                    g.has_inverse = f.name

    _propagate_inverse()
    for t in types.values():
        if t.kind != "type":
            continue
        for iname in t.interfaces:
            it = types.get(iname)
            if it is None or it.kind != "interface":
                raise SDLError(
                    f"type {t.name} implements unknown interface {iname}"
                )
            it.implementers.append(t.name)
            # inherited fields keep the interface's predicate; the
            # interface's declaration is authoritative even when the
            # implementing type redeclares the field (ref gqlschema.go)
            for f in it.fields.values():
                g = GqlField(**{**f.__dict__, "search": list(f.search)})
                g.owner = iname
                t.fields[f.name] = g
    # @dgraph(type: "stored") types default their unmapped fields to
    # "<stored>.<field>" (ref schemagen.go — the directives e2e data
    # stores myPost.title for `type Post @dgraph(type: "myPost")`)
    for t in types.values():
        for f in t.fields.values():
            if f.dql_pred or f.type_name == "ID":
                continue
            owner = types.get(f.owner) if f.owner else t
            owner = owner or t
            if owner.dgraph_name:
                f.dql_pred = f"{owner.dgraph_name}.{f.name}"
    _propagate_inverse()
    # interface @auth rules apply to implementers too, AND-combined
    # with the type's own rules (ref graphql/schema auth inheritance)
    from dgraph_tpu_torch.graphql.auth import AuthNode, TypeAuth

    for t in types.values():
        if t.kind != "type" or not t.interfaces:
            continue
        for iname in t.interfaces:
            it = types.get(iname)
            if it is None or it.auth is None:
                continue
            if t.auth is None:
                t.auth = TypeAuth()
            for op in ("query", "add", "update", "delete"):
                mine = getattr(t.auth, op)
                theirs = getattr(it.auth, op)
                if theirs is None:
                    continue
                if mine is None:
                    setattr(t.auth, op, theirs)
                else:
                    setattr(
                        t.auth, op,
                        AuthNode(kind="and", children=[theirs, mine]),
                    )
    return types


def to_dql_schema(types: Dict[str, GqlType]) -> str:
    """Generate the internal schema text (ref schemagen.go). Interfaces
    emit their own predicates; implementing types list the inherited
    (interface-owned) predicates in their type definition but do not
    re-emit them."""
    lines: List[str] = []
    # predicates referenced through "~x" reverse mappings need @reverse
    # on their forward declaration
    need_reverse = {
        f.dql_pred[1:]
        for t in types.values()
        for f in t.fields.values()
        if f.dql_pred.startswith("~")
    }
    emitted = set()
    for t in types.values():
        if t.name in ("Query", "Mutation"):
            continue  # virtual roots hold @custom resolvers, not data
        if t.kind in ("enum", "union", "input"):
            continue  # no storage of their own
        tfields = []
        for f in t.fields.values():
            if f.type_name == "ID":
                continue  # internal uid, no predicate
            if f.custom is not None or f.is_lambda:
                continue  # resolved remotely, never stored
            pred = t.pred(f.name)
            if pred.startswith("~"):
                continue  # rides the forward predicate's @reverse
            tfields.append(pred)
            if f.owner and f.owner != t.name:
                continue  # inherited: the interface emits the predicate
            if pred in emitted:
                continue  # @dgraph(pred) shared across types
            emitted.add(pred)
            dtype = f.dql_type
            type_str = f"[{dtype}]" if (f.is_list and not f.is_embedding) else dtype
            directives = []
            if f.is_embedding:
                search = [s for s in f.search if s != "__default__"]
                metric = "euclidean"
                for s in search:
                    if s in ("euclidean", "cosine", "dotproduct"):
                        metric = s
                directives.append(f'@index(hnsw(metric:"{metric}"))')
            elif f.is_id:
                directives.append("@index(hash)")
                directives.append("@upsert")
            elif f.search:
                toks = []
                for s in f.search:
                    if s == "__default__":
                        if f.is_enum:
                            # ref gqlschema.go defaultSearches: enum=hash
                            toks.append("hash")
                        else:
                            toks.extend(_SEARCH_DEFAULT.get(dtype, ["term"]))
                    elif s == "regexp":
                        toks.append("trigram")
                    else:
                        toks.append(s)
                directives.append(f"@index({', '.join(dict.fromkeys(toks))})")
            if not f.is_scalar:
                if f.has_inverse or pred in need_reverse:
                    directives.append("@reverse")
            d = (" " + " ".join(directives)) if directives else ""
            lines.append(f"<{pred}>: {type_str}{d} .")
        fl = "\n  ".join(tfields)
        lines.append(f"type {t.stored_name} {{\n  {fl}\n}}")
    return "\n".join(lines)
