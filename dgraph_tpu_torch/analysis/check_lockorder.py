"""lock-order checker: cross-module lock-acquisition graph + cycles.

The lock-discipline checker (check_locks.py) is lexical and
intra-function: it sees `with A: with B:` in one body, so it can only
catch an inversion both of whose halves live in the same file. The
concurrent planes PRs 11-18 added don't deadlock that way — they
deadlock ACROSS modules: the commit lock (worker/groups.py /
worker/harness.py) is held while `GroupCommit.drain()` waits on the
coalescer's queue lock, the tablet mover's registry lock wraps calls
back into engines that take the commit lock, the replica picker's
breaker lock is touched from hedge pools that already hold serving
locks, and so on.

This checker builds ONE global graph:

  node — a lock, identified class-attribute-level
    ("worker/groupcommit.py:GroupCommit._lock") or module-level
    ("worker/applyshard.py:_LOCK"). Conditions canonicalize to their
    underlying lock (check_locks._collect_locks).

  edge A -> B — somewhere in the package, B is acquired while A is
    held. Two edge sources:
      (1) lexical nesting: `with A: ... with B:` in one body;
      (2) call chains: `with A: ... f()` where f (resolved best
          effort, see below) transitively acquires B.

  lock-order-cycle — a strongly connected component of >= 2 locks:
    two threads taking the component's locks along different edges can
    deadlock. Reported once per component with a witness cycle and the
    code location of every edge on it.

Call resolution is static and type-less, so it is deliberately
conservative-but-useful:

  * `self.m()` binds to method m of the lexically enclosing class;
  * bare `f()` binds to a module-level def in the same file;
  * `mod.f()` binds through `from dgraph_tpu_torch.pkg import mod` /
    `import dgraph_tpu_torch.pkg.mod` to that module's top-level f;
  * `obj.m()` on an arbitrary receiver binds ONLY when exactly one
    class in the scanned tree defines m AND that method (transitively)
    acquires a lock AND m is not a generic vocabulary name
    (_AMBIENT_METHODS) — unique-name resolution. Anything ambiguous
    is skipped, never guessed.

A self-edge (A -> A through a call chain) is NOT reported here:
re-acquisition is the lock-discipline checker's domain (RLocks make it
legal) and instance-level aliasing (two instances of one class) cannot
be told apart statically.

`lock_graph(sources)` exposes the raw graph for tests and for the
ARCHITECTURE.md sketch; `check()` is the analyzer entry point.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dgraph_tpu_torch.analysis.core import Source, Violation, dotted
from dgraph_tpu_torch.analysis.check_locks import (
    _collect_locks,
    _ModuleLocks,
    _resolve_lock,
)

NAME = "lock-order"

# method names too generic for unique-name resolution: a call through
# one of these on an unknown receiver is always skipped, even when only
# one class in the tree defines it (dict/list/queue/file objects answer
# them too, and a false edge here manufactures a false deadlock)
_AMBIENT_METHODS = {
    "get", "set", "put", "add", "pop", "clear", "update", "items",
    "keys", "values", "copy", "join", "submit", "result", "acquire",
    "release", "wait", "notify", "notify_all", "flush", "close",
    "open", "read", "write", "send", "recv", "run", "start", "stop",
    "append", "extend", "remove", "discard", "next", "query", "commit",
    "state", "exec", "call", "apply", "render", "encode", "decode",
    "snapshot", "observe", "inc", "info", "health",
}

_MAX_DEPTH = 8  # call-chain propagation bound


@dataclass
class _Fn:
    key: str                      # "rel:Class.name" / "rel:name"
    rel: str
    cls: Optional[str]
    node: ast.AST
    # direct lexical acquisitions: (lock, line)
    acquires: List[Tuple[str, int]] = field(default_factory=list)
    # lexical nesting edges: (outer, inner, line)
    edges: List[Tuple[str, str, int]] = field(default_factory=list)
    # calls made while holding locks: (held tuple, callee expr, line)
    calls: List[Tuple[Tuple[str, ...], ast.Call, int]] = field(
        default_factory=list
    )
    # ALL calls (held or not) — needed so closures propagate through
    # intermediate frames that hold nothing themselves
    all_calls: List[Tuple[Tuple[str, ...], ast.Call, int]] = field(
        default_factory=list
    )


@dataclass
class _FileIndex:
    locks: _ModuleLocks
    # import alias -> repo-relative module path ("worker/groupcommit.py")
    mod_aliases: Dict[str, str]
    # module-level function names -> fn key
    top_fns: Dict[str, str]
    # class name -> {method name -> fn key}
    methods: Dict[str, Dict[str, str]]


def _module_rel(modpath: str) -> Optional[str]:
    """dgraph_tpu_torch.worker.groupcommit -> worker/groupcommit.py"""
    parts = modpath.split(".")
    if parts[0] != "dgraph_tpu_torch" or len(parts) < 2:
        return None
    return "/".join(parts[1:]) + ".py"


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                rel = _module_rel(a.name)
                if rel is not None:
                    # `import dgraph_tpu_torch.worker.remote as rem`
                    out[a.asname or a.name.split(".")[-1]] = rel
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                rel = _module_rel(f"{node.module}.{a.name}")
                if rel is not None:
                    out[a.asname or a.name] = rel
    return out


class _Extractor:
    """Walks every file once: lock defs, function frames, edges."""

    def __init__(self, sources: Sequence[Source]):
        self.fns: Dict[str, _Fn] = {}
        self.files: Dict[str, _FileIndex] = {}
        # method name -> [fn keys] across the whole tree (for
        # unique-name resolution)
        self.by_method: Dict[str, List[str]] = {}
        self.sources = {s.rel: s for s in sources}
        for src in sources:
            if src.tree is not None:
                self._index_file(src)
        for src in sources:
            if src.tree is not None:
                self._walk_file(src)

    # -- pass 1: indexes ----------------------------------------------------

    def _index_file(self, src: Source):
        locks = _collect_locks(src)
        top_fns: Dict[str, str] = {}
        methods: Dict[str, Dict[str, str]] = {}
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                top_fns[node.name] = f"{src.rel}:{node.name}"
            elif isinstance(node, ast.ClassDef):
                tbl: Dict[str, str] = {}
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        key = f"{src.rel}:{node.name}.{sub.name}"
                        tbl[sub.name] = key
                        self.by_method.setdefault(sub.name, []).append(key)
                methods[node.name] = tbl
        self.files[src.rel] = _FileIndex(
            locks=locks,
            mod_aliases=_import_aliases(src.tree),
            top_fns=top_fns,
            methods=methods,
        )

    # -- pass 2: frames -----------------------------------------------------

    def _walk_file(self, src: Source):
        idx = self.files[src.rel]
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_fn(src, idx, node, None, f"{src.rel}:{node.name}")
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._walk_fn(
                            src, idx, sub, node.name,
                            f"{src.rel}:{node.name}.{sub.name}",
                        )

    def _walk_fn(
        self,
        src: Source,
        idx: _FileIndex,
        fn_node: ast.AST,
        cls: Optional[str],
        key: str,
    ):
        fn = _Fn(key=key, rel=src.rel, cls=cls, node=fn_node)
        self.fns[key] = fn
        held: List[str] = []

        def visit(node: ast.AST):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn_node:
                # nested def: its body runs later (often on a thread) —
                # fresh frame, same class context, deterministic key
                nkey = f"{key}.<{node.name}>"
                self._walk_fn(src, idx, node, cls, nkey)
                return
            if isinstance(node, ast.With):
                acquired: List[str] = []
                for item in node.items:
                    lid = _resolve_lock(idx.locks, src, cls, item.context_expr)
                    if lid is not None:
                        fn.acquires.append((lid, node.lineno))
                        for outer in held:
                            if outer != lid:
                                fn.edges.append((outer, lid, node.lineno))
                        held.append(lid)
                        acquired.append(lid)
                for sub in node.body:
                    visit(sub)
                for _ in acquired:
                    held.pop()
                return
            if isinstance(node, ast.Call):
                rec = (tuple(held), node, node.lineno)
                fn.all_calls.append(rec)
                if held:
                    fn.calls.append(rec)
            for sub in ast.iter_child_nodes(node):
                visit(sub)

        for stmt in getattr(fn_node, "body", []):
            visit(stmt)

    # -- call resolution ----------------------------------------------------

    def resolve(self, caller: _Fn, call: ast.Call) -> List[str]:
        idx = self.files[caller.rel]
        f = call.func
        # bare f()
        if isinstance(f, ast.Name):
            key = idx.top_fns.get(f.id)
            if key is None and caller.cls is None and "." not in f.id:
                # nested helper defined in this same frame
                nkey = f"{caller.key}.<{f.id}>"
                if nkey in self.fns:
                    return [nkey]
            return [key] if key else []
        if not isinstance(f, ast.Attribute):
            return []
        attr = f.attr
        base = f.value
        # self.m()
        if isinstance(base, ast.Name) and base.id == "self" \
                and caller.cls is not None:
            key = idx.methods.get(caller.cls, {}).get(attr)
            if key:
                return [key]
            # fall through: an inherited/other-class method — try unique
        # mod.f()
        if isinstance(base, ast.Name) and base.id in idx.mod_aliases:
            target_rel = idx.mod_aliases[base.id]
            tidx = self.files.get(target_rel)
            if tidx:
                key = tidx.top_fns.get(attr)
                if key:
                    return [key]
        # unique-name method resolution (cross-module edges): only when
        # unambiguous, lock-acquiring, and not vocabulary
        if attr in _AMBIENT_METHODS or attr.startswith("__"):
            return []
        cands = self.by_method.get(attr, [])
        if len(cands) == 1:
            return cands
        return []


def _closures(ex: _Extractor) -> Dict[str, Set[str]]:
    """fn key -> set of locks (transitively) acquired by calling it."""
    memo: Dict[str, Set[str]] = {}

    def go(key: str, depth: int, stack: Set[str]) -> Set[str]:
        if key in memo:
            return memo[key]
        if key in stack or depth > _MAX_DEPTH:
            return set()
        fn = ex.fns.get(key)
        if fn is None:
            return set()
        stack.add(key)
        acc: Set[str] = {lid for lid, _ in fn.acquires}
        for _, call, _ in fn.all_calls:
            for callee in ex.resolve(fn, call):
                acc |= go(callee, depth + 1, stack)
        stack.discard(key)
        if depth == 0:
            memo[key] = acc
        return acc

    for key in ex.fns:
        go(key, 0, set())
    return memo


Edge = Tuple[str, str]


def lock_graph(
    sources: Sequence[Source],
) -> Dict[Edge, Tuple[str, int, str]]:
    """{(outer, inner): (path, line, kind)} over the whole tree, where
    kind is "nest" (lexical) or "call:<fn key>" (through a resolved
    call chain)."""
    ex = _Extractor(sources)
    closures = _closures(ex)
    edges: Dict[Edge, Tuple[str, int, str]] = {}
    for fn in ex.fns.values():
        for outer, inner, line in fn.edges:
            edges.setdefault((outer, inner), (fn.rel, line, "nest"))
    for fn in ex.fns.values():
        for held, call, line in fn.calls:
            for callee in ex.resolve(fn, call):
                for inner in closures.get(callee, ()):
                    for outer in held:
                        if outer != inner:
                            edges.setdefault(
                                (outer, inner),
                                (fn.rel, line, f"call:{callee}"),
                            )
    return edges


def _sccs(nodes: Set[str], adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan strongly connected components, iterative, deterministic."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            advanced = False
            succs = sorted(adj.get(v, ()))
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))
    return out


def _witness_cycle(
    comp: List[str], adj: Dict[str, Set[str]]
) -> List[str]:
    """One concrete cycle through the component, for the message."""
    comp_set = set(comp)
    start = comp[0]
    path = [start]
    seen = {start}
    cur = start
    while True:
        nxts = sorted(n for n in adj.get(cur, ()) if n in comp_set)
        nxt = next((n for n in nxts if n == start), None)
        if nxt is not None and len(path) > 1:
            return path
        nxt = next((n for n in nxts if n not in seen), None)
        if nxt is None:
            # fall back: close on any in-component successor
            return path
        path.append(nxt)
        seen.add(nxt)
        cur = nxt


def check(sources: List[Source], root: str) -> List[Violation]:
    edges = lock_graph(sources)
    adj: Dict[str, Set[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        nodes.add(a)
        nodes.add(b)
    out: List[Violation] = []
    for comp in _sccs(nodes, adj):
        cyc = _witness_cycle(comp, adj)
        hops = []
        first_loc: Optional[Tuple[str, int]] = None
        ring = cyc + [cyc[0]]
        for a, b in zip(ring, ring[1:]):
            loc = edges.get((a, b))
            if loc is None:
                continue
            path, line, kind = loc
            if first_loc is None:
                first_loc = (path, line)
            via = "" if kind == "nest" else f" (via {kind[5:]})"
            hops.append(f"{a} -> {b} at {path}:{line}{via}")
        path, line = first_loc or (comp and comp[0].split(":")[0], 1)
        out.append(Violation(
            NAME, "lock-order-cycle", path or "", line or 1,
            "lock acquisition cycle — two threads taking these locks "
            "along different edges can deadlock: " + "; ".join(hops),
        ))
    return sorted(out, key=lambda v: (v.path, v.line))
