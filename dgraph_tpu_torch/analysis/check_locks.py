"""lock-discipline checker: blocking work under locks + ordering cycles.

Locks are discovered, not configured: any `threading.Lock() / RLock() /
Condition()` bound to a module-level name or to `self.<attr>` in a class
body is tracked. A `Condition(self._lock)` is canonicalized to its
underlying lock, so `with self._cv:` counts as acquiring `self._lock`.

Defect classes:

  blocking-under-lock — a call from the blocking vocabulary
    (time.sleep, socket connect/accept/recv/sendall/makefile,
    subprocess run/check_*/Popen, future .result(), thread .join())
    made lexically inside a `with <lock>:` body. A blocked holder
    stalls every reader of that lock — on the MemoryLayer or METRICS
    locks that is a whole-process stall.

  native-call-under-lock — a function imported from dgraph_tpu_torch.native
    called while a lock is held. Native decodes run milliseconds on
    big packs; the level-batched read path deliberately decodes
    OUTSIDE the MemoryLayer lock and only publishes under it.

  cv-wait-under-other-lock — Condition.wait(_for) releases ITS OWN
    lock while sleeping, but any OTHER lock held at that point stays
    held for the full wait: deadlock risk.

  lock-order-cycle — lock A is taken inside B somewhere and B inside
    A somewhere else. Reported once per unordered pair, with both
    locations.

Analysis is lexical and intra-function: locks passed across call
boundaries are out of scope here — check_lockorder.py builds the
cross-module acquisition graph (call-chain resolution included) and
catches the inversions whose halves live in different files; this
checker's lock-order-cycle stays as the fast intra-file form.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from dgraph_tpu_torch.analysis.core import (
    Source,
    Violation,
    dotted,
    module_aliases,
    sleep_call_matcher,
)

NAME = "lock-discipline"

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

_BLOCKING_METHODS = {
    "connect", "connect_ex", "accept", "recv", "recv_into", "recvfrom",
    "makefile", "create_connection", "getaddrinfo",
    "result", "join",
}
_SUBPROCESS_FNS = {"run", "check_call", "check_output", "call", "Popen"}


def _is_lock_ctor(node: ast.AST, th_aliases: set) -> Optional[ast.Call]:
    """The Call node when `node` is threading.Lock()/RLock()/Condition()
    under any alias of the threading module (or a bare from-import)."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted(node.func)
    last = name.rsplit(".", 1)[-1]
    if last in _LOCK_CTORS and (
        "." not in name or name.split(".", 1)[0] in th_aliases
    ):
        return node
    return None


@dataclass
class _ModuleLocks:
    # lock identity -> canonical identity (Conditions alias their lock)
    canonical: Dict[str, str]
    module_names: Set[str]  # module-level lock variable names
    class_attrs: Dict[str, Set[str]]  # class name -> {self attrs}


def _collect_locks(src: Source) -> _ModuleLocks:
    canonical: Dict[str, str] = {}
    module_names: Set[str] = set()
    class_attrs: Dict[str, Set[str]] = {}
    th_aliases = (
        module_aliases(src.tree, "threading") | {"threading"}
        if src.tree is not None
        else {"threading"}
    )

    def lock_id(cls: Optional[str], attr: str) -> str:
        return f"{src.rel}:{cls + '.' if cls else ''}{attr}"

    def record(cls: Optional[str], attr: str, ctor: ast.Call):
        lid = lock_id(cls, attr)
        target = lid
        # Condition(self._lock) aliases the underlying lock
        fname = dotted(ctor.func).rsplit(".", 1)[-1]
        if fname == "Condition" and ctor.args:
            arg = ctor.args[0]
            if (
                isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "self"
            ):
                target = lock_id(cls, arg.attr)
            elif isinstance(arg, ast.Name):
                target = lock_id(None, arg.id)
        canonical[lid] = target
        if cls is None:
            module_names.add(attr)
        else:
            class_attrs.setdefault(cls, set()).add(attr)

    if src.tree is None:
        return _ModuleLocks(canonical, module_names, class_attrs)

    for node in src.tree.body:  # module-level assigns
        if isinstance(node, ast.Assign) and \
                _is_lock_ctor(node.value, th_aliases):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    record(None, t.id, node.value)

    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and \
                    _is_lock_ctor(sub.value, th_aliases):
                for t in sub.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        record(node.name, t.attr, sub.value)
    return _ModuleLocks(canonical, module_names, class_attrs)


def _resolve_lock(
    locks: _ModuleLocks, src: Source, cls: Optional[str], expr: ast.AST
) -> Optional[str]:
    """Canonical lock id for a with-item context expr, or None."""
    lid = None
    if isinstance(expr, ast.Name) and expr.id in locks.module_names:
        lid = f"{src.rel}:{expr.id}"
    elif (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
        and cls is not None
        and expr.attr in locks.class_attrs.get(cls, ())
    ):
        lid = f"{src.rel}:{cls}.{expr.attr}"
    if lid is None:
        return None
    return locks.canonical.get(lid, lid)


def _native_imports(src: Source) -> Set[str]:
    """Local names bound to dgraph_tpu_torch.native functions or the module."""
    names: Set[str] = set()
    if src.tree is None:
        return names
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "dgraph_tpu_torch.native":
                for a in node.names:
                    names.add(a.asname or a.name)
            elif node.module == "dgraph_tpu_torch" and any(
                a.name == "native" for a in node.names
            ):
                for a in node.names:
                    if a.name == "native":
                        names.add(a.asname or "native")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "dgraph_tpu_torch.native":
                    names.add((a.asname or "dgraph_tpu_torch.native").split(".")[0])
    return names


def _receiver(node: ast.Call) -> Optional[ast.AST]:
    if isinstance(node.func, ast.Attribute):
        return node.func.value
    return None


def _is_str_join(node: ast.Call) -> bool:
    recv = _receiver(node)
    if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
        return True
    name = dotted(recv) if recv is not None else ""
    return "path" in name.split(".")  # os.path.join and friends


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    # (outer, inner) -> first location
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    for src in sources:
        if src.tree is None:
            continue
        locks = _collect_locks(src)
        native_names = _native_imports(src)
        is_sleep_call = sleep_call_matcher(src.tree)

        def walk_fn(fn: ast.AST, cls: Optional[str]):
            held: List[str] = []

            def visit(node: ast.AST):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node is not fn:
                    walk_fn(node, cls)  # nested defs start a fresh frame
                    return
                if isinstance(node, ast.With):
                    acquired: List[str] = []
                    for item in node.items:
                        lid = _resolve_lock(
                            locks, src, cls, item.context_expr
                        )
                        if lid is not None:
                            for outer in held:
                                if outer != lid:
                                    edges.setdefault(
                                        (outer, lid),
                                        (src.rel, node.lineno),
                                    )
                            held.append(lid)
                            acquired.append(lid)
                    for sub in node.body:
                        visit(sub)
                    for _ in acquired:
                        held.pop()
                    return
                if isinstance(node, ast.Call) and held:
                    _flag_call(node)
                for sub in ast.iter_child_nodes(node):
                    visit(sub)

            def _flag_call(node: ast.Call):
                name = dotted(node.func)
                parts = name.split(".")
                innermost = held[-1]
                # time.sleep under any lock
                if is_sleep_call(node):
                    out.append(Violation(
                        NAME, "blocking-under-lock", src.rel, node.lineno,
                        f"time.sleep while holding {', '.join(held)}",
                    ))
                    return
                if len(parts) == 2 and parts[0] in (
                    "subprocess", "_subprocess"
                ) and parts[1] in _SUBPROCESS_FNS:
                    out.append(Violation(
                        NAME, "blocking-under-lock", src.rel, node.lineno,
                        f"subprocess.{parts[1]} while holding "
                        f"{', '.join(held)}",
                    ))
                    return
                # condition wait: fine on the innermost held lock (it
                # releases it), deadlock risk when other locks are held
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in ("wait", "wait_for"):
                    recv_lock = _resolve_lock(
                        locks, src, cls, node.func.value
                    )
                    if recv_lock is not None:
                        others = [h for h in held if h != recv_lock]
                        if others:
                            out.append(Violation(
                                NAME, "cv-wait-under-other-lock",
                                src.rel, node.lineno,
                                f"{node.func.attr}() on {recv_lock} while "
                                f"ALSO holding {', '.join(others)} — those "
                                f"stay held for the full wait",
                            ))
                        return
                    # wait on an unknown receiver: treat as blocking
                    out.append(Violation(
                        NAME, "blocking-under-lock", src.rel, node.lineno,
                        f".{node.func.attr}() while holding "
                        f"{', '.join(held)}",
                    ))
                    return
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _BLOCKING_METHODS:
                    if node.func.attr == "join" and _is_str_join(node):
                        return
                    out.append(Violation(
                        NAME, "blocking-under-lock", src.rel, node.lineno,
                        f".{node.func.attr}() while holding "
                        f"{', '.join(held)}",
                    ))
                    return
                if parts and parts[0] in native_names:
                    out.append(Violation(
                        NAME, "native-call-under-lock", src.rel,
                        node.lineno,
                        f"native call {name}() while holding {innermost} "
                        f"— decode outside the lock, publish under it",
                    ))

            body = getattr(fn, "body", [])
            for stmt in body:
                visit(stmt)

        # only top-level functions and direct class methods seed frames;
        # nested defs are reached through visit() so they aren't walked
        # twice with the wrong class context
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fn(node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        walk_fn(sub, node.name)

    # ordering cycles: A->B and B->A both observed
    seen_pairs = set()
    for (a, b), (path, line) in sorted(edges.items()):
        if (b, a) in edges and frozenset((a, b)) not in seen_pairs:
            seen_pairs.add(frozenset((a, b)))
            p2, l2 = edges[(b, a)]
            out.append(Violation(
                NAME, "lock-order-cycle", path, line,
                f"inconsistent lock order: {a} -> {b} here but "
                f"{b} -> {a} at {p2}:{l2}",
            ))
    return out
