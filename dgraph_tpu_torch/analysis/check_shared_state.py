"""shared-state checker: unguarded writes from thread-context functions.

Every Python-level race this repo has shipped (the `begin_txn` lost
update, the GroupCommit `drain()` race, the `_quant_view` snapshot
race) had the same shape: a function that RUNS ON ANOTHER THREAD —
a `threading.Thread(target=...)`, a `pool.submit(...)` callable, a
timer/poll loop — wrote instance or module state that the owning
object also touches, with no lock and no stated ownership story.

This checker makes that shape illegal by default:

  unguarded-shared-write — inside a thread-entry function (or a def
    lexically nested in one, which inherits its thread context), an
    assignment / aug-assignment / subscript-store whose target is
    `self.<attr>` or a module-level name, NOT lexically inside a
    `with <known lock>:` block and NOT annotated.

Thread-entry discovery (same file, lexical):

  * `threading.Thread(target=X, ...)` / `Timer(..., X)`;
  * `<anything>.submit(X, ...)` — executor pool submission;
  * `<anything>.map(X, ...)` where X resolves to a local def;
  * X may be `self.m` (method of the enclosing class), a bare name
    (module-level or nested def), or a lambda (its body is scanned
    in place).

Escape hatch — the ownership annotation, NOT the allowlist: a line
(or the entry function's `def` line) carrying

    # race-ok: <why this write is safe>

suppresses the finding. The annotation must state an ownership
argument (single-writer, monotonic flag, GIL-atomic publish of an
immutable value, ...): bare `# race-ok` without a reason still fails
(code `race-ok-missing-reason`). This keeps the exception next to the
code it excuses, where the next editor will see it.

Known limitations (documented, deliberate): purely lexical — writes
in functions the thread entry CALLS are not attributed to it (the
lock-order checker's call resolution exists for lock edges, where a
false positive is cheap; here it would drown the signal); mutating
METHOD calls (list.append on shared state) are out of scope for the
same reason. The analyzer is a tripwire for the common shape, not a
proof of freedom from races — TSan and the GIL-fuzz harness cover the
dynamic side.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dgraph_tpu_torch.analysis.core import Source, Violation, dotted
from dgraph_tpu_torch.analysis.check_locks import _collect_locks, _resolve_lock

NAME = "shared-state"

_POOL_METHODS = {"submit", "map"}
_THREAD_CTORS = {"Thread", "Timer"}


def _line_has_race_ok(lines: List[str], lineno: int) -> Optional[bool]:
    """None = no annotation; True = annotated with a reason;
    False = bare annotation without a reason.

    Looks at the flagged line itself, then (if it carries no marker)
    at immediately preceding pure-comment lines — the idiomatic spot
    when the statement is too long for a trailing comment.
    """
    if not (1 <= lineno <= len(lines)):
        return None
    got = _race_ok_in(lines[lineno - 1])
    ln = lineno - 1
    while got is None and ln >= 1 and lines[ln - 1].lstrip().startswith("#"):
        got = _race_ok_in(lines[ln - 1])
        ln -= 1
    return got


def _race_ok_in(text: str) -> Optional[bool]:
    i = text.find("# race-ok")
    if i < 0:
        return None
    rest = text[i + len("# race-ok"):].strip()
    if rest.startswith(":"):
        rest = rest[1:].strip()
    return len(rest.split()) >= 2


@dataclass
class _Entry:
    """A function body that runs on another thread."""

    node: ast.AST            # FunctionDef / Lambda
    cls: Optional[str]       # enclosing class, for self.<attr> locks
    reason_line: int         # where it was made a thread entry (for msgs)
    how: str                 # "Thread(target=...)", ".submit(...)", ...


def _local_defs(
    tree: ast.Module,
) -> Tuple[Dict[str, ast.AST], Dict[Tuple[str, str], ast.AST]]:
    """({name: def} for every def at any nesting level,
    {(cls, name): def} for direct class methods)."""
    by_name: Dict[str, ast.AST] = {}
    by_method: Dict[Tuple[str, str], ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    by_method[(node.name, sub.name)] = sub
    return by_name, by_method


def _enclosing_class(src: Source, node: ast.AST) -> Optional[str]:
    parents = src.parent_map()
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur.name
        cur = parents.get(cur)
    return None


def _find_entries(src: Source) -> List[_Entry]:
    by_name, by_method = _local_defs(src.tree)
    entries: List[_Entry] = []
    seen: Set[int] = set()

    def add(target: ast.AST, line: int, how: str, ctx_cls: Optional[str]):
        node: Optional[ast.AST] = None
        cls = ctx_cls
        if isinstance(target, ast.Lambda):
            node = target
        elif isinstance(target, ast.Name):
            node = by_name.get(target.id)
            if node is not None:
                cls = _enclosing_class(src, node)
        elif (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and ctx_cls is not None
        ):
            node = by_method.get((ctx_cls, target.attr))
            cls = ctx_cls
        if node is not None and id(node) not in seen:
            seen.add(id(node))
            entries.append(_Entry(node, cls, line, how))

    for call in ast.walk(src.tree):
        if not isinstance(call, ast.Call):
            continue
        name = dotted(call.func)
        last = name.rsplit(".", 1)[-1]
        ctx_cls = _enclosing_class(src, call)
        if last in _THREAD_CTORS:
            for kw in call.keywords:
                if kw.arg == "target":
                    add(kw.value, call.lineno, f"{last}(target=...)", ctx_cls)
            # Timer(interval, fn)
            if last == "Timer" and len(call.args) >= 2:
                add(call.args[1], call.lineno, "Timer(...)", ctx_cls)
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _POOL_METHODS
            and call.args
        ):
            add(
                call.args[0], call.lineno,
                f".{call.func.attr}(...)", ctx_cls,
            )
            # submit(copy_context().run, real_fn, ...) — the context
            # wrapper forwards; the second arg is the actual entry
            first = call.args[0]
            if (
                isinstance(first, ast.Attribute)
                and first.attr == "run"
                and len(call.args) >= 2
            ):
                add(
                    call.args[1], call.lineno,
                    f".{call.func.attr}(ctx.run, ...)", ctx_cls,
                )
    return entries


def _module_level_names(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                out.add(node.target.id)
    return out


def _target_desc(
    t: ast.AST, module_names: Set[str], local_names: Set[str]
) -> Optional[str]:
    """Shared-state description for a store target, or None if local."""
    # self.attr  /  self.attr[...]
    node = t
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        suffix = "[...]" if isinstance(t, ast.Subscript) else ""
        return f"self.{node.attr}{suffix}"
    # bare module-level name (global or container slot)
    if isinstance(t, ast.Name):
        # plain `x = ...` rebinding without `global` is a local; the
        # `global` case is handled by the caller adding to local_names
        return None
    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
        nm = t.value.id
        if nm not in local_names and nm in module_names:
            return f"{nm}[...]"
    return None


def check(sources: List[Source], root: str) -> List[Violation]:
    out: List[Violation] = []
    for src in sources:
        if src.tree is None:
            continue
        locks = _collect_locks(src)
        module_names = _module_level_names(src.tree)
        lines = src.text.splitlines()
        for entry in _find_entries(src):
            _scan_entry(src, locks, module_names, lines, entry, out)
    # a def that is both a thread entry itself and nested inside one is
    # scanned twice — report each (path, line, code) once
    uniq: Dict[Tuple[str, int, str], Violation] = {}
    for v in out:
        uniq.setdefault((v.path, v.line, v.code), v)
    return sorted(
        uniq.values(), key=lambda v: (v.path, v.line, v.message)
    )


def _scan_entry(
    src: Source,
    locks,
    module_names: Set[str],
    lines: List[str],
    entry: _Entry,
    out: List[Violation],
):
    fn = entry.node
    def_line = getattr(fn, "lineno", entry.reason_line)
    fn_ok = _line_has_race_ok(lines, def_line)
    if fn_ok is True:
        return
    fn_name = getattr(fn, "name", "<lambda>")

    # locals: params + names assigned at any depth without `global`
    local_names: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (
            list(args.posonlyargs) + list(args.args)
            + list(args.kwonlyargs)
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        ):
            local_names.add(a.arg)
    globals_declared: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            globals_declared.update(node.names)
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            a = node.args
            for p in (
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])
            ):
                local_names.add(p.arg)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    local_names.add(t.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node.target, ast.Name):
                local_names.add(node.target.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            tgt = node.target
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    local_names.add(n.id)
    local_names -= globals_declared

    held: List[str] = []

    def flag(t: ast.AST, lineno: int):
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                flag(el, lineno)
            return
        if isinstance(t, ast.Starred):
            flag(t.value, lineno)
            return
        desc = _target_desc(t, module_names, local_names)
        if desc is None and isinstance(t, ast.Name) \
                and t.id in globals_declared:
            desc = t.id
        if desc is None:
            return
        ann = _line_has_race_ok(lines, lineno)
        if ann is True:
            return
        if ann is False or fn_ok is False:
            out.append(Violation(
                NAME, "race-ok-missing-reason", src.rel, lineno,
                f"`# race-ok` on the {desc} write needs a stated "
                f"ownership reason (single-writer, monotonic, ...)",
            ))
            return
        out.append(Violation(
            NAME, "unguarded-shared-write", src.rel, lineno,
            f"{desc} written in {fn_name}() — which runs on another "
            f"thread ({entry.how} at line {entry.reason_line}) — "
            f"without a lock held; guard it or annotate the line "
            f"with `# race-ok: <ownership reason>`",
        ))

    def visit(node: ast.AST):
        if isinstance(node, ast.With):
            acquired: List[str] = []
            for item in node.items:
                lid = _resolve_lock(locks, src, entry.cls, item.context_expr)
                if lid is not None:
                    held.append(lid)
                    acquired.append(lid)
            for sub in node.body:
                visit(sub)
            for _ in acquired:
                held.pop()
            return
        if not held:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    flag(t, node.lineno)
            elif isinstance(node, ast.AugAssign):
                flag(node.target, node.lineno)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                flag(node.target, node.lineno)
        for sub in ast.iter_child_nodes(node):
            visit(sub)

    body = getattr(fn, "body", None)
    if isinstance(body, list):
        for stmt in body:
            visit(stmt)
    elif body is not None:  # lambda
        visit(body)
