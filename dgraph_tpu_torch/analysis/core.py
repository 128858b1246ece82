"""Shared plumbing for the project-invariant analyzer suite.

The suite is NOT a general-purpose linter: every checker encodes an
invariant this codebase depends on for correctness (lock discipline,
deadline propagation, ctypes ABI fidelity, config-registry routing,
JAX host/device hygiene). A violation is therefore either a real defect
to fix or a deliberate exception — which must be allowlisted with a
written reason (`allowlist.py`). There is no third state.

Vocabulary:

  Violation — (checker, code, path, line, message). `code` names the
    defect class (e.g. "raw-env-read", "lock-order-cycle") so tests and
    allowlist entries can match classes, not message spelling.
  Allow — a deliberate exception: checker + repo-relative path +
    a match string (substring of the message, or exactly the code) +
    a mandatory human reason. One entry may cover several violations
    of the same class in the same file (e.g. three fault-injection
    sleeps in conn/rpc.py).
  Report — partitioned outcome: `violations` (unallowlisted — the
    gate fails on any), `suppressed` ((violation, allow) pairs), and
    `unused_allows` (stale entries; the gate fails on those too, so
    the allowlist can never rot).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Violation:
    checker: str
    code: str
    path: str  # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}/{self.code}] {self.message}"


@dataclass(frozen=True)
class Allow:
    checker: str
    path: str
    match: str  # substring of message, or exactly the violation code
    reason: str

    def covers(self, v: Violation) -> bool:
        return (
            self.checker == v.checker
            and self.path == v.path
            and (self.match == v.code or self.match in v.message)
        )


@dataclass
class Source:
    """One parsed Python file of the scanned tree."""

    path: str  # absolute
    rel: str  # repo-relative posix path (e.g. "conn/rpc.py")
    text: str
    tree: Optional[ast.Module]  # None when the file failed to parse

    _parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parent_map(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            parents: Dict[ast.AST, ast.AST] = {}
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    for child in ast.iter_child_nodes(node):
                        parents[child] = node
            self._parents = parents
        return self._parents


@dataclass
class Report:
    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Tuple[Violation, Allow]] = field(default_factory=list)
    unused_allows: List[Allow] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.unused_allows

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "violations": [v.__dict__ for v in self.violations],
            "suppressed": [
                {**v.__dict__, "reason": a.reason}
                for v, a in self.suppressed
            ],
            "unused_allows": [a.__dict__ for a in self.unused_allows],
        }


Checker = Callable[[List[Source], str], List[Violation]]


def load_sources(root: str, skip_dirs: Sequence[str] = ()) -> List[Source]:
    """Parse every .py file under `root`. A syntax error becomes a
    "parse" violation downstream rather than crashing the suite."""
    out: List[Source] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d not in ("__pycache__",) and d not in skip_dirs
        )
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                tree = ast.parse(text, filename=rel)
            except SyntaxError:
                tree = None
            out.append(Source(path=path, rel=rel, text=text, tree=tree))
    return out


def apply_allowlist(
    found: List[Violation], allows: Sequence[Allow]
) -> Report:
    report = Report()
    used = [False] * len(allows)
    for v in sorted(found, key=lambda v: (v.path, v.line, v.checker)):
        hit = None
        for i, a in enumerate(allows):
            if a.covers(v):
                hit = a
                used[i] = True
                break
        if hit is None:
            report.violations.append(v)
        else:
            report.suppressed.append((v, hit))
    report.unused_allows = [a for i, a in enumerate(allows) if not used[i]]
    return report


# -- small AST helpers shared by checkers -----------------------------------


def module_aliases(tree: ast.Module, module: str) -> set:
    """Names under which `module` (e.g. "os", "time") is importable in
    this file: `import os` -> {"os"}, `import os as _os` -> {"_os"}."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    names.add(a.asname or a.name)
    return names


def imported_names(tree: ast.Module, module: str) -> Dict[str, str]:
    """{local_name: original_name} for `from <module> import ...`."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def sleep_call_matcher(tree: ast.Module):
    """Predicate for `time.sleep(...)` calls under ANY import alias
    (`import time as _t`, `from time import sleep as snooze`) — shared
    by the lock-discipline and deadline-hygiene checkers so alias
    handling cannot drift between them."""
    aliases = module_aliases(tree, "time") | {"time"}
    froms = {
        local
        for local, orig in imported_names(tree, "time").items()
        if orig == "sleep"
    }

    def is_sleep(node: ast.Call) -> bool:
        parts = dotted(node.func).split(".")
        return (
            len(parts) == 2 and parts[0] in aliases and parts[1] == "sleep"
        ) or (len(parts) == 1 and parts[0] in froms)

    return is_sleep


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target, best effort ("os.environ.get")."""
    return dotted(node.func)


def dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""
